"""Weight sparsification (counterpart of pocketflow_tpu/learners/weight_sparsification):
the masks and the pruning-ratio schedule; the learner and its ratio optimizer
are not ported yet (ROADMAP 'Modules to port', item 14)."""
