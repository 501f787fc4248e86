"""Weight sparsification (counterpart of pocketflow_tpu/learners/weight_sparsification):
the masks and the pruning-ratio schedule (masking.py), the per-layer ratios
(pr_optimizer.py) and the learner (learner.py)."""
