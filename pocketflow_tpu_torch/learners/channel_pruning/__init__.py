"""Channel pruning (counterpart of pocketflow_tpu/learners/channel_pruning): the
LASSO pruner (channel_pruner.py) and the learner with the AMC search (learner.py)."""
