"""Discrimination-aware channel pruning (counterpart of
pocketflow_tpu/learners/discr_channel_pruning)."""
