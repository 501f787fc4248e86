"""Channel pruning by proximal gradient descent with a group LASSO
(counterpart of pocketflow_tpu/learners/channel_pruning_gpu)."""
