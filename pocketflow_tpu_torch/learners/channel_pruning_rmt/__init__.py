"""Channel pruning, "remastered" (counterpart of
pocketflow_tpu/learners/channel_pruning_rmt): meta-LASSO selection and an
Adam least-squares reconstruction."""
