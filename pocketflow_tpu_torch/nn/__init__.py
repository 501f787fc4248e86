"""NN building blocks with compression interception points."""

from pocketflow_tpu_torch.nn.layers import (  # noqa: F401
    CompressionPolicy, compression, current_policy,
    PFConv, PFDense, BatchNorm, max_pool, global_avg_pool,
    relu, relu6, set_paths,
)
