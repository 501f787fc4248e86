"""The yardstick's peaks and bounds, frozen here so that a change to the
program cannot move them.  Copied from the port's
``pocketflow_tpu_torch/core/cuda_timing.py`` (``bound_ms``,
``int8_conv_bound_ms`` and the H100 peaks); do not edit.

NVIDIA's H100 SXM data sheet at its 700 W limit, dense rates without
sparsity: memory bytes/s, bf16 tensor-core operations/s, int8 tensor-core
operations/s."""

from typing import Dict, Tuple

HBM_BYTES_S = 3.35e12
BF16_TENSOR_OPS_S = 989e12
INT8_TENSOR_OPS_S = 1979e12


def bound_ms(nb_bytes: float, ops_by_rate: Dict[float, float]) -> Tuple[float, str]:
    """(ms, 'bytes' or 'operations'): the least time for work that moves
    nb_bytes (each input read once, each output written once) and does
    ops_by_rate {peak rate: operations at that rate}."""
    bytes_ms = 1e3 * nb_bytes / HBM_BYTES_S
    ops_ms = 1e3 * sum(count / rate for rate, count in ops_by_rate.items())
    return (bytes_ms, 'bytes') if bytes_ms >= ops_ms else (ops_ms, 'operations')


def int8_conv_bound_ms(x_bytes: int, codes_bytes: int, y_bytes: int, m: int, n: int,
                       k: int) -> Tuple[float, str]:
    """bound_ms of one int8 serving site: its input read once in its dtype,
    the codes read once, its output written once, and 2 m n k int8
    tensor-core operations (m output positions, n output channels, k =
    kh kw c_in)."""
    return bound_ms(x_bytes + codes_bytes + y_bytes, {INT8_TENSOR_OPS_S: 2 * m * n * k})
