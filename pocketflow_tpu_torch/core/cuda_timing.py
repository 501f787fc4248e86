"""The card's name and power limit, device time by CUDA events, and the
least time the card could take for a piece of work: the helpers every timed
run of the port prints and measures with."""

import subprocess
from typing import Dict, Tuple

import torch

# NVIDIA's H100 SXM data sheet, at its 700 W limit: memory bytes/s, and dense
# bf16 tensor-core and fp32 (outside the tensor cores) operations/s
HBM_BYTES_S, BF16_TENSOR_OPS_S, FP32_OPS_S = 3.35e12, 989e12, 67e12
INT8_TENSOR_OPS_S = 1979e12  # dense int8 tensor-core operations/s, the same sheet


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() over `reps` back-to-back calls, by CUDA
    events, after one call and a synchronize."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nb_bytes: float, ops_by_rate: Dict[float, float]) -> Tuple[float, str]:
    """(ms, 'bytes' or 'operations'): the least time for work that moves
    nb_bytes (each input read once, each output written once) and does
    ops_by_rate {peak rate: operations at that rate}: the larger of the
    bytes over the memory's rate and the operations over their peak rates."""
    bytes_ms = 1e3 * nb_bytes / HBM_BYTES_S
    ops_ms = 1e3 * sum(count / rate for rate, count in ops_by_rate.items())
    return (bytes_ms, 'bytes') if bytes_ms >= ops_ms else (ops_ms, 'operations')


def matmul_bound_ms(m: int, k: int, n: int) -> Tuple[float, str]:
    """bound_ms of y = bf16(x @ w), x [m, k], w [k, n] and y bf16: 2 m k n
    bf16 tensor-core operations."""
    return bound_ms(2 * (m * k + k * n + m * n), {BF16_TENSOR_OPS_S: 2 * m * k * n})


def int8_conv_bound_ms(x_bytes: int, codes_bytes: int, y_bytes: int, m: int, n: int,
                       k: int) -> Tuple[float, str]:
    """bound_ms of one int8 serving site: its input read once in its dtype,
    the codes read once, its output written once, and 2 m n k int8
    tensor-core operations (m output positions, n output channels, k =
    kh kw c_in)."""
    return bound_ms(x_bytes + codes_bytes + y_bytes, {INT8_TENSOR_OPS_S: 2 * m * n * k})
