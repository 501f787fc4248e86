"""NCHW <-> NHWC checkpoint conversion (a copy of
pocketflow_tpu/tools/convert_data_format.py).

The packages keep conv kernels in HWIO and flatten features in (H, W, C)
order; this tool imports channels-first checkpoints (e.g. torchvision-style
models) by transposing conv kernels and re-ordering the first dense layer
after a flatten.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np


def nchw_kernel_to_nhwc(kernel: np.ndarray) -> np.ndarray:
    """[O, I, H, W] (torch) -> [H, W, I, O] (HWIO, ours)."""
    assert kernel.ndim == 4
    return np.transpose(kernel, (2, 3, 1, 0))


def nhwc_kernel_to_nchw(kernel: np.ndarray) -> np.ndarray:
    """[H, W, I, O] -> [O, I, H, W]."""
    assert kernel.ndim == 4
    return np.transpose(kernel, (3, 2, 0, 1))


def flatten_dense_nchw_to_nhwc(kernel: np.ndarray,
                               feature_shape: Tuple[int, int, int]) -> np.ndarray:
    """Fix the first dense layer after a flatten: its input ordering changes
    from (C, H, W) to (H, W, C).  `feature_shape` is the pre-flatten (H, W, C).
    Kernel is [in_features, out_features]."""
    h, w, c = feature_shape
    assert kernel.shape[0] == h * w * c
    k = kernel.reshape(c, h, w, -1)          # NCHW flatten order
    k = np.transpose(k, (1, 2, 0, 3))        # -> NHWC flatten order
    return k.reshape(h * w * c, -1)


def convert_tree(params: Dict[str, Any], to_nhwc: bool = True) -> Dict[str, Any]:
    """Recursively convert all 4-d 'kernel' leaves in a nested params dict."""
    out = {}
    for key, value in params.items():
        if isinstance(value, dict):
            out[key] = convert_tree(value, to_nhwc)
        elif key == 'kernel' and np.ndim(value) == 4:
            out[key] = (nchw_kernel_to_nhwc if to_nhwc
                        else nhwc_kernel_to_nchw)(np.asarray(value))
        else:
            out[key] = value
    return out
