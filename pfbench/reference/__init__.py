"""Plain PyTorch references of the benchmark's cells, written from the
published descriptions and the learners' formulas: float32 with TF32 off,
no kernels, no batching tricks.  Nothing here imports the port, the JAX
package or JAX; the weights, batches and augmentation seeds are handed over
by the harness, and everything the program derives from them (quantized
weights, calibration scales, codes, optimizer state, activation ranges) is
worked out here again."""

import torch


def exact_float32():
    """Turn TF32 off for the reference's products (float32 as stated)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
