"""Fashion-MNIST dataset (counterpart of pocketflow_tpu/datasets/fmnist.py).

Reads the idx-format gz files (``{train,t10k}-{images-idx3,labels-idx1}-ubyte.gz``)
into memory, or synthesizes data when they are absent; the augment scales
to [0, 1] on the device.
"""

from __future__ import annotations

import gzip
import os
from typing import Tuple

import numpy as np
import torch

from pocketflow_tpu_torch.datasets.abstract import AbstractDataset, DatasetSpec, resolve_data_dir


def load_idx_images(path: str) -> np.ndarray:
    """uint8 [n, rows, cols, 1] of an idx3 gz file."""
    with gzip.open(path, 'rb') as fin:
        data = fin.read()
    n = int.from_bytes(data[4:8], 'big')
    rows = int.from_bytes(data[8:12], 'big')
    cols = int.from_bytes(data[12:16], 'big')
    return np.frombuffer(data, np.uint8, offset=16).reshape(n, rows, cols, 1)


def load_idx_labels(path: str) -> np.ndarray:
    """int32 [n] of an idx1 gz file."""
    with gzip.open(path, 'rb') as fin:
        data = fin.read()
    return np.frombuffer(data, np.uint8, offset=8).astype(np.int32)


class FMnistDataset(AbstractDataset):
    SPEC = DatasetSpec(
        name='fmnist', nb_classes=10,
        nb_smpls_train=60000, nb_smpls_val=5000, nb_smpls_eval=10000,
        batch_size=128, batch_size_eval=100, image_shape=(28, 28, 1))

    def _load_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        data_dir = resolve_data_dir()
        prefix = 'train' if self.is_train else 't10k'
        if data_dir:
            img_path = os.path.join(data_dir, '%s-images-idx3-ubyte.gz' % prefix)
            lbl_path = os.path.join(data_dir, '%s-labels-idx1-ubyte.gz' % prefix)
            if os.path.exists(img_path) and os.path.exists(lbl_path):
                return load_idx_images(img_path), load_idx_labels(lbl_path)
        return self.synthesize_arrays()

    def augment(self, images, generator, is_train):
        del generator, is_train
        return images.to(torch.float32) / 255.0
