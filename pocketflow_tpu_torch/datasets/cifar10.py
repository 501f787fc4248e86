"""CIFAR-10 dataset (counterpart of pocketflow_tpu/datasets/cifar10.py).

Reads the fixed-length records of ``data_batch_*.bin`` / ``test_batch.bin``
(1 label byte + 3x32x32 uint8 in CHW order) once on the host into NHWC
arrays, or synthesizes data when there are none.  Mean/std normalization,
the pad-4 random crop and the flip run on the device.
"""

from __future__ import annotations

import glob
import os
from typing import Sequence, Tuple

import numpy as np

from pocketflow_tpu_torch.datasets import augment
from pocketflow_tpu_torch.datasets.abstract import AbstractDataset, DatasetSpec, resolve_data_dir

CIFAR10_MEAN = (125.3, 123.0, 113.9)
CIFAR10_STD = (63.0, 62.1, 66.7)

_RECORD_BYTES = 1 + 32 * 32 * 3


def parse_bin_files(paths: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """(images uint8 [n, 32, 32, 3], labels int32 [n]) of CIFAR-10 .bin files."""
    raw = np.concatenate([np.fromfile(path, np.uint8) for path in paths])
    recs = raw.reshape(-1, _RECORD_BYTES)
    labels = recs[:, 0].astype(np.int32)
    images = recs[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(images), labels


class Cifar10Dataset(AbstractDataset):
    SPEC = DatasetSpec(
        name='cifar_10', nb_classes=10,
        nb_smpls_train=50000, nb_smpls_val=5000, nb_smpls_eval=10000,
        batch_size=128, batch_size_eval=100, image_shape=(32, 32, 3))

    def _load_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        data_dir = resolve_data_dir()
        if data_dir and os.path.isdir(data_dir):
            pattern = 'data_batch_*.bin' if self.is_train else 'test_batch.bin'
            paths = sorted(glob.glob(os.path.join(data_dir, '**', pattern), recursive=True))
            if paths:
                return parse_bin_files(paths)
        return self.synthesize_arrays()

    def augment(self, images, generator, is_train):
        images = augment.normalize(images, CIFAR10_MEAN, CIFAR10_STD)
        if is_train:
            images = augment.pad_random_crop(images, generator, pad=4)
            images = augment.random_flip_lr(images, generator)
        return images
