"""ILSVRC-12 (ImageNet) dataset (counterpart of pocketflow_tpu/datasets/ilsvrc12.py).

Train preproc = random-area crop + resize + flip (the JAX package's default
'inception' augment; its --ilsvrc_augment=mild is not ported); eval = 87.5%
center crop; both on the device.  This port synthesizes its data; the `.npy`
shards of the JAX package's converter are not read yet.
"""

from __future__ import annotations

import glob
import os
from dataclasses import replace
from typing import Tuple

import numpy as np

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.datasets import augment
from pocketflow_tpu_torch.datasets.abstract import AbstractDataset, DatasetSpec

IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)

FLAGS.DEFINE_integer(
    'ilsvrc_image_size', None,
    'override the 224x224 ILSVRC input resolution (synthetic runs only)')


class Ilsvrc12Dataset(AbstractDataset):
    # nb_classes = 1001 (class 0 = background) matching the reference
    SPEC = DatasetSpec(
        name='ilsvrc_12', nb_classes=1001,
        nb_smpls_train=1281167, nb_smpls_val=10000, nb_smpls_eval=50000,
        batch_size=64, batch_size_eval=100, image_shape=(224, 224, 3))

    def __init__(self, is_train: bool):
        super().__init__(is_train)
        size = FLAGS.get('ilsvrc_image_size')
        if size:
            self.spec = replace(self.spec, image_shape=(int(size), int(size), 3))

    def _load_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        data_dir = FLAGS.get('data_dir_local')
        if data_dir and glob.glob(os.path.join(data_dir, '*_images_*.npy')):
            raise NotImplementedError(
                'reading ILSVRC-12 shards is not ported yet (ROADMAP '
                "'Modules to port', real-data shards); run with --synthetic_data")
        return self.synthesize_arrays(nb_smpls=2048)

    def augment(self, images, generator, is_train):
        out_hw = self.spec.image_shape[:2]
        if is_train:
            if images.shape[1:3] != tuple(out_hw):
                images = augment.random_crop_resize(images, generator, out_hw)
            images = augment.random_flip_lr(images, generator)
        elif images.shape[1:3] != tuple(out_hw):
            images = augment.center_crop_resize(images, out_hw)
        return augment.normalize(images, IMAGENET_MEAN, IMAGENET_STD)
