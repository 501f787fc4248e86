"""ILSVRC-12 (ImageNet) dataset (counterpart of pocketflow_tpu/datasets/ilsvrc12.py).

Reads the ``{train,val}_{images,labels}_*.npy`` shards of the JAX package's
converter through a ``ShardedView`` (rows stream out of the shard files, one
batch at a time), or synthesizes data when there are none.  Train preproc =
random-area crop + resize + flip (``--ilsvrc_augment=inception``, the
default) or center crop + flip (``mild``); eval = 87.5% center crop; all on
the device.
"""

from __future__ import annotations

import glob
import os
from dataclasses import replace
from typing import Tuple

import numpy as np

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.datasets import augment
from pocketflow_tpu_torch.datasets.abstract import AbstractDataset, DatasetSpec, resolve_data_dir
from pocketflow_tpu_torch.datasets.shards import ShardedView

IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)

FLAGS.DEFINE_integer(
    'ilsvrc_image_size', None,
    'override the 224x224 ILSVRC input resolution (synthetic runs only)')
FLAGS.DEFINE_string(
    'ilsvrc_augment', 'inception',
    "train-time preprocessing: 'inception' = distorted area/aspect crops; "
    "'mild' = center crop + horizontal flip only")


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
        data_dir = resolve_data_dir()
        subset = 'train' if self.is_train else 'val'
        if data_dir and os.path.isdir(data_dir):
            img_shards = sorted(glob.glob(os.path.join(data_dir, '%s_images_*.npy' % subset)))
            lbl_shards = sorted(glob.glob(os.path.join(data_dir, '%s_labels_*.npy' % subset)))
            if glob.glob(os.path.join(data_dir, '%s_extents_*.npy' % subset)):
                raise NotImplementedError(
                    "full-frame ILSVRC-12 shards (with '_extents_') need the valid-extent "
                    "crops, not ported yet (ROADMAP 'Modules to port', item 25)")
            if img_shards:
                images = ShardedView.from_npy_files(img_shards)
                labels = np.concatenate([np.load(p) for p in lbl_shards]).astype(np.int32)
                if len(labels) != len(images):
                    raise ValueError('ILSVRC-12 shard mismatch: %d images vs %d labels'
                                     % (len(images), len(labels)))
                return images, labels
        return self.synthesize_arrays(nb_smpls=2048)

    def augment(self, images, generator, is_train):
        out_hw = tuple(self.spec.image_shape[:2])
        if is_train:
            if images.shape[1:3] != out_hw:
                if FLAGS.get('ilsvrc_augment') == 'mild':
                    images = augment.center_crop_resize(images, out_hw)
                else:
                    images = augment.random_crop_resize(images, generator, out_hw)
            images = augment.random_flip_lr(images, generator)
        elif images.shape[1:3] != out_hw:
            images = augment.center_crop_resize(images, out_hw)
        return augment.normalize(images, IMAGENET_MEAN, IMAGENET_STD)
