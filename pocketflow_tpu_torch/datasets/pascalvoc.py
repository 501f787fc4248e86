"""Pascal VOC detection dataset (counterpart of pocketflow_tpu/datasets/pascalvoc.py).

Labels are a fixed [nb_bboxs_max, 6] float32 array per image:

    [class_id, ymin, xmin, ymax, xmax, valid]     (coords normalized to [0,1])

with valid 1.0 (a ground truth), 0.0 (padding) or -1.0 ('difficult': never
matched in training, ignored by the mAP evaluator).

Real data: a directory (``--data_dir_local``) of ``train*.npz`` / ``val*.npz``
shards holding 'images' (uint8 NHWC), 'boxes' (a list of [n_i, 5] arrays) and
optionally 'difficult'.  Without them: class-textured rectangles on a noise
background, the same numpy draws as the JAX package, so the arrays are
byte-equal.  The train augmentation (flip with mirrored boxes, brightness and
contrast jitter, clip) and the VGG mean-subtract run on the device.
"""

from __future__ import annotations

import glob
import os
from dataclasses import replace
from typing import Optional, Tuple

import numpy as np
import torch

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.datasets.abstract import AbstractDataset, DatasetSpec
from pocketflow_tpu_torch.datasets.remote_fs import resolve_data_dir
from pocketflow_tpu_torch.datasets.augment import _draw

FLAGS.DEFINE_integer('nb_bboxs_max', 32, 'max # of bounding boxes per image')
FLAGS.DEFINE_integer('voc_image_size', None,
                     'override Pascal VOC image size (e.g. 64 for smoke tests)')
FLAGS.DEFINE_float('synthetic_det_noise', 0.0,
                   'additive gaussian pixel-noise sigma (uint8 units) on '
                   'synthetic detection images')
FLAGS.DEFINE_float('synthetic_det_amp', 120.0,
                   'texture amplitude of synthetic detection objects')
FLAGS.DEFINE_integer('synthetic_det_min_div', 4,
                     'min object size = image_size // this')
FLAGS.DEFINE_integer('synthetic_det_max_div', 2,
                     'max object size = image_size // this')

VOC_CLASSES = (
    'aeroplane', 'bicycle', 'bird', 'boat', 'bottle', 'bus', 'car', 'cat',
    'chair', 'cow', 'diningtable', 'dog', 'horse', 'motorbike', 'person',
    'pottedplant', 'sheep', 'sofa', 'train', 'tvmonitor')
VGG_MEAN = (123.0, 117.0, 104.0)


class PascalVocDataset(AbstractDataset):
    SPEC = DatasetSpec(
        name='pascalvoc', nb_classes=21,  # 20 classes + background(0)
        nb_smpls_train=22136, nb_smpls_val=2000, nb_smpls_eval=4952,
        batch_size=32, batch_size_eval=32, image_shape=(300, 300, 3))

    def __init__(self, is_train: bool):
        super().__init__(is_train)
        size = FLAGS.get('voc_image_size')
        if size:
            self.spec = replace(self.spec, image_shape=(int(size), int(size), 3))

    def _load_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        data_dir = resolve_data_dir()
        if data_dir and os.path.isdir(data_dir):
            pattern = 'train*.npz' if self.is_train else 'val*.npz'
            paths = sorted(glob.glob(os.path.join(data_dir, pattern)))
            if paths:
                return self._parse_npz(paths)
        return self.synthesize_detection_arrays()

    def _parse_npz(self, paths):
        images, labels = [], []
        nb_max = FLAGS.nb_bboxs_max
        for path in paths:
            blob = np.load(path, allow_pickle=True)
            images.append(blob['images'])
            difficult = blob['difficult'] if 'difficult' in blob.files else None
            for idx, boxes in enumerate(blob['boxes']):
                padded = np.zeros((nb_max, 6), np.float32)
                n = min(len(boxes), nb_max)
                padded[:n, :5] = boxes[:n]
                padded[:n, 5] = 1.0
                if difficult is not None and len(difficult[idx]):
                    diff = difficult[idx][:n].astype(bool)
                    padded[:n, 5] = np.where(diff, -1.0, 1.0)
                labels.append(padded)
        return np.concatenate(images), np.stack(labels)

    def synthesize_detection_arrays(self, nb_smpls: Optional[int] = None):
        """Non-overlapping rectangles whose texture frequency encodes the
        class, on uniform noise; at most ~128 MiB of uint8 pixels."""
        spec = self.spec
        n = nb_smpls or (spec.nb_smpls_train if self.is_train else spec.nb_smpls_eval)
        h, w, c = spec.image_shape
        n = max(64, min(n, (1 << 27) // (h * w * c)))
        nb_max = FLAGS.nb_bboxs_max

        def _flag(name, default):  # an explicit 0 is a setting; only None falls back
            value = FLAGS.get(name)
            return default if value is None else value
        amp = float(_flag('synthetic_det_amp', 120.0))
        noise = float(_flag('synthetic_det_noise', 0.0))
        min_div = int(_flag('synthetic_det_min_div', 4))
        max_div = int(_flag('synthetic_det_max_div', 2))
        rng = np.random.default_rng(777 + (0 if self.is_train else 1))
        images = rng.integers(100, 156, size=(n, h, w, c)).astype(np.uint8)
        labels = np.zeros((n, nb_max, 6), np.float32)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        for i in range(n):
            nb_boxes = rng.integers(1, 4)
            placed = []
            for _ in range(nb_boxes):
                cls = int(rng.integers(1, spec.nb_classes))
                # rejection-sample a box that does not intersect earlier ones
                for _ in range(8):
                    bh = rng.integers(max(h // min_div, 2), max(h // max_div, 3))
                    bw = rng.integers(max(w // min_div, 2), max(w // max_div, 3))
                    y0 = rng.integers(0, h - bh)
                    x0 = rng.integers(0, w - bw)
                    if all(y0 >= py1 or y0 + bh <= py0 or x0 >= px1 or x0 + bw <= px0
                           for py0, px0, py1, px1 in placed):
                        break
                else:
                    continue  # the image keeps one ground truth fewer
                placed.append((y0, x0, y0 + bh, x0 + bw))
                fx, fy = (cls % 5) + 1, (cls // 5) + 1
                patch = 127.5 + amp * np.sin(
                    2 * np.pi * (fx * xx[y0:y0 + bh, x0:x0 + bw] / w
                                 + fy * yy[y0:y0 + bh, x0:x0 + bw] / h))
                images[i, y0:y0 + bh, x0:x0 + bw] = np.clip(
                    patch[..., None], 0, 255).astype(np.uint8)
                labels[i, len(placed) - 1] = [cls, y0 / h, x0 / w,
                                              (y0 + bh) / h, (x0 + bw) / w, 1.0]
        if noise > 0.0:
            images = np.clip(
                images.astype(np.float32)
                + rng.normal(0.0, noise, size=images.shape).astype(np.float32),
                0, 255).astype(np.uint8)
        return images, labels

    def augment(self, images, generator, is_train):
        """The VGG mean-subtract (fp32 NHWC)."""
        del generator, is_train
        mean = torch.tensor(VGG_MEAN[:images.shape[-1]], dtype=torch.float32,
                            device=images.device)
        return images.to(torch.float32) - mean

    def augment_batch(self, batch, generator: Optional[torch.Generator], is_train: bool):
        """Train: a per-image horizontal flip with the boxes mirrored
        (x' = 1 - x, xmin and xmax swapped), brightness in [-16, 16) and
        contrast in [0.8, 1.2) about each image's mean, a clip to [0, 255];
        then, train and eval, the VGG mean-subtract.  Draws come from
        `generator` for the global batch (flip, brightness, contrast)."""
        images = batch['image'].to(torch.float32)
        labels = batch['label'].to(torch.float32)
        if is_train:
            b, dev = images.shape[0], images.device
            flip = _draw(lambda n: torch.rand(n, generator=generator, device=dev), b) < 0.5
            images = torch.where(flip[:, None, None, None], images.flip(2), images)
            xmin, xmax = labels[..., 2], labels[..., 4]
            labels = labels.clone()
            labels[..., 2] = torch.where(flip[:, None], 1.0 - xmax, xmin)
            labels[..., 4] = torch.where(flip[:, None], 1.0 - xmin, xmax)
            brightness = _draw(lambda n: torch.rand(n, generator=generator, device=dev),
                               b) * 32.0 - 16.0
            contrast = _draw(lambda n: torch.rand(n, generator=generator, device=dev),
                             b) * 0.4 + 0.8
            mean_pix = images.mean(dim=(1, 2, 3), keepdim=True)
            images = ((images - mean_pix) * contrast[:, None, None, None] + mean_pix
                      + brightness[:, None, None, None])
            images = images.clamp(0.0, 255.0)
        return {**batch, 'image': self.augment(images, None, False), 'label': labels}
