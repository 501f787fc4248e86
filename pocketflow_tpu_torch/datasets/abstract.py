"""Abstract dataset: host-side batches, augmentation on the device
(counterpart of pocketflow_tpu/datasets/abstract.py).

The host side only shuffles and batches raw uint8 records (NumPy, one
background thread); every per-pixel op runs on the device inside the train
step through the dataset's ``augment``, so batches cross PCIe as uint8.
Per-dataset sample counts, class counts and batch sizes live in a
`DatasetSpec`; the flags of the same names override them when set.

Under data parallelism each rank reads its own shard of a set, train and
eval alike: ``images[shard_id::nb_shards]``, shuffled with the seed
``rand_seed + 977 * shard_id`` (+ 31337 for eval), as the JAX package
shards by process.
"""

from __future__ import annotations

import queue
import threading
from abc import ABC, abstractmethod
from dataclasses import dataclass, replace
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.core import mesh

FLAGS.DEFINE_integer('nb_classes', None, '# of classes (override)')
FLAGS.DEFINE_integer('nb_smpls_train', None, '# of samples for training (override)')
FLAGS.DEFINE_integer('nb_smpls_val', None, '# of samples for validation (override)')
FLAGS.DEFINE_integer('nb_smpls_eval', None, '# of samples for evaluation (override)')
FLAGS.DEFINE_integer('batch_size', None, 'batch size per chip for training (override)')
FLAGS.DEFINE_integer('batch_size_eval', None, 'batch size for evaluation (override)')
FLAGS.DEFINE_string('data_dir_local', None, 'data directory - local')
FLAGS.DEFINE_string('synthetic_task', 'blobs',
                    'synthetic-data task: `blobs` (fast-saturating smoke data) or '
                    '`hard` (non-saturating noisy-template classification)')
FLAGS.DEFINE_float('synthetic_snr', 0.25,
                   'hard task: per-pixel template amplitude over unit noise')
FLAGS.DEFINE_float('synthetic_label_noise', 0.1,
                   'hard task: fraction of TRAIN labels flipped uniformly '
                   '(eval labels stay clean)')


def resolve_data_dir() -> Optional[str]:
    """The local data directory (``--data_dir_local``); the port reads local
    disks only."""
    disk = FLAGS.get('data_disk') or 'local'
    if disk != 'local':
        raise NotImplementedError(
            "--data_disk=%s is not ported yet (ROADMAP 'Modules to port', item 25: "
            'datasets/remote_fs.py)' % disk)
    return FLAGS.get('data_dir_local')


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    nb_classes: int
    nb_smpls_train: int
    nb_smpls_val: int
    nb_smpls_eval: int
    batch_size: int
    batch_size_eval: int
    image_shape: Tuple[int, int, int]  # H, W, C

    def with_flag_overrides(self) -> 'DatasetSpec':
        updates = {}
        for field in ('nb_classes', 'nb_smpls_train', 'nb_smpls_val',
                      'nb_smpls_eval', 'batch_size', 'batch_size_eval'):
            value = FLAGS.get(field)
            if value is not None:
                updates[field] = int(value)
        return replace(self, **updates) if updates else self


class _Prefetcher:
    """Background-thread prefetch of host batches."""

    def __init__(self, gen_fn, depth: int):
        self._gen = gen_fn()
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        for item in self._gen:
            self._q.put(item)

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()


class AbstractDataset(ABC):
    """Base dataset: subclasses load (or synthesize) arrays and define augment."""

    SPEC: DatasetSpec = None  # set by subclasses

    def __init__(self, is_train: bool):
        self.is_train = is_train
        self.spec = self.SPEC.with_flag_overrides()
        self.shard_id = mesh.worker_rank()
        self.nb_shards = mesh.num_workers()
        self.batch_size = self.spec.batch_size if is_train else self.spec.batch_size_eval
        self._rng = np.random.default_rng(FLAGS.rand_seed + 977 * self.shard_id
                                          + (0 if is_train else 31337))

    # -- subclass interface ---------------------------------------------------

    @abstractmethod
    def _load_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """Return (images, labels) for this subset: uint8 NHWC, int32."""

    def augment(self, images: torch.Tensor, generator: Optional[torch.Generator],
                is_train: bool) -> torch.Tensor:
        """On-device normalize + augment. Default: scale to [0,1]."""
        del generator, is_train
        return images.to(torch.float32) / 255.0

    def augment_batch(self, batch, generator: Optional[torch.Generator], is_train: bool):
        """On-device augmentation of the whole batch (images + labels)."""
        return {**batch, 'image': self.augment(batch['image'], generator, is_train)}

    def augment_xy(self, batch, generator: Optional[torch.Generator], is_train: bool):
        """Augment a device batch and return ``(images, labels)`` — the one
        entry point a learner step uses."""
        out = self.augment_batch(batch, generator, is_train)
        return out['image'], out['label']

    def augment_images(self, batch, generator: Optional[torch.Generator], is_train: bool):
        """The augmented images of a device batch, labels dropped: for the
        steps that only need pixels (feature capture, regression)."""
        return self.augment_batch(batch, generator, is_train)['image']

    def peek_images(self, n: int = 2) -> np.ndarray:
        """First ``n`` raw images without building the iterator pipeline."""
        if not hasattr(self, '_cached_arrays'):
            self._cached_arrays = self._load_arrays()
        images = self._cached_arrays[0]
        return np.asarray(images[np.arange(min(n, len(images)), dtype=np.int64)])

    def peek_batch(self, n: int = 2) -> Dict[str, np.ndarray]:
        """First ``n`` raw rows as a batch dict (labels kept), without
        building the iterator pipeline."""
        if not hasattr(self, '_cached_arrays'):
            self._cached_arrays = self._load_arrays()
        images, labels = self._cached_arrays
        idx = np.arange(min(n, len(images)), dtype=np.int64)
        return {'image': np.asarray(images[idx]), 'label': np.asarray(labels[idx])}

    # -- synthetic data ---------------------------------------------------

    def synthesize_arrays(self, nb_smpls: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Deterministic learnable synthetic data: per-class sinusoid patterns
        with noise; the same seeds and arrays as the JAX package.  With
        --synthetic_task=hard, the noisy-template task of
        ``synthesize_arrays_hard``."""
        if FLAGS.get('synthetic_task') == 'hard':
            return self.synthesize_arrays_hard(nb_smpls)
        spec = self.spec
        n = nb_smpls or (spec.nb_smpls_train if self.is_train else spec.nb_smpls_eval)
        h, w, c = spec.image_shape
        # bound host memory: cap the synthetic set by a total-pixel budget
        n = max(64, min(n, 8192, (1 << 28) // (h * w * c)))
        rng = np.random.default_rng(12345 + (0 if self.is_train else 1))
        labels = rng.integers(0, spec.nb_classes, size=(n,), dtype=np.int32)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        fx = (labels % 4 + 1).astype(np.float32)[:, None, None]
        fy = (labels // 4 % 4 + 1).astype(np.float32)[:, None, None]
        base = 127.5 + 80.0 * np.sin(
            2 * np.pi * (fx * xx[None] / w + fy * yy[None] / h), dtype=np.float32)
        noise = rng.standard_normal(size=(n, h, w, 1), dtype=np.float32) * 16.0
        images = base[..., None] + noise  # broadcast over channels
        images = np.broadcast_to(images, (n, h, w, c))
        return np.clip(images, 0, 255).astype(np.uint8), labels

    def synthesize_arrays_hard(self, nb_smpls: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Non-saturating task: a sample of class k is ``snr * T_k + N(0, 1)``
        per pixel, T_k a fixed smooth random template (low-res Gaussian,
        bilinearly upsampled, zero mean, unit RMS); train labels flipped with
        probability --synthetic_label_noise.  The same seeds and arrays as
        the JAX package."""
        spec = self.spec
        n = nb_smpls or (spec.nb_smpls_train if self.is_train else spec.nb_smpls_eval)
        h, w, c = spec.image_shape
        n = max(64, min(n, 16384, (1 << 28) // (h * w * c)))
        snr = float(FLAGS.get('synthetic_snr') or 0.25)
        label_noise = float(FLAGS.get('synthetic_label_noise') or 0.0)
        nb_classes = spec.nb_classes

        # class templates: fixed seed, shared by both subsets
        trng = np.random.default_rng(777)
        lo = max(4, h // 4), max(4, w // 4)
        tmpl_lo = trng.standard_normal((nb_classes, lo[0], lo[1], c)).astype(np.float32)
        yi = np.linspace(0, lo[0] - 1, h)
        xi = np.linspace(0, lo[1] - 1, w)
        y0 = np.clip(yi.astype(int), 0, lo[0] - 2)
        x0 = np.clip(xi.astype(int), 0, lo[1] - 2)
        wy = (yi - y0)[None, :, None, None].astype(np.float32)
        wx = (xi - x0)[None, None, :, None].astype(np.float32)
        t = (tmpl_lo[:, y0][:, :, x0] * (1 - wy) * (1 - wx)
             + tmpl_lo[:, y0 + 1][:, :, x0] * wy * (1 - wx)
             + tmpl_lo[:, y0][:, :, x0 + 1] * (1 - wy) * wx
             + tmpl_lo[:, y0 + 1][:, :, x0 + 1] * wy * wx)
        t -= t.mean(axis=(1, 2, 3), keepdims=True)
        t /= np.sqrt((t ** 2).mean(axis=(1, 2, 3), keepdims=True)) + 1e-8

        srng = np.random.default_rng(24601 + (0 if self.is_train else 1))
        labels_clean = srng.integers(0, nb_classes, size=(n,), dtype=np.int32)
        images = snr * t[labels_clean]
        for beg in range(0, n, 1024):  # noise in chunks bounds peak host memory
            end = min(n, beg + 1024)
            images[beg:end] += srng.standard_normal((end - beg, h, w, c), dtype=np.float32)
        labels = labels_clean
        if self.is_train and label_noise > 0.0:
            flip = srng.random(n) < label_noise
            shift = srng.integers(1, nb_classes, size=(n,), dtype=np.int32)
            labels = np.where(flip, (labels_clean + shift) % nb_classes,
                              labels_clean).astype(np.int32)
        # 1 sigma of noise = 40 counts
        images = np.clip(127.5 + 40.0 * images, 0, 255).astype(np.uint8)
        return images, labels

    # -- pipeline -------------------------------------------------------------

    def build(self, enbl_trn_val_split: bool = False):
        """Host batch iterator(s): dicts {'image': uint8 [B,H,W,C], 'label':
        int32 [B]}.  Returns one iterator over the set, or, with
        `enbl_trn_val_split`, (train_iter, val_iter): the first
        min(nb_smpls_val, n // 5) samples, unshuffled, are the validation
        part (the RL searches' rewards come from it, never from the eval
        set) and the rest the train part.  Train batches are shuffled every
        epoch; eval and validation batches cycle through their set
        seamlessly, so a loop over them can cover every sample equally."""
        if not hasattr(self, '_cached_arrays'):
            self._cached_arrays = self._load_arrays()
        images, labels = self._cached_arrays
        self.nb_smpls_loaded = len(images)
        if self.nb_shards > 1:  # this rank's disjoint shard, train and eval
            images = images[self.shard_id::self.nb_shards]
            labels = labels[self.shard_id::self.nb_shards]
        if enbl_trn_val_split:
            nb_val = min(self.spec.nb_smpls_val, len(images) // 5)
            val = self._make_iterator(images[:nb_val], labels[:nb_val], shuffle=False)
            trn = self._make_iterator(images[nb_val:], labels[nb_val:], shuffle=self.is_train)
            return trn, val
        return self._make_iterator(images, labels, shuffle=self.is_train)

    def _make_iterator(self, images, labels, shuffle: bool) -> Iterator[Dict[str, np.ndarray]]:
        batch_size, rng = self.batch_size, self._rng

        def gen():
            n = len(images)
            order = np.arange(n)
            if shuffle:
                rng.shuffle(order)
                if n < batch_size:  # a short shard is tiled to one batch
                    order = np.resize(order, batch_size)
                    n = batch_size
                pos = 0
                while True:
                    if pos + batch_size > n:
                        pos = 0
                        rng.shuffle(order)
                    idx = order[pos:pos + batch_size]
                    pos += batch_size
                    yield {'image': images[idx], 'label': labels[idx]}
            else:
                pos = 0
                while True:
                    idx = np.take(order, np.arange(pos, pos + batch_size), mode='wrap')
                    pos = (pos + batch_size) % n
                    yield {'image': images[idx], 'label': labels[idx]}

        return _Prefetcher(gen, depth=max(2, FLAGS.prefetch_size))
