"""Abstract dataset: host-side batches, augmentation on the device
(counterpart of pocketflow_tpu/datasets/abstract.py).

The host side only shuffles and batches raw uint8 records (NumPy, one
background thread); every per-pixel op runs on the device inside the train
step through the dataset's ``augment``, so batches cross PCIe as uint8.
Per-dataset sample counts, class counts and batch sizes live in a
`DatasetSpec`; the flags of the same names override them when set.
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

FLAGS.DEFINE_integer('nb_classes', None, '# of classes (override)')
FLAGS.DEFINE_integer('nb_smpls_train', None, '# of samples for training (override)')
FLAGS.DEFINE_integer('nb_smpls_val', None, '# of samples for validation (override)')
FLAGS.DEFINE_integer('nb_smpls_eval', None, '# of samples for evaluation (override)')
FLAGS.DEFINE_integer('batch_size', None, 'batch size per chip for training (override)')
FLAGS.DEFINE_integer('batch_size_eval', None, 'batch size for evaluation (override)')
FLAGS.DEFINE_string('data_dir_local', None, 'data directory - local')
FLAGS.DEFINE_string('synthetic_task', 'blobs',
                    'synthetic-data task: `blobs` (fast-saturating smoke data); '
                    '`hard` is not ported yet')


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
        self.batch_size = self.spec.batch_size if is_train else self.spec.batch_size_eval
        self._rng = np.random.default_rng(FLAGS.rand_seed + (0 if is_train else 31337))

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

    def peek_images(self, n: int = 2) -> np.ndarray:
        """First ``n`` raw images without building the iterator pipeline."""
        if not hasattr(self, '_cached_arrays'):
            self._cached_arrays = self._load_arrays()
        return np.asarray(self._cached_arrays[0][:n])

    # -- synthetic data ---------------------------------------------------

    def synthesize_arrays(self, nb_smpls: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Deterministic learnable synthetic data: per-class sinusoid patterns
        with noise; the same seeds and arrays as the JAX package."""
        if FLAGS.get('synthetic_task') != 'blobs':
            raise NotImplementedError(
                "--synthetic_task=%s is not ported yet (ROADMAP 'Modules to port', "
                'item 12)' % FLAGS.get('synthetic_task'))
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

    # -- pipeline -------------------------------------------------------------

    def build(self) -> Iterator[Dict[str, np.ndarray]]:
        """Host batch iterator: dicts {'image': uint8 [B,H,W,C], 'label': int32 [B]}.
        Train batches are shuffled every epoch; eval batches cycle through the
        set seamlessly, so an eval loop can cover every sample equally."""
        if not hasattr(self, '_cached_arrays'):
            self._cached_arrays = self._load_arrays()
        images, labels = self._cached_arrays
        self.nb_smpls_loaded = len(images)
        batch_size, rng, shuffle = self.batch_size, self._rng, self.is_train

        def gen():
            n = len(images)
            order = np.arange(n)
            if shuffle:
                rng.shuffle(order)
                if n < batch_size:
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
