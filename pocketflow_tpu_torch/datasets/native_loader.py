"""ctypes binding of the native data runtime, ``native/pfdata.cc``
(counterpart of pocketflow_tpu/datasets/native_loader.py).

The C++ source lives at the root of the repository and is shared by both
packages: threaded CIFAR-10 record parsing and a shuffling batch sampler
with a bounded prefetch queue, over flat in-RAM arrays or over ``.npy``
shard files read with ``pread`` (a file-backed ``ShardedView``).  It is
compiled with ``g++`` at first use into ``build/pocketflow_tpu_torch/``
beside the package, under a name that carries a hash of the source and the
flags, so an edited source is rebuilt and a stale library never loaded.

The port differs from the JAX package on purpose here: with
``--enbl_native_loader`` on, a library that fails to build or load raises
with the compiler's output; the NumPy path runs only when the flag turns the
native loader off.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

from pocketflow_tpu_torch.datasets.shards import ShardedView
from pocketflow_tpu_torch.ops.build import BUILD_DIR

SRC = Path(__file__).resolve().parents[2] / 'native' / 'pfdata.cc'
GXX_FLAGS = ['-O3', '-std=c++17', '-shared', '-fPIC']
_LIB: Optional[ctypes.CDLL] = None


def lib_path() -> Path:
    """Where the library of the current source and flags is built."""
    digest = hashlib.sha256(SRC.read_bytes() + ' '.join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / ('libpfdata-%s.so' % digest)


def _build(out: Path):
    """Compile the source into `out` (a process-private temporary, then a
    rename: a killed compile never leaves a truncated library behind)."""
    gxx = shutil.which('g++')
    if gxx is None:
        raise RuntimeError('g++ not found: --enbl_native_loader needs a C++ compiler to build '
                           '%s (or pass --enbl_native_loader=False)' % SRC)
    tmp = out.with_suffix('.so.tmp%d' % os.getpid())
    proc = subprocess.run([gxx, *GXX_FLAGS, '-o', str(tmp), str(SRC), '-lpthread'],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError('g++ failed on %s:\n%s' % (SRC, proc.stdout))
    os.replace(tmp, out)


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if it is missing; raises when the
    build or the load fails."""
    global _LIB
    if _LIB is not None:
        return _LIB
    if not SRC.exists():
        raise RuntimeError('the native data runtime %s is missing' % SRC)
    path = lib_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / '.lock', 'w') as lock:  # one build at a time
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not path.exists():
                _build(path)
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as exc:
        raise RuntimeError('cannot load %s: %s' % (path, exc)) from exc
    lib.pfdata_parse_cifar10.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    lib.pfdata_sampler_create.restype = ctypes.c_void_p
    lib.pfdata_sampler_create.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32]
    lib.pfdata_file_sampler_create.restype = ctypes.c_void_p
    lib.pfdata_file_sampler_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32]
    lib.pfdata_sampler_next.restype = ctypes.c_int32
    lib.pfdata_sampler_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.pfdata_sampler_destroy.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def parse_cifar10(raw: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Parse concatenated CIFAR-10 .bin records natively: (images uint8
    [n, 32, 32, 3], labels int32 [n])."""
    lib = get_lib()
    record = 1 + 32 * 32 * 3
    nb = raw.size // record
    raw = np.ascontiguousarray(raw[:nb * record], np.uint8)
    images = np.empty((nb, 32, 32, 3), np.uint8)
    labels = np.empty((nb,), np.int32)
    lib.pfdata_parse_cifar10(raw.ctypes.data_as(ctypes.c_void_p), nb,
                             images.ctypes.data_as(ctypes.c_void_p),
                             labels.ctypes.data_as(ctypes.c_void_p))
    return images, labels


class NativeSampler:
    """Threaded shuffling batch iterator of the native runtime.

    The batch stream depends only on (seed, batch, shuffle, n), never on
    `nb_threads`: the C++ side draws indices under a lock in sequence order
    and delivers batches in that order.  Both packages build the same
    source, so at the same arguments their streams are byte-identical.
    Shuffled streams reshuffle at each pass; unshuffled ones cycle through
    the set seamlessly.

    `images` is a flat uint8 array or a file-backed ``ShardedView`` (rows
    read with ``pread``, resident memory bounded by the queue). Labels ride
    as float32 rows of any shape (an int class, the [class, valid_h,
    valid_w] rows of full-frame ILSVRC-12 shards, detection boxes); integer
    labels come back as int32.
    """

    def __init__(self, images, labels: np.ndarray, batch_size: int, shuffle: bool,
                 seed: int, nb_threads: int = 2, queue_depth: int = 4):
        lib = get_lib()
        self._lib = lib
        self._handle = None
        self._labels = np.ascontiguousarray(labels, np.float32)
        if self._labels.ndim == 1:
            self._labels = self._labels[:, None]
        self.label_shape = self._labels.shape[1:]
        self.batch_size = batch_size
        self._label_is_int = np.issubdtype(labels.dtype, np.integer)
        label_floats = int(np.prod(self.label_shape))
        common = (label_floats, batch_size, 1 if shuffle else 0, seed, nb_threads, queue_depth)

        if isinstance(images, ShardedView):
            if images.dtype != np.uint8:
                raise ValueError('the native sampler reads uint8 image shards')
            table = images.file_table()
            if table is None:
                raise ValueError('the ShardedView is not file-backed')
            paths, offsets, counts = table
            index = np.ascontiguousarray(images.global_index(), np.int64)
            if len(index) != len(self._labels):
                raise ValueError('labels must be gathered to the selection: %d rows for %d '
                                 'images' % (len(self._labels), len(index)))
            self.image_shape = images.item_shape
            offsets_arr = np.asarray(offsets, np.int64)
            counts_arr = np.asarray(counts, np.int64)
            c_paths = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
            self._handle = lib.pfdata_file_sampler_create(
                c_paths, offsets_arr.ctypes.data_as(ctypes.c_void_p),
                counts_arr.ctypes.data_as(ctypes.c_void_p), len(paths),
                self._labels.ctypes.data_as(ctypes.c_void_p),
                index.ctypes.data_as(ctypes.c_void_p), len(index),
                int(np.prod(self.image_shape)), *common)
            if not self._handle:
                raise OSError('pfdata_file_sampler_create failed: a shard of %s is unreadable'
                              % (paths,))
            return
        # the sampler reads these buffers in place: keep them alive
        self._images = np.ascontiguousarray(images, np.uint8)
        if len(self._images) != len(self._labels):
            raise ValueError('%d label rows for %d images' % (len(self._labels), len(self._images)))
        self.image_shape = self._images.shape[1:]
        self._handle = lib.pfdata_sampler_create(
            self._images.ctypes.data_as(ctypes.c_void_p),
            self._labels.ctypes.data_as(ctypes.c_void_p), len(self._images),
            int(np.prod(self.image_shape)), *common)

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        images = np.empty((self.batch_size, *self.image_shape), np.uint8)
        labels = np.empty((self.batch_size, *self.label_shape), np.float32)
        ok = self._lib.pfdata_sampler_next(self._handle, images.ctypes.data_as(ctypes.c_void_p),
                                           labels.ctypes.data_as(ctypes.c_void_p))
        if not ok:
            raise IOError('pfdata: a shard read failed mid-stream')
        if self._label_is_int:
            labels = labels.astype(np.int32)
        if labels.ndim == 2 and labels.shape[-1] == 1:
            labels = labels[:, 0]
        return {'image': images, 'label': labels}

    def close(self):
        if getattr(self, '_handle', None):  # None too when __init__ raised
            self._lib.pfdata_sampler_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
