"""Sharded on-disk dataset view (a copy of pocketflow_tpu/datasets/shards.py).

A :class:`ShardedView` over per-shard ``.npy`` files is a lazy, read-only,
logically-concatenated array, so an ImageNet-scale train set never lives in
RAM:

* ``len()`` / ``.shape`` / ``.dtype``;
* lazy strided selection (``view[start::step]``, ``view[:k]``) that composes
  indices only;
* fancy-gather (``view[idx_array]``) materializing just one batch, which the
  host batch iterator uses;
* a shard table (paths + data offsets + counts) and the composed index,
  which the native ``pread`` sampler (``datasets/native_loader.py``) reads,
  keeping resident memory bounded at its queue of batches.
"""

from __future__ import annotations

import ast
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np


def read_npy_header(path: str) -> Tuple[tuple, np.dtype, int]:
    """Return (shape, dtype, data_offset) of a .npy file without loading it."""
    with open(path, 'rb') as f:
        magic = f.read(6)
        if magic != b'\x93NUMPY':
            raise ValueError('not a .npy file: %s' % path)
        major, _minor = f.read(2)
        if major == 1:
            (hlen,) = struct.unpack('<H', f.read(2))
            offset = 10 + hlen
        else:
            (hlen,) = struct.unpack('<I', f.read(4))
            offset = 12 + hlen
        header = ast.literal_eval(f.read(hlen).decode('latin1'))
    if header.get('fortran_order'):
        raise ValueError('fortran-order .npy shards are not supported: %s' % path)
    return tuple(header['shape']), np.dtype(header['descr']), offset


class ShardedView:
    """Lazy concatenated view over per-shard arrays (optionally file-backed)."""

    def __init__(self, arrays: Sequence[np.ndarray],
                 paths: Optional[Sequence[str]] = None,
                 index: Optional[np.ndarray] = None):
        if not arrays:
            raise ValueError('ShardedView needs at least one shard')
        self.arrays = list(arrays)
        self.paths = list(paths) if paths is not None else None
        counts = np.array([len(a) for a in self.arrays], np.int64)
        self.offsets = np.concatenate([[0], np.cumsum(counts)])
        self._index = index  # None = identity over all rows
        self.item_shape = tuple(self.arrays[0].shape[1:])
        self.dtype = self.arrays[0].dtype
        for a in self.arrays:
            if tuple(a.shape[1:]) != self.item_shape or a.dtype != self.dtype:
                raise ValueError('inconsistent shard shapes/dtypes')

    @classmethod
    def from_npy_files(cls, paths: Sequence[str]) -> 'ShardedView':
        arrays = [np.load(p, mmap_mode='r') for p in paths]
        return cls(arrays, paths=paths)

    # -- array-like surface ----------------------------------------------------

    def __len__(self) -> int:
        return int(self.offsets[-1]) if self._index is None else len(self._index)

    @property
    def shape(self):
        return (len(self),) + self.item_shape

    @property
    def nbytes(self) -> int:
        return len(self) * int(np.prod(self.item_shape)) * self.dtype.itemsize

    def global_index(self) -> np.ndarray:
        """The composed selection: slot -> global row id (identity if None)."""
        if self._index is None:
            return np.arange(int(self.offsets[-1]), dtype=np.int64)
        return self._index

    def _compose(self, sel: np.ndarray) -> 'ShardedView':
        base = self._index[sel] if self._index is not None else sel.astype(np.int64)
        return ShardedView(self.arrays, paths=self.paths, index=base)

    def __getitem__(self, key):
        if isinstance(key, slice):
            sel = np.arange(len(self), dtype=np.int64)[key]
            return self._compose(sel)
        key = np.asarray(key)
        if key.ndim == 0:
            return self._gather(key[None])[0]
        return self._gather(key)

    def _gather(self, slots: np.ndarray) -> np.ndarray:
        """Materialize the given slots into a fresh array (one batch's worth)."""
        rows = self.global_index()[slots] if self._index is not None else slots
        out = np.empty((len(rows),) + self.item_shape, self.dtype)
        shard_ids = np.searchsorted(self.offsets, rows, side='right') - 1
        for s in np.unique(shard_ids):
            mask = shard_ids == s
            out[mask] = self.arrays[s][rows[mask] - self.offsets[s]]
        return out

    def materialize(self) -> np.ndarray:
        """Load the whole selection into RAM (small sets / tests only)."""
        return self._gather(np.arange(len(self), dtype=np.int64))

    # -- native shard table ----------------------------------------------------

    def file_table(self) -> Optional[Tuple[List[str], List[int], List[int]]]:
        """(paths, data_offsets, counts) for the native pread sampler.

        Only available when every shard is file-backed; returns None otherwise.
        """
        if self.paths is None:
            return None
        offsets, counts = [], []
        for path, arr in zip(self.paths, self.arrays):
            shape, dtype, off = read_npy_header(path)
            if shape[0] != len(arr) or dtype != self.dtype:
                return None
            offsets.append(off)
            counts.append(shape[0])
        return self.paths, offsets, counts
