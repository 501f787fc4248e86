"""The port's native data runtime against the JAX package's, on the CPU.

Both packages bind the same ``native/pfdata.cc`` (the port builds its own
library under build/), so at the same seed and batch their batch streams
must be byte-equal: flat arrays, a file-backed ShardedView and a selection
of it, [n, 3] float label rows (full-frame ILSVRC-12), detection labels, and
1 against 4 threads.  Then ``AbstractDataset.build()`` through both packages
at the default flags (the native loader on): the shuffled train stream, the
seamless eval cycle, --enbl_trn_val_split, and rank shards 0 and 1 of 2.
A library that fails to build raises; only --enbl_native_loader=False takes
the NumPy path."""

import os

import numpy as np
import pytest
import torch

import pocketflow_tpu.datasets.fmnist  # noqa: F401  (registers the datasets' flags)
import pocketflow_tpu_torch.datasets.fmnist  # noqa: F401
from pocketflow_tpu.config import FLAGS as JFLAGS
from pocketflow_tpu_torch.config import FLAGS as TFLAGS

torch.set_num_threads(2)
NB_BATCHES = 9


@pytest.fixture(autouse=True)
def _port_flags():
    with TFLAGS.scope(**TFLAGS.as_dict()):
        yield


def _samplers():
    from pocketflow_tpu.datasets.native_loader import NativeSampler as J
    from pocketflow_tpu.datasets.native_loader import get_lib
    from pocketflow_tpu_torch.datasets.native_loader import NativeSampler as T
    assert get_lib() is not None, 'the JAX package found no native library'
    return J, T


def _write_shards(tmp_path, counts=(10, 7, 15), item_shape=(5, 6, 3), seed=0):
    rng = np.random.default_rng(seed)
    paths = []
    for i, n in enumerate(counts):
        path = str(tmp_path / ('train_images_%02d.npy' % i))
        np.save(path, rng.integers(0, 256, (n,) + item_shape, dtype=np.uint8))
        paths.append(path)
    return paths


def _views(tmp_path):
    from pocketflow_tpu.datasets.shards import ShardedView as JView
    from pocketflow_tpu_torch.datasets.shards import ShardedView as TView
    paths = _write_shards(tmp_path)
    return JView.from_npy_files(paths), TView.from_npy_files(paths)


def _case(name, tmp_path):
    """(JAX images, port images, labels, sampler kwargs) of a case."""
    rng = np.random.default_rng(1)
    kw = dict(batch_size=8, shuffle=True, seed=5, queue_depth=3)
    if name in ('flat', 'threads'):
        images = rng.integers(0, 256, (45, 4, 4, 3), dtype=np.uint8)
        labels = rng.integers(0, 1000, 45).astype(np.int32)
        return images, images, labels, kw
    if name == 'detection':
        images = rng.integers(0, 256, (12, 6, 6, 3), dtype=np.uint8)
        labels = rng.normal(size=(12, 5, 6)).astype(np.float32)
        return images, images, labels, dict(kw, batch_size=5, shuffle=False)
    jview, tview = _views(tmp_path)
    if name == 'file':
        return jview, tview, np.arange(32, dtype=np.int32), kw
    if name == 'selection':
        return jview[1::2][3:], tview[1::2][3:], np.arange(1, 32, 2, dtype=np.int32)[3:], kw
    assert name == 'extents'  # full-frame label rows [class, valid_h, valid_w]
    labels = np.stack([rng.integers(1, 1001, 32), rng.integers(2, 6, 32),
                       rng.integers(2, 7, 32)], axis=1).astype(np.float32)
    return jview, tview, labels, dict(kw, batch_size=6)


@pytest.mark.parametrize('name', ['flat', 'file', 'selection', 'extents', 'detection',
                                  'threads'])
def test_sampler_stream_is_byte_equal_to_jax(name, tmp_path):
    J, T = _samplers()
    jimages, timages, labels, kw = _case(name, tmp_path)
    threads = (1, 4) if name == 'threads' else (2, 2)  # JAX's, the port's
    want = J(jimages, labels, **dict(kw, nb_threads=threads[0]))
    got = T(timages, labels, **dict(kw, nb_threads=threads[1]))
    for _ in range(NB_BATCHES):
        w, g = next(want), next(got)
        assert g['image'].dtype == np.uint8 and g['label'].dtype == w['label'].dtype
        assert g['image'].tobytes() == w['image'].tobytes()
        assert g['label'].shape == w['label'].shape
        assert g['label'].tobytes() == w['label'].tobytes()
    want.close()
    got.close()


def test_file_sampler_serves_the_selected_rows(tmp_path):
    _, T = _samplers()
    _, tview = _views(tmp_path)
    flat = tview.materialize()
    sampler = T(tview[1::2], np.arange(1, 32, 2, dtype=np.int32), batch_size=4, shuffle=True,
                seed=0, nb_threads=3)
    seen = []
    for _ in range(4):  # one pass over the 16 selected rows
        batch = next(sampler)
        np.testing.assert_array_equal(batch['image'], flat[batch['label']])
        seen += batch['label'].tolist()
    assert sorted(seen) == list(range(1, 32, 2))
    sampler.close()


def test_cifar10_parse_matches_jax():
    from pocketflow_tpu.datasets.native_loader import parse_cifar10 as jparse
    from pocketflow_tpu_torch.datasets.native_loader import parse_cifar10
    rng = np.random.default_rng(0)
    record = 1 + 32 * 32 * 3
    raw = rng.integers(0, 256, size=(37 * record,), dtype=np.uint8)
    raw.reshape(-1, record)[:, 0] %= 10
    (ti, tl), (ji, jl) = parse_cifar10(raw), jparse(raw)
    assert ti.tobytes() == ji.tobytes() and tl.tobytes() == jl.tobytes()
    assert tl.dtype == np.int32 and ti.shape == (37, 32, 32, 3)


def test_shard_table_matches_jax(tmp_path):
    """file_table and global_index, which the pread sampler reads, equal
    the JAX package's, of a view and of selections composed on it."""
    jview, tview = _views(tmp_path)
    assert tview.file_table() == jview.file_table()
    for sel in (slice(None), slice(1, None, 2), slice(3, 20)):
        np.testing.assert_array_equal(tview[sel].global_index(), jview[sel].global_index())
        np.testing.assert_array_equal(tview[sel][2::3].global_index(),
                                      jview[sel][2::3].global_index())


def _fmnist(package, is_train):
    if package == 'jax':
        from pocketflow_tpu.datasets.fmnist import FMnistDataset
    else:
        from pocketflow_tpu_torch.datasets.fmnist import FMnistDataset
    return FMnistDataset(is_train)


def _iterators(package, case):
    """The iterators a case reads of `package`'s FMNIST dataset."""
    if case == 'eval':
        return [_fmnist(package, False).build()]
    dataset = _fmnist(package, True)
    if case.startswith('shard'):
        dataset.shard_id, dataset.nb_shards = int(case[-1]), 2
        return [dataset.build()]
    if case == 'split':
        return list(dataset.build(enbl_trn_val_split=True))
    return [dataset.build()]


@pytest.mark.parametrize('case', ['train', 'eval', 'split', 'shard0', 'shard1'])
def test_dataset_build_is_byte_equal_to_jax(case):
    """build() at the default flags through both packages, the native
    loader on in both, rank sharding by images[shard_id::nb_shards] and the
    seed rand_seed + 977 * shard_id."""
    from pocketflow_tpu.datasets.native_loader import NativeSampler as J
    from pocketflow_tpu_torch.datasets.native_loader import NativeSampler as T
    flags = dict(synthetic_data=True, batch_size=8, batch_size_eval=6, nb_smpls_train=70,
                 nb_smpls_eval=70, nb_smpls_val=9, rand_seed=4, nb_threads=6, prefetch_size=3)
    with JFLAGS.scope(**flags), TFLAGS.scope(**flags):
        assert JFLAGS.enbl_native_loader and TFLAGS.enbl_native_loader
        want, got = _iterators('jax', case), _iterators('port', case)
        assert all(isinstance(it, J) for it in want) and all(isinstance(it, T) for it in got)
        for w_it, g_it in zip(want, got):
            for _ in range(12):  # past a pass over every set
                w, g = next(w_it), next(g_it)
                assert g['image'].tobytes() == w['image'].tobytes()
                assert g['label'].dtype == w['label'].dtype == np.int32
                assert g['label'].tobytes() == w['label'].tobytes()


def test_failed_build_raises_and_the_flag_off_takes_numpy(tmp_path, monkeypatch):
    """No silent fallback: a source that does not compile raises with the
    compiler's output, on every build() while the flag is on; the NumPy
    iterator runs only with --enbl_native_loader=False."""
    from pocketflow_tpu_torch.datasets import abstract, native_loader
    bad = tmp_path / 'pfdata.cc'
    bad.write_text('this is not C++\n')
    monkeypatch.setattr(native_loader, 'SRC', bad)
    monkeypatch.setattr(native_loader, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(native_loader, '_LIB', None)
    with TFLAGS.scope(synthetic_data=True, batch_size=8, nb_smpls_train=64):
        with pytest.raises(RuntimeError, match='g\\+\\+ failed') as info:
            _fmnist('port', True).build()
        assert 'not C++' in str(info.value) or 'error' in str(info.value)
        assert not list((tmp_path / 'build').glob('*.so'))  # nothing half-written
        monkeypatch.setattr(native_loader.shutil, 'which', lambda name: None)
        with pytest.raises(RuntimeError, match='g\\+\\+ not found'):
            _fmnist('port', True).build()
        with TFLAGS.scope(enbl_native_loader=False):
            iterator = _fmnist('port', True).build()
            assert isinstance(iterator, abstract._Prefetcher)
            assert next(iterator)['image'].shape == (8, 28, 28, 1)


def test_library_is_built_beside_the_package_under_a_hash():
    from pocketflow_tpu_torch.datasets import native_loader
    from pocketflow_tpu_torch.ops.build import BUILD_DIR
    native_loader.get_lib()
    path = native_loader.lib_path()
    assert path.parent == BUILD_DIR and path.exists()
    assert path.name.startswith('libpfdata-') and path.suffix == '.so'
    assert os.path.samefile(native_loader.SRC, os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'native', 'pfdata.cc'))
