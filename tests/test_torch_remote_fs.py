"""--data_disk=hdfs in the port (datasets/remote_fs.py) held to the behaviour
of the JAX package's tests/test_remote_fs.py: a file:// host staged once into
the cache that the datasets then read, both packages resolving the same URL
to the same cache entry; the loser of the staging election waiting for the
winner's copy; the stale-lock timeout; the required flags; path.conf's hdfs
entries applied."""

import hashlib
import os
import threading
import time

import numpy as np
import pytest

import pocketflow_tpu.datasets.remote_fs  # noqa: F401  (registers the JAX flags)
from pocketflow_tpu.config import FLAGS as JFLAGS
from pocketflow_tpu_torch.config import FLAGS as TFLAGS
from pocketflow_tpu_torch.datasets import remote_fs


@pytest.fixture(autouse=True)
def _port_flags():
    remote_fs._RESOLVED.clear()
    with TFLAGS.scope(**TFLAGS.as_dict()):
        yield
    remote_fs._RESOLVED.clear()


def _write_cifar_bin(dirpath, n=20, seed=0):
    rng = np.random.default_rng(seed)
    record = 1 + 3072
    raw = rng.integers(0, 256, size=(n * record,), dtype=np.uint8)
    raw.reshape(-1, record)[:, 0] %= 10
    dirpath.mkdir(parents=True, exist_ok=True)
    raw.tofile(dirpath / 'data_batch_1.bin')
    return raw.reshape(-1, record)[:, 0].astype(np.int32)


def _hdfs_flags(tmp_path, **extra):
    return dict(data_disk='hdfs', data_hdfs_host='file://%s' % (tmp_path / 'remote'),
                data_dir_hdfs='cifar10', data_cache_dir=str(tmp_path / 'cache'), **extra)


def _dst(tmp_path):
    url = 'file://%s/cifar10' % (tmp_path / 'remote')
    return os.path.join(str(tmp_path / 'cache'), hashlib.sha1(url.encode()).hexdigest()[:16])


def test_hdfs_disk_stages_once_and_datasets_read_the_cache(tmp_path):
    from pocketflow_tpu.datasets.remote_fs import _RESOLVED as jresolved
    from pocketflow_tpu.datasets.remote_fs import resolve_data_dir as jresolve
    from pocketflow_tpu_torch.datasets.cifar10 import Cifar10Dataset
    labels = _write_cifar_bin(tmp_path / 'remote' / 'cifar10')
    flags = _hdfs_flags(tmp_path, batch_size=4, nb_smpls_train=20, synthetic_data=False)
    with TFLAGS.scope(**flags):
        staged = remote_fs.resolve_data_dir()
        assert staged == _dst(tmp_path)
        assert os.path.exists(os.path.join(staged, 'data_batch_1.bin'))
        # the dataset reads the staged records, not synthetic data
        np.testing.assert_array_equal(Cifar10Dataset(is_train=True)._load_arrays()[1], labels)
        # a second resolve, memo cleared, finds the cache and copies nothing
        mtime = os.path.getmtime(staged)
        remote_fs._RESOLVED.clear()
        time.sleep(0.05)
        assert remote_fs.resolve_data_dir() == staged
        assert os.path.getmtime(staged) == mtime
        assert sorted(os.listdir(tmp_path / 'cache')) == [os.path.basename(staged)]
    with JFLAGS.scope(**flags):  # the JAX package resolves the same cache entry
        try:
            assert jresolve() == staged
        finally:
            jresolved.clear()
    assert os.path.getmtime(staged) == mtime


def test_hdfs_disk_requires_host_and_dir(tmp_path):
    with TFLAGS.scope(data_disk='hdfs', data_hdfs_host=None, data_dir_hdfs=None):
        with pytest.raises(ValueError, match='data_hdfs_host'):
            remote_fs.resolve_data_dir()
    with TFLAGS.scope(data_disk='hdfs', data_hdfs_host='file:///srv', data_dir_hdfs=None):
        with pytest.raises(ValueError, match='data_dir_hdfs'):
            remote_fs.resolve_data_dir()
    with TFLAGS.scope(data_disk='nfs'):
        with pytest.raises(ValueError, match='unrecognized data disk'):
            remote_fs.resolve_data_dir()
    with TFLAGS.scope(data_disk='hdfs', data_hdfs_host='s3://bucket', data_dir_hdfs='x',
                      data_cache_dir=str(tmp_path)):
        with pytest.raises(ValueError, match='unsupported remote data scheme'):
            remote_fs.resolve_data_dir()
    assert os.listdir(tmp_path) == []  # no lock left behind


def test_stage_election_loser_waits_for_winner(tmp_path):
    """A process that finds another's lock waits for that copy to land (the
    lock gone, the directory there) and stages nothing itself."""
    _write_cifar_bin(tmp_path / 'remote' / 'cifar10')
    (tmp_path / 'cache').mkdir()
    dst = _dst(tmp_path)
    os.mkdir(dst + '.lock')  # another process is mid-staging
    staged_by_winner = []

    def winner_finishes():
        remote_fs._stage('file://%s/cifar10' % (tmp_path / 'remote'), dst)
        staged_by_winner.append(os.path.getmtime(dst))
        os.rmdir(dst + '.lock')

    timer = threading.Timer(0.3, winner_finishes)
    timer.start()
    try:
        with TFLAGS.scope(**_hdfs_flags(tmp_path, data_stage_timeout=30.0)):
            assert remote_fs.resolve_data_dir() == dst
            assert os.path.exists(os.path.join(dst, 'data_batch_1.bin'))
    finally:
        timer.join()
    assert staged_by_winner == [os.path.getmtime(dst)]


def test_stage_election_times_out_on_stale_lock(tmp_path):
    (tmp_path / 'remote' / 'cifar10').mkdir(parents=True)
    (tmp_path / 'cache').mkdir()
    dst = _dst(tmp_path)
    os.mkdir(dst + '.lock')  # a crashed run left its lock; no copy ever appears
    start = time.perf_counter()
    with TFLAGS.scope(**_hdfs_flags(tmp_path, data_stage_timeout=1.0)):
        with pytest.raises(RuntimeError, match='stale lock'):
            remote_fs.resolve_data_dir()
    assert 1.0 <= time.perf_counter() - start < 10.0
    assert not os.path.exists(dst)


def test_path_conf_routes_hdfs_entries(tmp_path):
    from pocketflow_tpu.utils.path_args import apply_path_conf as japply
    from pocketflow_tpu_torch.utils.path_args import apply_path_conf
    conf = tmp_path / 'path.conf'
    conf.write_text('data_disk = hdfs\n'
                    'data_hdfs_host = file:///srv/data\n'
                    'data_dir_hdfs_cifar10 = cifar10-bins\n'
                    'data_dir_hdfs_ilsvrc12 = imagenet-shards\n')
    names = ('data_disk', 'data_hdfs_host', 'data_dir_hdfs')
    start = dict(data_disk='local', data_hdfs_host=None, data_dir_hdfs=None)
    with TFLAGS.scope(**start), JFLAGS.scope(**start):
        apply_path_conf('resnet_at_cifar10', str(conf))
        japply('resnet_at_cifar10', str(conf))
        assert [TFLAGS.get(n) for n in names] == [JFLAGS.get(n) for n in names] \
            == ['hdfs', 'file:///srv/data', 'cifar10-bins']
    # an explicit --data_dir_hdfs wins over path.conf's entry
    with TFLAGS.scope(data_disk='local', data_hdfs_host=None, data_dir_hdfs='given'):
        apply_path_conf('resnet_at_ilsvrc12', str(conf))
        assert TFLAGS.data_dir_hdfs == 'given' and TFLAGS.data_disk == 'hdfs'
