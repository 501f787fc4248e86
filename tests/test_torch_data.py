"""The port's datasets and data tools against the JAX package's, on the CPU:
the real-format readers (CIFAR-10 `.bin` records and ILSVRC-12 `.npy` shards
written by each package's make_minimal_data, FMNIST idx-gz files written
here) bit-equal to JAX's arrays; the `hard` synthetic task bit-equal;
pad_random_crop on the same offsets; the ILSVRC-12 train augment of both
--ilsvrc_augment paths with the flip switched off on both sides; peek_batch;
path.conf applied by the port's main.py."""

import gzip
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocketflow_tpu.config import FLAGS as JFLAGS
from pocketflow_tpu_torch.config import FLAGS as TFLAGS

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _port_flags():
    """Restore every flag of the port's registry after each test."""
    with TFLAGS.scope(**TFLAGS.as_dict()):
        yield


def _both(**flags):
    return JFLAGS.scope(**flags), TFLAGS.scope(**flags)


@pytest.fixture(scope='module')
def minimal(tmp_path_factory):
    """Minimal CIFAR-10 and ILSVRC-12 sets written by both packages' tools."""
    from pocketflow_tpu.tools import make_minimal_data as jmake
    from pocketflow_tpu_torch.tools import make_minimal_data as tmake
    root = tmp_path_factory.mktemp('minimal')
    argv = ['--datasets=cifar10,ilsvrc12', '--nb_train=20', '--nb_eval=6', '--seed=3']
    jmake.main(['--dst_dir=%s' % (root / 'jax')] + argv)
    tmake.main(['--dst_dir=%s' % (root / 'port')] + argv)
    return root


def test_make_minimal_data_writes_the_same_files(minimal):
    for name in ('cifar10', 'ilsvrc12'):
        files = sorted(os.listdir(minimal / 'jax' / name))
        assert files == sorted(os.listdir(minimal / 'port' / name)) and files
        for fname in files:
            with open(minimal / 'jax' / name / fname, 'rb') as a, \
                    open(minimal / 'port' / name / fname, 'rb') as b:
                assert a.read() == b.read(), fname
    from pocketflow_tpu_torch.tools import make_minimal_data as tmake
    with pytest.raises(NotImplementedError, match='item 25'):
        tmake.main(['--dst_dir=%s' % (minimal / 'voc'), '--datasets=pascalvoc'])


@pytest.mark.parametrize('is_train', [True, False])
def test_cifar10_reader_matches_jax(minimal, is_train):
    from pocketflow_tpu.datasets.cifar10 import Cifar10Dataset as J
    from pocketflow_tpu_torch.datasets.cifar10 import Cifar10Dataset as T
    jscope, tscope = _both(data_dir_local=str(minimal / 'port' / 'cifar10'), synthetic_data=False)
    with jscope, tscope:
        jimg, jlab = J(is_train)._load_arrays()
        timg, tlab = T(is_train)._load_arrays()
    assert timg.shape == ((20 if is_train else 6), 32, 32, 3) and timg.dtype == np.uint8
    np.testing.assert_array_equal(timg, np.asarray(jimg))
    np.testing.assert_array_equal(tlab, np.asarray(jlab))
    assert tlab.dtype == np.int32


@pytest.mark.parametrize('is_train', [True, False])
def test_ilsvrc12_shard_reader_matches_jax(minimal, is_train):
    from pocketflow_tpu.datasets.ilsvrc12 import Ilsvrc12Dataset as J
    from pocketflow_tpu_torch.datasets.ilsvrc12 import Ilsvrc12Dataset as T
    from pocketflow_tpu_torch.datasets.shards import ShardedView
    jscope, tscope = _both(data_dir_local=str(minimal / 'port' / 'ilsvrc12'))
    with jscope, tscope:
        jimg, jlab = J(is_train)._load_arrays()
        tds = T(is_train)
        timg, tlab = tds._load_arrays()
        assert isinstance(timg, ShardedView) and len(timg) == (20 if is_train else 6)
        np.testing.assert_array_equal(timg.materialize(), jimg.materialize())
        np.testing.assert_array_equal(tlab, np.asarray(jlab))
        batch = tds.peek_batch(3)  # rows gathered out of the shard files
        np.testing.assert_array_equal(batch['image'], jimg.materialize()[:3])
        np.testing.assert_array_equal(batch['label'], np.asarray(jlab)[:3])
        np.testing.assert_array_equal(tds.peek_images(2), jimg.materialize()[:2])


def test_ilsvrc12_full_frame_shards_are_refused(minimal, tmp_path):
    from pocketflow_tpu_torch.datasets.ilsvrc12 import Ilsvrc12Dataset as T
    for name in os.listdir(minimal / 'port' / 'ilsvrc12'):
        os.link(minimal / 'port' / 'ilsvrc12' / name, tmp_path / name)
    np.save(tmp_path / 'train_extents_00000.npy', np.full((20, 2), 200, np.int32))
    with TFLAGS.scope(data_dir_local=str(tmp_path)):
        with pytest.raises(NotImplementedError, match='item 25'):
            T(True)._load_arrays()
    with TFLAGS.scope(data_dir_local=str(tmp_path), data_disk='hdfs'):
        with pytest.raises(NotImplementedError, match='item 25'):
            T(True)._load_arrays()


def _write_idx(path, array, magic):
    with gzip.open(path, 'wb') as fout:
        fout.write(magic.to_bytes(4, 'big'))
        for dim in array.shape:
            fout.write(int(dim).to_bytes(4, 'big'))
        fout.write(array.astype(np.uint8).tobytes())


@pytest.mark.parametrize('is_train', [True, False])
def test_fmnist_idx_reader_matches_jax(tmp_path, is_train):
    from pocketflow_tpu.datasets.fmnist import FMnistDataset as J
    from pocketflow_tpu_torch.datasets.fmnist import FMnistDataset as T
    rng = np.random.default_rng(4)
    for prefix, n in (('train', 12), ('t10k', 5)):
        _write_idx(tmp_path / ('%s-images-idx3-ubyte.gz' % prefix),
                   rng.integers(0, 256, (n, 28, 28)), 2051)
        _write_idx(tmp_path / ('%s-labels-idx1-ubyte.gz' % prefix),
                   rng.integers(0, 10, (n,)), 2049)
    jscope, tscope = _both(data_dir_local=str(tmp_path))
    with jscope, tscope:
        jimg, jlab = J(is_train)._load_arrays()
        tds = T(is_train)
        timg, tlab = tds._load_arrays()
    assert timg.shape == ((12 if is_train else 5), 28, 28, 1)
    np.testing.assert_array_equal(timg, np.asarray(jimg))
    np.testing.assert_array_equal(tlab, np.asarray(jlab))
    want = np.asarray(J(is_train).augment(jnp.asarray(jimg), jax.random.PRNGKey(0), is_train))
    np.testing.assert_array_equal(tds.augment(torch.from_numpy(timg.copy()), None,
                                              is_train).numpy(), want)


@pytest.mark.parametrize('dataset,is_train,snr,noise', [
    ('cifar10', True, 0.25, 0.1), ('cifar10', False, 0.25, 0.1), ('fmnist', True, 0.5, 0.3)])
def test_hard_synthetic_task_matches_jax(dataset, is_train, snr, noise):
    if dataset == 'cifar10':
        from pocketflow_tpu.datasets.cifar10 import Cifar10Dataset as J
        from pocketflow_tpu_torch.datasets.cifar10 import Cifar10Dataset as T
    else:
        from pocketflow_tpu.datasets.fmnist import FMnistDataset as J
        from pocketflow_tpu_torch.datasets.fmnist import FMnistDataset as T
    jscope, tscope = _both(synthetic_task='hard', synthetic_snr=snr,
                           synthetic_label_noise=noise, nb_smpls_train=100, nb_smpls_eval=70)
    with jscope, tscope:
        jimg, jlab = J(is_train).synthesize_arrays()
        timg, tlab = T(is_train).synthesize_arrays()
    assert timg.dtype == np.uint8 and tlab.dtype == np.int32
    np.testing.assert_array_equal(timg, jimg)
    np.testing.assert_array_equal(tlab, jlab)


def test_pad_random_crop_matches_jax_on_the_same_offsets():
    from pocketflow_tpu.datasets import augment as ja
    from pocketflow_tpu_torch.datasets import augment as ta
    images = np.random.default_rng(5).normal(size=(6, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    offsets = np.array(jax.random.randint(key, (2, 6), 0, 9))
    want = np.asarray(ja.pad_random_crop(jnp.asarray(images), key, pad=4))
    got = ta.pad_random_crop(torch.from_numpy(images), None, pad=4,
                             offsets=torch.from_numpy(offsets))
    np.testing.assert_array_equal(got.numpy(), want)
    drawn = ta.pad_random_crop(torch.from_numpy(images), torch.Generator().manual_seed(0))
    assert drawn.shape == images.shape


@pytest.mark.parametrize('mode,size', [('mild', 40), ('inception', 32)])
def test_ilsvrc12_train_augment_matches_jax_without_flip(monkeypatch, mode, size):
    """'mild' center-crops and resizes a frame of another size; 'inception'
    at the output size takes no crop; with the flip off on both sides, both
    equal the JAX augment."""
    from pocketflow_tpu.datasets import augment as ja
    from pocketflow_tpu.datasets.ilsvrc12 import Ilsvrc12Dataset as J
    from pocketflow_tpu_torch.datasets import augment as ta
    from pocketflow_tpu_torch.datasets.ilsvrc12 import Ilsvrc12Dataset as T
    monkeypatch.setattr(ja, 'random_flip_lr', lambda images, rng: images)
    monkeypatch.setattr(ta, 'random_flip_lr', lambda images, gen: images)
    images = np.random.default_rng(6).integers(0, 256, (3, size, size, 3)).astype(np.uint8)
    jscope, tscope = _both(ilsvrc_image_size=32, ilsvrc_augment=mode, synthetic_data=True)
    with jscope, tscope:
        want = np.asarray(J(True).augment(jnp.asarray(images), jax.random.PRNGKey(0), True))
        got = T(True).augment(torch.from_numpy(images), torch.Generator().manual_seed(0), True)
    assert got.shape == (3, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_ilsvrc12_inception_augment_takes_a_random_crop(monkeypatch):
    from pocketflow_tpu_torch.datasets import augment as ta
    from pocketflow_tpu_torch.datasets.ilsvrc12 import Ilsvrc12Dataset as T
    calls = []
    crop = ta.random_crop_resize
    monkeypatch.setattr(ta, 'random_crop_resize', lambda *a, **k: calls.append(1) or crop(*a, **k))
    images = torch.from_numpy(
        np.random.default_rng(7).integers(0, 256, (2, 40, 40, 3)).astype(np.uint8))
    with TFLAGS.scope(ilsvrc_image_size=32, synthetic_data=True):
        out = T(True).augment(images, torch.Generator().manual_seed(0), True)
        with TFLAGS.scope(ilsvrc_augment='mild'):
            T(True).augment(images, torch.Generator().manual_seed(0), True)
    assert out.shape == (2, 32, 32, 3) and calls == [1]


def test_path_conf_sets_data_dir_and_an_explicit_flag_wins(minimal, tmp_path, monkeypatch):
    """main.py applies the model's dataset entry of --path_conf: CIFAR-10
    read from the configured directory (20 train records there, against 10
    in the one given by flag)."""
    from pocketflow_tpu_torch import main as port_main
    from pocketflow_tpu_torch.tools import make_minimal_data as tmake
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    tmake.main(['--dst_dir=%s' % (tmp_path / 'other'), '--datasets=cifar10',
                '--nb_train=10', '--nb_eval=6'])
    conf = tmp_path / 'path.conf'
    conf.write_text('# test\ndata_disk = local\ndata_hdfs_host =\n'
                    'data_dir_local_cifar10 = %s\ndata_dir_local_ilsvrc12 = /nowhere\n'
                    % (minimal / 'port' / 'cifar10'))
    common = ['--model=resnet_at_cifar10', '--learner=full-prec', '--path_conf=%s' % conf,
              '--batch_size=4', '--batch_size_eval=6', '--nb_smpls_train=4',
              '--nb_epochs_rat=0.004', '--compute_dtype=float32',
              '--log_dir=%s' % (tmp_path / 'logs'),
              '--save_path=%s' % (tmp_path / 'models' / 'model.ckpt')]
    learner = port_main.main(common, device='cpu')
    assert TFLAGS.data_dir_local == str(minimal / 'port' / 'cifar10')
    assert learner.dataset_train.nb_smpls_loaded == 20
    with TFLAGS.scope(data_dir_local=None):
        learner = port_main.main(common + ['--data_dir_local=%s' % (tmp_path / 'other' / 'cifar10')],
                                 device='cpu')
        assert learner.dataset_train.nb_smpls_loaded == 10
