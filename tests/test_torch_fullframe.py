"""Full-frame ILSVRC-12 shards in the port against the JAX package, on the CPU.

* ``center_crop_resize`` with ``valid_hw`` against JAX's (uint8 within 1,
  fp32 within 1e-5), extents below 2 and above the array clamped;
* ``random_crop_resize`` with ``valid_hw`` at the draws JAX's generator
  makes (area, aspect, row and column offsets), injected into the port's
  (the same tolerances);
* the property of JAX's tests/test_datasets.py:165 with the port's
  generator: no output pixel reads past a sample's extent;
* the dataset: [class, valid_h, valid_w] label rows, unpacked on the device
  into int classes, through augment_xy in train and eval;
* end to end: a 16-sample full-frame shard set at --ilsvrc_image_size=64,
  the port's main.main training from it, then the eval of one bridged
  checkpoint (ResNet-18, fp32) through both packages' main.main: the same
  loss within 1e-5 relative and the same top-1.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pocketflow_tpu.nets.resnet_at_ilsvrc12  # noqa: F401  (registers the JAX flags)
import pocketflow_tpu_torch.nets.resnet_at_ilsvrc12  # noqa: F401
from pocketflow_tpu.config import FLAGS as JFLAGS
from pocketflow_tpu.datasets import augment as jaug
from pocketflow_tpu_torch import main as port_main
from pocketflow_tpu_torch.config import FLAGS as TFLAGS
from pocketflow_tpu_torch.datasets import augment as taug

torch.set_num_threads(2)
port_main.register_flags()  # so that each test's scope restores every flag main() parses
RESIZE = 72  # the shards' container: 72 x 96


@pytest.fixture(autouse=True)
def _port_flags(monkeypatch):
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    with TFLAGS.scope(**TFLAGS.as_dict()):
        yield


def _images(dtype, batch=6, height=20, width=27, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (batch, height, width, 3)).astype(np.uint8)
    return images if dtype == 'uint8' else images.astype(np.float32) * 0.731


# extents: inside, the whole array, below 2 and past the array (clamped)
VALID_HW = np.array([[13, 21], [20, 27], [1, 9], [30, 40], [7, 2.5], [19.5, 26.25]],
                    np.float32)


def _assert_close(got, want, dtype):
    got = got.numpy().astype(np.float64)
    want = np.asarray(want).astype(np.float64)
    assert got.shape == want.shape
    if dtype == 'uint8':
        assert np.abs(got - want).max() <= 1
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize('dtype', ['uint8', 'float32'])
def test_center_crop_resize_with_extents_matches_jax(dtype):
    images = _images(dtype)
    want = jaug.center_crop_resize(jnp.asarray(images), (11, 9), valid_hw=jnp.asarray(VALID_HW))
    got = taug.center_crop_resize(torch.from_numpy(images), (11, 9),
                                  valid_hw=torch.from_numpy(VALID_HW))
    _assert_close(got, want, dtype)
    # without extents, as before
    _assert_close(taug.center_crop_resize(torch.from_numpy(images), (11, 9)),
                  jaug.center_crop_resize(jnp.asarray(images), (11, 9)), dtype)


def _jax_draws(key, batch, area_range=(0.08, 1.0), aspect_range=(3 / 4, 4 / 3)):
    """The draws JAX's random_crop_resize makes from `key`: area, aspect,
    the unit row and column offsets."""
    k_area, k_aspect, k_oy, k_ox = jax.random.split(key, 4)
    area = jax.random.uniform(k_area, (batch,), minval=area_range[0], maxval=area_range[1])
    aspect = jnp.exp(jax.random.uniform(k_aspect, (batch,), minval=jnp.log(aspect_range[0]),
                                        maxval=jnp.log(aspect_range[1])))
    return np.stack([np.asarray(v) for v in (area, aspect, jax.random.uniform(k_oy, (batch,)),
                                             jax.random.uniform(k_ox, (batch,)))])


@pytest.mark.parametrize('dtype', ['uint8', 'float32'])
@pytest.mark.parametrize('extents', [True, False])
def test_random_crop_resize_at_jax_draws_matches_jax(dtype, extents):
    images = _images(dtype, seed=1)
    valid_hw = VALID_HW if extents else None
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = jaug.random_crop_resize(
            jnp.asarray(images), key, (10, 12),
            valid_hw=None if valid_hw is None else jnp.asarray(valid_hw))
        got = taug.random_crop_resize(
            torch.from_numpy(images), None, (10, 12),
            valid_hw=None if valid_hw is None else torch.from_numpy(valid_hw),
            draws=torch.from_numpy(_jax_draws(key, len(images))))
        _assert_close(got, want, dtype)


def test_random_crop_resize_never_reads_past_the_extent():
    """A frame of 100 inside its extent and 255 in the padding: every output
    pixel stays 100, whatever the generator draws."""
    rng = np.random.default_rng(2)
    batch, height, width = 16, 48, 64
    valid = np.stack([rng.integers(2, height + 1, batch),
                      rng.integers(2, width + 1, batch)], axis=1).astype(np.float32)
    images = np.full((batch, height, width, 3), 255, np.float32)
    for i, (vh, vw) in enumerate(valid.astype(int)):
        images[i, :vh, :vw] = 100.0
    for seed in range(8):
        out = taug.random_crop_resize(torch.from_numpy(images),
                                      torch.Generator().manual_seed(seed), (16, 16),
                                      valid_hw=torch.from_numpy(valid))
        assert float((out - 100.0).abs().max()) < 1e-3, seed
        as_uint8 = taug.random_crop_resize(torch.from_numpy(images).to(torch.uint8),
                                           torch.Generator().manual_seed(seed), (16, 16),
                                           valid_hw=torch.from_numpy(valid))
        assert int(as_uint8.min()) >= 99 and int(as_uint8.max()) <= 100
    center = taug.center_crop_resize(torch.from_numpy(images), (16, 16),
                                     valid_hw=torch.from_numpy(valid))
    assert float((center - 100.0).abs().max()) < 1e-3


def test_augment_xy_unpacks_extent_rows():
    from pocketflow_tpu_torch.datasets.ilsvrc12 import Ilsvrc12Dataset
    with TFLAGS.scope(batch_size=2, synthetic_data=True):
        dataset = Ilsvrc12Dataset(is_train=True)
    packed = {'image': torch.zeros((2, 48, 64, 3), dtype=torch.uint8),
              'label': torch.tensor([[7.0, 40.0, 30.0], [3.0, 48.0, 64.0]])}
    for is_train in (True, False):
        images, labels = dataset.augment_xy(packed, torch.Generator().manual_seed(0), is_train)
        assert labels.dtype == torch.int32 and labels.tolist() == [7, 3]
        assert images.shape == (2, 224, 224, 3)
    plain = {'image': torch.zeros((2, 224, 224, 3), dtype=torch.uint8),
             'label': torch.tensor([1, 2], dtype=torch.int32)}
    assert dataset.augment_xy(plain, torch.Generator().manual_seed(0), True)[1].tolist() == [1, 2]


def _write_full_frame_shards(root, nb_train=16, nb_val=16, seed=0):
    """Full-frame shards written with the converter's own writer: frames of
    aspect 3:4 to 16:9 fitted into the container as process_pil_image fits
    them, zero padding, [valid_h, valid_w] extents."""
    from pocketflow_tpu_torch.tools import convert_ilsvrc12 as cv
    rng = np.random.default_rng(seed)
    width = cv.container_width(RESIZE)
    for subset, nb in (('train', nb_train), ('val', nb_val)):
        images, labels, extents = [], [], []
        for _ in range(nb):
            aspect = rng.uniform(3 / 4, 16 / 9)  # w / h
            scale = min(RESIZE / 1.0, width / aspect)
            vh, vw = int(round(min(RESIZE, scale))), int(round(min(width, scale * aspect)))
            frame = np.zeros((RESIZE, width, 3), np.uint8)
            frame[:vh, :vw] = rng.integers(0, 256, (vh, vw, 3), dtype=np.uint8)
            images.append(frame)
            labels.append(int(rng.integers(1, 1001)))
            extents.append((vh, vw))
        cv._flush(str(root), subset, 0, images, labels, extents)


def _argv(tmp_path, shards, name):
    return ['--model=resnet_at_ilsvrc12', '--resnet_size=18', '--learner=full-prec',
            '--data_dir_local=%s' % shards, '--ilsvrc_image_size=64', '--batch_size=8',
            '--batch_size_eval=8', '--nb_smpls_eval=16', '--compute_dtype=float32',
            '--log_dir=%s' % (tmp_path / name / 'logs'),
            '--save_path=%s' % (tmp_path / name / 'models' / 'model.ckpt')]


def test_main_trains_and_evaluates_full_frame_shards_as_jax(tmp_path, monkeypatch):
    import main as jmain
    from pocketflow_tpu.learners import create_learner as jcreate
    from pocketflow_tpu.learners.full_precision import FullPrecLearner as JLearner
    from pocketflow_tpu.nets.resnet_at_ilsvrc12 import ModelHelper as JHelper
    from pocketflow_tpu_torch.core.bridge import load_jax_numpy
    from pocketflow_tpu_torch.learners import create_learner as tcreate
    from pocketflow_tpu_torch.learners.full_precision import FullPrecLearner as TLearner
    from pocketflow_tpu_torch.nets.resnet_at_ilsvrc12 import ModelHelper as THelper
    shards = tmp_path / 'shards'
    shards.mkdir()
    _write_full_frame_shards(shards)

    # the port trains from the shards: 2 steps, native sampler, extent crops
    learner = port_main.main(_argv(tmp_path, shards, 'train') + ['--nb_smpls_train=16',
                                                                 '--nb_epochs_rat=0.01'],
                             device='cpu')
    assert learner.dataset_train.nb_smpls_loaded == 16 and learner.nb_iters_train == 2

    # one checkpoint in each package's format, of the same weights
    results = {}
    for cls, key in ((JLearner, 'jax'), (TLearner, 'port')):
        def recorded(self, _evaluate=cls.evaluate, _key=key):
            results[_key] = _evaluate(self)
            return results[_key]
        monkeypatch.setattr(cls, 'evaluate', recorded)
    jargv, targv = _argv(tmp_path, shards, 'jax'), _argv(tmp_path, shards, 'port')
    with JFLAGS.scope(**JFLAGS.as_dict()):
        JFLAGS.parse_args(jargv[1:] + ['--synthetic_data=False'])
        jlearner = jcreate(None, JHelper())
        jstate, _, _ = jlearner.init_state()
        jlearner.save_model(jstate)
        params, stats = jax.device_get((jstate.params, jstate.batch_stats))
        jmain.main(jargv + ['--exec_mode=eval', '--synthetic_data=False'])
    with TFLAGS.scope(**TFLAGS.as_dict()):
        port_main.register_flags()
        TFLAGS.parse_args(targv)
        tlearner = tcreate(None, THelper(), device='cpu')
        tstate, _, _ = tlearner.init_state()
        load_jax_numpy(tstate.model, params, stats)
        tlearner.save_model(tstate)
        port_main.main(targv + ['--exec_mode=eval'], device='cpu')
    want, got = results['jax'], results['port']
    assert np.isfinite(got['loss'])
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-5)
    assert got['accuracy'] == want['accuracy'] and got['accuracy_top5'] == want['accuracy_top5']
