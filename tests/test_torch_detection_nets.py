"""The port's detectors against the JAX package's on the CPU, in fp32, from
one set of parameters carried across by core/bridge.py (BN variables and
biases moved off their init), at 64x64:

* SSDVGG's (cls_logits, box_deltas) within rtol 1e-4 / atol 1e-5 of the
  largest; its module paths and shapes equal JAX's params, the L2Norm
  scale included;
* FasterRCNN (`small` and `resnet18` trunks): the eval forward's RPN
  outputs, proposals (validity exact), ROI boxes and head outputs within the
  same bound, with no patch; the train forward's sampled ROIs and targets
  with sample_rois' tie vector patched into both packages (JAX's
  jax.random.uniform vector, since the hash tie amplifies 1e-7 differences
  of a proposal into a different tie);
* both helpers' calc_loss on the JAX outputs within 1e-5 (SSD at a
  classification warm-up weight of 0.5);
* one full-precision train step of each (SSD-VGG @ 32, Faster R-CNN small
  @ 64 with the tie patched) within ROADMAP's step bound: rtol 1e-4,
  atol 1e-5 plus 2x the spread of JAX reruns (images or parameters
  perturbed by 1e-7, the batch reversed);
* the quantized weight paths equal to JAX's, path for path (Faster R-CNN
  lists the shared RPN convs once per level; SSD-300's last kernel is
  box_head_5), and the relu site counts;
* restore_intersecting: a ResNet-18 classification checkpoint grafted
  under backbone/ of a ResNet-18 Faster R-CNN, the same count as JAX's and
  the same values;
* the channel pruner's specs on Faster R-CNN equal JAX's (rpn_conv twice,
  each with the last call's input; where JAX infers 'VALID' from the two
  calls' mixed shapes the port keeps the conv's own 'SAME'), and its sampler
  takes rpn_conv's last call;

main.main runs the detectors in tests/test_torch_detection_main.py.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocketflow_tpu.config import FLAGS as JFLAGS
from pocketflow_tpu.core import mesh as mesh_lib
from pocketflow_tpu.nets.detection import faster_rcnn as jfr
from pocketflow_tpu_torch.config import FLAGS as TFLAGS
from pocketflow_tpu_torch.core.bridge import load_jax_numpy
from pocketflow_tpu_torch.nets.detection import faster_rcnn as tfr
from torch_step_parity import jax_runs, moved_past_bound, out_of_bound

torch.set_num_threads(2)
T = torch.from_numpy
IMAGE = 64
FRCNN_FLAGS = dict(frcnn_nb_proposals=16, frcnn_nb_pre_nms=64, frcnn_roi_batch=8,
                   nb_bboxs_max=6)
TIE_KEY = 11


@pytest.fixture(autouse=True)
def _port_flags():
    with TFLAGS.scope(**TFLAGS.as_dict()):
        yield


def _both(**flags):
    return JFLAGS.scope(**flags), TFLAGS.scope(**flags)


def _moved(variables, seed=1):
    """Biases, BN scales/biases and statistics off their init (numpy)."""
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        name = jax.tree_util.keystr(path)
        leaf = np.array(leaf, np.float32)
        if "'bias'" in name or "'mean'" in name:
            return (leaf + 0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if ("'scale'" in name and "l2norm" not in name) or "'var'" in name:
            return (leaf * (1 + 0.1 * rng.uniform(size=leaf.shape))).astype(np.float32)
        return leaf
    return jax.tree_util.tree_map_with_path(move, jax.device_get(variables))


def _images_labels(nb, size=IMAGE, nb_max=6):
    from pocketflow_tpu_torch.datasets.pascalvoc import PascalVocDataset
    with TFLAGS.scope(voc_image_size=size, nb_bboxs_max=nb_max):
        images, labels = PascalVocDataset(True).synthesize_detection_arrays(64)
    mean = np.asarray([123.0, 117.0, 104.0], np.float32)
    return (images[:nb].astype(np.float32) - mean), labels[:nb]


def _close(got, want, what, rtol=1e-4, atol=1e-5):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = atol * max(1.0, float(np.abs(want).max())) + rtol * np.abs(want)
    err = np.abs(got - want)
    assert (err <= bound).all(), (what, float(err.max()), float((err - bound).max()))


# ---------------------------------------------------------------------------
# SSD-VGG
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def ssd():
    from pocketflow_tpu.nets.vgg import SSDVGG as J
    from pocketflow_tpu_torch.nets.vgg import SSDVGG as P
    jm = J(nb_classes=21, nb_anchors_per_cell=4, dtype=jnp.float32)
    x, labels = _images_labels(2)
    variables = _moved(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    tm = P(IMAGE, nb_classes=21, nb_anchors_per_cell=4, dtype=torch.float32)
    load_jax_numpy(tm, variables['params'], variables.get('batch_stats', {}))
    want = jm.apply(variables, jnp.asarray(x), train=False)
    return dict(jm=jm, variables=variables, tm=tm, x=x, labels=labels, want=want)


def test_ssd_forward_matches_jax(ssd):
    with torch.no_grad():
        got = ssd['tm'].eval()(T(ssd['x']))
    assert got[0].shape == (2, sum(4 * s * s for s in (8, 4, 2, 1)), 21)
    _close(got[0].numpy(), ssd['want'][0], 'cls_logits')
    _close(got[1].numpy(), ssd['want'][1], 'box_deltas')
    params = {k: tuple(v.shape) for k, v in ssd['tm'].state_dict().items()}
    assert params['l2norm_conv4_3.scale'] == (512,)
    assert 'vgg.conv6.kernel' in params and 'conv9_2.kernel' in params


def test_ssd_init_draws():
    from pocketflow_tpu_torch.nets.vgg import SSDVGG
    tm = SSDVGG(IMAGE, dtype=torch.float32)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    k = tm.vgg.conv1_1.kernel
    limit = np.sqrt(6.0 / (9 * 3 + 9 * 64))
    assert float(k.abs().max()) <= limit and float(k.abs().max()) > 0.9 * limit
    head = tm.cls_head_0.kernel
    assert abs(float(head.std()) - 0.01) < 1e-3
    assert torch.equal(tm.l2norm_conv4_3.scale, torch.full((512,), 20.0))


def test_ssd_calc_loss_matches_jax(ssd):
    from pocketflow_tpu.nets.vgg_at_pascalvoc import ModelHelper as JH
    from pocketflow_tpu_torch.nets.vgg_at_pascalvoc import ModelHelper as TH
    jscope, tscope = _both(voc_image_size=IMAGE, nb_bboxs_max=6, nb_iters_cls_wmup=4)
    with jscope, tscope:
        jh, th = JH(), TH()
        outs = [np.asarray(o) for o in ssd['want']]
        for step in (None, 2):
            jl, jm = jh.calc_loss(jnp.asarray(ssd['labels']), tuple(map(jnp.asarray, outs)),
                                  ssd['variables']['params'],
                                  step=None if step is None else jnp.asarray(step))
            named = [(k.replace('.', '/'), v) for k, v in ssd['tm'].named_parameters()]
            tl, tm = th.calc_loss(T(ssd['labels']), tuple(map(T, outs)), named, step=step)
            assert abs(float(tl) - float(jl)) <= 1e-5 * max(1.0, abs(float(jl)))
            for key, value in jm.items():
                assert abs(float(tm[key]) - float(value)) <= 1e-5 * max(1.0, abs(float(value)))


# ---------------------------------------------------------------------------
# Faster R-CNN
# ---------------------------------------------------------------------------

def _patch_tie(monkeypatch):
    """sample_rois' tie in both packages: JAX's uniform vector of TIE_KEY."""
    key = jax.random.PRNGKey(TIE_KEY)
    sample = jfr.sample_rois

    def jax_sample(proposals, valid, gt_boxes, gt_classes, gt_valid, rng, *args, **kwargs):
        return sample(proposals, valid, gt_boxes, gt_classes, gt_valid, key, *args, **kwargs)

    def port_tie(pool):
        tie = np.asarray(jax.random.uniform(key, (pool.shape[1],)))
        return T(tie).to(pool.device).expand(pool.shape[0], -1)
    monkeypatch.setattr(jfr, 'sample_rois', jax_sample)
    monkeypatch.setattr(tfr, 'tie_hash', port_tie)


@functools.lru_cache(maxsize=None)
def _build_frcnn(name):
    """(JAX model, its calibrated variables, the port model, images, labels,
    the JAX eval outputs) of a Faster R-CNN with the `name` trunk, built once."""
    from pocketflow_tpu.nets.faster_rcnn_at_pascalvoc import FasterRCNN as J
    from pocketflow_tpu_torch.nets.faster_rcnn_at_pascalvoc import FasterRCNN as P
    jscope, tscope = _both(**FRCNN_FLAGS)
    with jscope, tscope:
        jm = J(nb_classes=21, backbone_name=name, dtype=jnp.float32)
        x, labels = _images_labels(2)
        variables = _moved(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), labels=None,
                                   train=False))
        tm = P(nb_classes=21, backbone_name=name, dtype=torch.float32)
        load_jax_numpy(tm, variables['params'], variables['batch_stats'])
        variables = _calibrated(tm, x)
        want = jm.apply(variables, jnp.asarray(x), labels=None, train=False)
    return dict(name=name, jm=jm, variables=variables, tm=tm, x=x, labels=labels,
                want=jax.device_get(want))


@pytest.fixture(scope='module', params=['small', 'resnet18'])
def frcnn(request):
    return _build_frcnn(request.param)


def _calibrated(tm, x):
    """The BN running statistics set to the batch's (one train-mode forward
    at momentum 0), so that the eval forward stays at unit scale through the
    trunk; returns the model's variables as the JAX package's trees."""
    from pocketflow_tpu_torch.core.bridge import to_jax_numpy
    from pocketflow_tpu_torch.nn.layers import BatchNorm
    bns = [m for m in tm.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.momentum = 0.0
    with torch.no_grad():
        tm.train()(T(x))
    for bn in bns:
        bn.momentum = 0.997
    params, stats = to_jax_numpy(tm)
    return {'params': params, 'batch_stats': stats}


def _compare_outputs(got, want, keys):
    for key in keys:
        if key == 'proposal_valid':
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
        elif key in ('roi_cls_targets',):
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
        else:
            _close(got[key].detach().numpy(), want[key], key)


def test_frcnn_eval_forward_matches_jax(frcnn):
    with TFLAGS.scope(**FRCNN_FLAGS), torch.no_grad():
        got = frcnn['tm'].eval()(T(frcnn['x']))
    assert got['cls_logits'].shape == (2, 16, 21)
    _compare_outputs(got, frcnn['want'], ('anchors', 'obj_logits', 'rpn_deltas', 'proposals',
                                          'proposal_valid', 'roi_boxes', 'cls_logits',
                                          'box_deltas'))


def test_frcnn_train_forward_matches_jax_with_the_tie_patched(frcnn, monkeypatch):
    _patch_tie(monkeypatch)
    with JFLAGS.scope(**FRCNN_FLAGS):
        want, _ = frcnn['jm'].apply(frcnn['variables'], jnp.asarray(frcnn['x']),
                                    labels=jnp.asarray(frcnn['labels']), train=True,
                                    mutable=['batch_stats'])
    tm = copy.deepcopy(frcnn['tm']).train()
    got = tm(T(frcnn['x']), labels=T(frcnn['labels']))
    assert got['cls_logits'].shape == (2, 8, 21)
    _compare_outputs(got, jax.device_get(want), (
        'proposals', 'proposal_valid', 'roi_boxes', 'roi_cls_targets', 'roi_box_targets',
        'roi_fg', 'roi_valid', 'cls_logits', 'box_deltas'))


def test_frcnn_calc_loss_matches_jax(frcnn):
    from pocketflow_tpu.nets.faster_rcnn_at_pascalvoc import ModelHelper as JH
    from pocketflow_tpu_torch.nets.faster_rcnn_at_pascalvoc import ModelHelper as TH
    jscope, tscope = _both(voc_image_size=IMAGE, **FRCNN_FLAGS)
    with jscope, tscope:
        outs = {k: np.asarray(v) for k, v in frcnn['want'].items()}
        jl, jm = JH().calc_loss(jnp.asarray(frcnn['labels']),
                                {k: jnp.asarray(v) for k, v in outs.items()},
                                frcnn['variables']['params'])
        named = [(k.replace('.', '/'), v) for k, v in frcnn['tm'].named_parameters()]
        tl, tm = TH().calc_loss(T(frcnn['labels']), {k: T(v) for k, v in outs.items()}, named)
    assert set(tm) == set(jm)
    assert abs(float(tl) - float(jl)) <= 1e-5 * max(1.0, abs(float(jl)))
    for key, value in jm.items():
        assert abs(float(tm[key]) - float(value)) <= 1e-5 * max(1.0, abs(float(value))), key


# ---------------------------------------------------------------------------
# quant sites, warm start, the pruner's specs
# ---------------------------------------------------------------------------

def test_quant_weight_paths_match_jax(ssd, frcnn):
    from pocketflow_tpu.learners.uniform_quantization import utils as juq
    from pocketflow_tpu_torch.learners.uniform_quantization import utils as tuq
    for case, flags in ((ssd, {}), (frcnn, FRCNN_FLAGS)):
        jscope, tscope = _both(**flags)
        with jscope, tscope:
            jsites = juq.discover_quant_sites(case['jm'], case['variables'], jnp.asarray(case['x']))
            tsites = tuq.discover_quant_sites(case['tm'], T(case['x']))
        assert tsites['weight_paths'] == jsites['weight_paths']
        assert tsites['weight_shapes'] == [tuple(s) for s in jsites['weight_shapes']]
        assert tsites['nb_activations'] == jsites['nb_activations']
    paths = tsites['weight_paths']  # Faster R-CNN, first and last left out
    assert paths.count('rpn_conv') == paths.count('rpn_obj') == 2
    assert paths[0] != 'backbone/conv_init' and paths[-1] == 'cls_head'


def test_ssd300_weight_paths():
    """At 300x300 (on the meta device: shapes only) the 6 scales' heads;
    box_head_5 is the last kernel in trace order, so uniform leaves it full
    precision."""
    from pocketflow_tpu_torch.learners.uniform_quantization import utils as tuq
    from pocketflow_tpu_torch.nets.vgg import SSDVGG
    with TFLAGS.scope(uql_quantize_all_layers=True):
        sites = tuq.discover_quant_sites(SSDVGG(300, dtype=torch.float32).to('meta'),
                                         torch.empty(1, 300, 300, 3, device='meta'))
    assert sites['weight_paths'][-2:] == ['cls_head_5', 'box_head_5']
    assert sites['nb_matmuls'] == 15 + 8 + 12 and sites['nb_activations'] == 15 + 8


def test_restore_intersecting_matches_jax(tmp_path):
    from pocketflow_tpu.core import checkpoint as jckpt
    from pocketflow_tpu.nets.faster_rcnn_at_pascalvoc import FasterRCNN as JF
    from pocketflow_tpu.nets.resnet import ResNetImageNet as JR
    from pocketflow_tpu_torch.core import checkpoint as tckpt
    from pocketflow_tpu_torch.nets.faster_rcnn_at_pascalvoc import FasterRCNN as TF
    from pocketflow_tpu_torch.nets.resnet import ResNetImageNet as TR
    x = jnp.zeros((1, IMAGE, IMAGE, 3), jnp.float32)
    cls_vars = JR(resnet_size=18, nb_classes=1001, dtype=jnp.float32).init(
        jax.random.PRNGKey(1), x, train=False)
    jckpt.save(str(tmp_path / 'jax' / 'model.ckpt'), {'params': cls_vars['params']}, 0)
    port_cls = TR(resnet_size=18, nb_classes=1001, dtype=torch.float32)
    load_jax_numpy(port_cls, cls_vars['params'], cls_vars['batch_stats'])
    tckpt.save(str(tmp_path / 'port' / 'model.ckpt'), {'step': 0, 'model': port_cls.state_dict()},
               0)
    jscope, tscope = _both(**FRCNN_FLAGS)
    with jscope, tscope:
        det_vars = JF(nb_classes=21, backbone_name='resnet18', dtype=jnp.float32).init(
            jax.random.PRNGKey(2), x, labels=None, train=False)
        _, jcount = jckpt.restore_intersecting(str(tmp_path / 'jax' / 'model.ckpt'),
                                               det_vars['params'], prefix_map={'': 'backbone/'})
        det = TF(nb_classes=21, backbone_name='resnet18', dtype=torch.float32)
    load_jax_numpy(det, det_vars['params'], det_vars['batch_stats'])
    count = tckpt.restore_intersecting(str(tmp_path / 'port' / 'model.ckpt'), det,
                                       prefix_map={'': 'backbone/'})
    assert count == jcount and count > 40
    assert torch.equal(det.backbone.stage3_block1.conv2.kernel,
                       port_cls.stage3_block1.conv2.kernel)
    assert not torch.equal(det.lateral0.kernel, torch.zeros_like(det.lateral0.kernel))
    assert tckpt.restore_intersecting(str(tmp_path / 'none' / 'model.ckpt'), det) == 0


def test_pruner_specs_on_frcnn_match_jax():
    from pocketflow_tpu.learners.channel_pruning import channel_pruner as jcp
    from pocketflow_tpu_torch.learners.channel_pruning import channel_pruner as tcp
    frcnn = _build_frcnn('small')
    with JFLAGS.scope(**FRCNN_FLAGS), TFLAGS.scope(**FRCNN_FLAGS, cp_nb_points_per_layer=3):
        want = jcp.conv_layer_specs(frcnn['jm'], frcnn['variables']['params'],
                                    frcnn['variables']['batch_stats'], jnp.asarray(frcnn['x']))
        got = tcp.conv_layer_specs(frcnn['tm'], T(frcnn['x']))
        assert [s['path'] for s in got] == [s['path'] for s in want]
        for g, w in zip(got, want):
            for key in ('kernel_shape', 'in_shape', 'out_shape', 'flops'):
                assert tuple(np.ravel(g[key])) == tuple(np.ravel(w[key])), (g['path'], key)
            mixed = g['in_shape'][1] != g['out_shape'][1] * g['strides'][0]
            if not mixed:
                assert (g['strides'], g['padding']) == (tuple(w['strides']), w['padding'])
        # rpn_conv's first spec pairs the last call's input (level 1) with the
        # first call's output (level 0): JAX infers stride 1 'VALID' from those
        # shapes and would sample X 'VALID'-padded against Y of a 'SAME' conv;
        # the port keeps the conv's own stride and padding
        first = next(w for w in want if w['path'] == 'rpn_conv')
        assert first['padding'] == 'VALID'
        assert all(s['padding'] == 'SAME' and s['strides'] == (1, 1)
                   for s in got if s['path'] == 'rpn_conv')
        rpn = [s for s in got if s['path'] == 'rpn_conv']
        assert len(rpn) == 2 and all(s['nb_calls'] == 2 for s in rpn)
        assert rpn[0]['in_shape'] == rpn[1]['in_shape'] == rpn[1]['out_shape']

        class _Images:
            @staticmethod
            def augment_images(batch, generator, is_train):
                return batch['image']
        pruner = tcp.ChannelPruner(_Images, got)
        X, Y = pruner.sample(rpn[0], frcnn['tm'], frcnn['tm'], {'image': T(frcnn['x'])},
                             torch.Generator().manual_seed(0))
    # the last call: level 1 (stride 16), 4x4 at 64; X reproduces Y
    w = frcnn['tm'].rpn_conv.kernel.detach()
    y = torch.einsum('pchw,hwco->po', X, w)
    np.testing.assert_allclose(y.numpy(), Y.numpy(), rtol=1e-4, atol=1e-4)
    assert rpn[0]['in_shape'][1] == 4


# ---------------------------------------------------------------------------
# one train step of each detector against the JAX step
# ---------------------------------------------------------------------------

def _step_case(jhelper_cls, thelper_cls, flags, nb_img, start_step=0):
    from pocketflow_tpu.learners.full_precision import FullPrecLearner as JL
    from pocketflow_tpu_torch.learners.full_precision import FullPrecLearner as TL
    mesh_lib.set_global_mesh(mesh_lib.build_mesh(jax.devices()[:1], ('data',), (1,)))
    try:
        jscope, tscope = _both(**flags)
        with jscope, tscope:
            jl, tl = JL(None, jhelper_cls(), enbl_dst=False), TL(None, thelper_cls(), device='cpu')
            for learner in (jl, tl):
                cls = type(learner.dataset_train)
                ds = learner.dataset_train
                ds.augment_xy = (lambda d, c: lambda b, r, t: c.augment_xy(d, b, r, False))(ds, cls)
            jstate, jtx, _ = jl.init_state()
            tstate, ttx, _ = tl.init_state()
            params0 = jax.tree_util.tree_map(np.array, jax.device_get(jstate.params))
            stats0 = jax.tree_util.tree_map(np.array, jax.device_get(jstate.batch_stats))
            images, labels = jl.dataset_train.synthesize_detection_arrays(64)
            images, labels = images[:nb_img].astype(np.float32), labels[:nb_img]
            jstep = jl.build_train_step(jtx)
            opt0 = jax.device_get(jl.init_opt_state(jtx, params0))

            def jax_step(snapshot, imgs, labs):
                state = jstate.replace(
                    step=jnp.asarray(start_step, jnp.int32),
                    params=jax.tree_util.tree_map(jnp.asarray, snapshot['params']),
                    batch_stats=jax.tree_util.tree_map(jnp.asarray, stats0),
                    opt_state=jax.tree_util.tree_map(jnp.asarray, opt0))
                state, _ = jstep(state, {'image': jnp.asarray(imgs), 'label': jnp.asarray(labs)},
                                 jax.random.PRNGKey(0))
                out = {}
                for tree in (state.params, state.batch_stats):
                    out.update(_flat(jax.device_get(tree)))
                return out

            want, reruns = jax_runs(jax_step, {'params': params0}, images, labels)
            load_jax_numpy(tstate.model, params0, stats0)
            tstate.step = start_step
            tstep = tl.build_train_step(ttx)
            tstate, _ = tstep(tstate, tl.put_batch({'image': images, 'label': labels}), None)
            got = {k: v.detach().numpy() for k, v in tstate.params.items()}
            got.update({k: v.numpy() for k, v in tstate.batch_stats.items()})
            start = {**_flat(params0), **_flat(stats0)}
    finally:
        mesh_lib.reset_global_mesh()
    return want, reruns, got, start


def _flat(tree, prefix=''):
    out = {}
    for key, value in tree.items():
        path = '%s/%s' % (prefix, key) if prefix else key
        if isinstance(value, dict):
            out.update(_flat(value, path))
        else:
            out[path] = np.array(value)
    return out


def test_ssd_step_within_bound():
    from pocketflow_tpu.nets.vgg_at_pascalvoc import ModelHelper as JH
    from pocketflow_tpu_torch.nets.vgg_at_pascalvoc import ModelHelper as TH
    flags = dict(voc_image_size=32, batch_size=2, batch_size_eval=2, nb_smpls_train=64,
                 nb_smpls_eval=8, compute_dtype='float32', synthetic_data=True, rand_seed=0,
                 nb_bboxs_max=6, nb_iters_cls_wmup=2, lrn_rate_init=0.5)
    want, reruns, got, start = _step_case(JH, TH, flags, 2, start_step=1)
    assert not out_of_bound(want, reruns, got)
    assert moved_past_bound(start, want, reruns) > 0.5


def test_frcnn_step_within_bound(monkeypatch):
    from pocketflow_tpu.nets.faster_rcnn_at_pascalvoc import ModelHelper as JH
    from pocketflow_tpu_torch.nets.faster_rcnn_at_pascalvoc import ModelHelper as TH
    _patch_tie(monkeypatch)
    flags = dict(voc_image_size=IMAGE, batch_size=2, batch_size_eval=2, nb_smpls_train=64,
                 nb_smpls_eval=8, compute_dtype='float32', synthetic_data=True, rand_seed=0,
                 frcnn_backbone='small', lrn_rate_init=0.2, **FRCNN_FLAGS)
    want, reruns, got, start = _step_case(JH, TH, flags, 2)
    assert not out_of_bound(want, reruns, got)
    assert moved_past_bound(start, want, reruns) > 0.5
