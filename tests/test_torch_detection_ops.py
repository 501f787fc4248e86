"""The port's detection ops against the JAX package's on the CPU, on the same
numpy-seeded inputs (pocketflow_tpu_torch/datasets/pascalvoc.py and
nets/detection/*):

* the synthetic Pascal VOC arrays byte-equal (train and eval, default and
  harder settings); the eval augmentation equal, the train one's flip
  mirrors the boxes;
* generate_anchors equal, and SSD-300's 7,772 anchors from feature sizes
  [38, 19, 10, 5, 3, 2];
* match_anchors' classes and positives exactly equal, batched against JAX's
  per-image vmap, with two ground truths whose best anchors coincide and
  padded and difficult rows; its box targets within 1e-6 (XLA's log and
  its division by a constant round apart from torch's by an ulp);
* ssd_loss within 1e-5 and its gradient within 1e-6 with every negative's
  loss equal (the mining's stable tie order decides which get gradient);
* the host NMS, parse_detections and VOC AP (both AP modes, difficult
  boxes) exactly equal;
* Faster R-CNN: nms_fixed and propose's validity exactly equal (ties to the
  lower index; the boxes within 1e-6), roi_align within 1e-5 (XLA orders the
  bilinear products otherwise), rpn_targets, proposal_targets and, given
  JAX's tie vector, sample_rois: labels, indices and masks exactly equal,
  box targets within 1e-6 relative; the tie hash within 4e-3 of JAX's
  (mod 1); rpn_loss and rcnn_loss within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocketflow_tpu.config import FLAGS as JFLAGS
from pocketflow_tpu.nets.detection import anchors as janc
from pocketflow_tpu.nets.detection import faster_rcnn as jfr
from pocketflow_tpu.nets.detection import nms as jnms
from pocketflow_tpu.nets.detection import ssd_loss as jssd
from pocketflow_tpu.nets.detection import voc_eval as jvoc
from pocketflow_tpu_torch.config import FLAGS as TFLAGS
from pocketflow_tpu_torch.nets.detection import anchors as tanc
from pocketflow_tpu_torch.nets.detection import faster_rcnn as tfr
from pocketflow_tpu_torch.nets.detection import nms as tnms
from pocketflow_tpu_torch.nets.detection import ssd_loss as tssd
from pocketflow_tpu_torch.nets.detection import voc_eval as tvoc

torch.set_num_threads(2)
T = torch.from_numpy


def _both(**flags):
    return JFLAGS.scope(**flags), TFLAGS.scope(**flags)


def _random_boxes(rng, shape, lo=0.05, hi=0.35):
    centers = rng.uniform(0.15, 0.85, size=shape + (2,))
    half = rng.uniform(lo, hi, size=shape + (2,)) / 2
    return np.clip(np.concatenate([centers - half, centers + half], -1), 0, 1).astype(np.float32)


def _labels(rng, nb_img, nb_max, anchors=None):
    """[nb_img, nb_max, 6] labels: 1-3 ground truths an image, a padded
    tail; image 0 has two ground truths nested in one anchor (their best
    anchors coincide) and image 1 a difficult row."""
    labels = np.zeros((nb_img, nb_max, 6), np.float32)
    for i in range(nb_img):
        n = int(rng.integers(1, 4))
        labels[i, :n, 0] = rng.integers(1, 21, n)
        labels[i, :n, 1:5] = _random_boxes(rng, (n,))
        labels[i, :n, 5] = 1.0
    if anchors is not None:
        a = anchors[len(anchors) // 3]
        h, w = a[2] - a[0], a[3] - a[1]
        labels[0, 0, 1:5] = [a[0], a[1], a[0] + 0.9 * h, a[1] + 0.9 * w]
        labels[0, 1, 1:5] = [a[0] + 0.1 * h, a[1] + 0.1 * w, a[2], a[3]]
        labels[0, :2, 5] = 1.0
        labels[0, :2, 0] = [3, 7]
    labels[1, 3] = [5, 0.2, 0.2, 0.6, 0.6, -1.0]  # difficult
    return labels


# ---------------------------------------------------------------------------
# the dataset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('is_train,flags', [
    (True, {}), (False, {}),
    (True, dict(synthetic_det_noise=8.0, synthetic_det_amp=60.0, synthetic_det_min_div=6))])
def test_synthetic_arrays_byte_equal(is_train, flags):
    from pocketflow_tpu.datasets.pascalvoc import PascalVocDataset as J
    from pocketflow_tpu_torch.datasets.pascalvoc import PascalVocDataset as P
    jscope, tscope = _both(voc_image_size=48, nb_smpls_train=70, nb_smpls_eval=64,
                           nb_bboxs_max=8, **flags)
    with jscope, tscope:
        jimg, jlab = J(is_train).synthesize_detection_arrays()
        timg, tlab = P(is_train)._load_arrays()
    assert timg.shape == (70 if is_train else 64, 48, 48, 3) and timg.dtype == np.uint8
    assert timg.tobytes() == np.asarray(jimg).tobytes()
    assert tlab.dtype == np.float32 and tlab.tobytes() == np.asarray(jlab).tobytes()


def test_augment_eval_equal_and_train_flip_mirrors_boxes():
    from pocketflow_tpu.datasets.pascalvoc import PascalVocDataset as J
    from pocketflow_tpu_torch.datasets.pascalvoc import PascalVocDataset as P
    jscope, tscope = _both(voc_image_size=32, nb_bboxs_max=4)
    with jscope, tscope:
        jds, tds = J(False), P(False)
        images, labels = tds.synthesize_detection_arrays(64)
        batch = {'image': images[:4], 'label': labels[:4]}
        want = jds.augment_batch({k: jnp.asarray(v) for k, v in batch.items()},
                                 jax.random.PRNGKey(0), False)
        got = tds.augment_batch({k: T(v) for k, v in batch.items()}, None, False)
        np.testing.assert_array_equal(got['image'].numpy(), np.asarray(want['image']))
        np.testing.assert_array_equal(got['label'].numpy(), np.asarray(want['label']))
        out = tds.augment_batch({k: T(v) for k, v in batch.items()},
                                torch.Generator().manual_seed(0), True)
    lab = out['label'].numpy()
    flipped = lab[..., 2] != labels[:4, :, 2]
    flipped_img = flipped.any(axis=1)
    assert 0 < flipped_img.sum() < 4 or flipped_img.sum() in (0, 4)
    for i in range(4):
        valid = labels[i, :, 5] != 0
        if flipped_img[i]:
            np.testing.assert_allclose(lab[i, valid, 2], 1.0 - labels[i, valid, 4], atol=1e-7)
            np.testing.assert_allclose(lab[i, valid, 4], 1.0 - labels[i, valid, 2], atol=1e-7)
        np.testing.assert_array_equal(lab[i, :, [0, 1, 3, 5]], labels[i, :, [0, 1, 3, 5]])
    mean = np.asarray([123.0, 117.0, 104.0], np.float32)
    assert out['image'].min() >= -mean.max() - 1e-4 and out['image'].max() <= 255 - mean.min()


# ---------------------------------------------------------------------------
# anchors, matching, the SSD loss
# ---------------------------------------------------------------------------

def test_generate_anchors_equal_and_ssd300():
    from pocketflow_tpu.nets.vgg import SSDVGG as JSSD
    from pocketflow_tpu.nets.vgg_at_pascalvoc import SSD_ASPECTS, SSD_SCALES
    from pocketflow_tpu_torch.nets.vgg import SSDVGG as TSSD
    sizes = TSSD.feature_sizes(300)
    assert sizes == JSSD.feature_sizes(300) == [38, 19, 10, 5, 3, 2]
    for image_size in (300, 64, 32):
        sizes = TSSD.feature_sizes(image_size)
        assert sizes == JSSD.feature_sizes(image_size)
        want = janc.generate_anchors(sizes, SSD_SCALES[:len(sizes) + 1], SSD_ASPECTS[:len(sizes)])
        got = tanc.generate_anchors(sizes, SSD_SCALES[:len(sizes) + 1], SSD_ASPECTS[:len(sizes)])
        assert got.tobytes() == want.tobytes()
        if image_size == 300:
            assert got.shape == (7772, 4)


@pytest.fixture(scope='module')
def ssd_case():
    rng = np.random.default_rng(0)
    anchors = tanc.generate_anchors([8, 4, 2, 1], [0.1, 0.2, 0.375, 0.55, 0.725],
                                    [[2.0, 0.5]] * 4)
    labels = _labels(rng, 4, 8, anchors)
    return rng, anchors, labels


def test_match_anchors_exact(ssd_case):
    _, anchors, labels = ssd_case
    want = jax.vmap(lambda lab: janc.match_anchors(
        lab[:, 1:5], lab[:, 0], lab[:, 5], jnp.asarray(anchors), 0.5))(jnp.asarray(labels))
    got = tanc.match_anchors(T(labels[..., 1:5]), T(labels[..., 0]), T(labels[..., 5]),
                             T(anchors), 0.5)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # the two ground truths of image 0 that share a best anchor each hold one
    cls_t = got[0].numpy()[0]
    assert (cls_t == 3).any() and (cls_t == 7).any()
    # the difficult row claims nothing: its class never appears without a twin
    for i in range(4):
        assert set(np.unique(got[0].numpy()[i])) <= {0} | set(labels[i, labels[i, :, 5] > 0, 0])


@pytest.mark.parametrize('tied', [False, True])
def test_ssd_loss_and_gradient(ssd_case, tied):
    rng, anchors, labels = ssd_case
    nb_img, nb_anchors = labels.shape[0], anchors.shape[0]
    if tied:  # every anchor the same logits: every negative's loss is equal
        logits = np.broadcast_to(rng.normal(size=(1, 1, 21)),
                                 (nb_img, nb_anchors, 21)).astype(np.float32).copy()
    else:
        logits = rng.normal(size=(nb_img, nb_anchors, 21)).astype(np.float32)
    deltas = rng.normal(size=(nb_img, nb_anchors, 4)).astype(np.float32)

    def jloss(lg, dl):
        return jssd.ssd_loss(lg, dl, jnp.asarray(labels), jnp.asarray(anchors))
    (jl, jm), jgrads = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(logits), jnp.asarray(deltas))
    tl, td = T(logits).requires_grad_(), T(deltas).requires_grad_()
    loss, metrics = tssd.ssd_loss(tl, td, T(labels), T(anchors))
    loss.backward()
    assert abs(float(loss) - float(jl)) <= 1e-5 * max(1.0, abs(float(jl)))
    for key in ('cls_loss', 'loc_loss', 'nb_pos_anchors'):
        assert abs(float(metrics[key]) - float(jm[key])) <= 1e-5 * max(1.0, abs(float(jm[key])))
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jgrads[0]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(jgrads[1]), rtol=0, atol=1e-6)
    if tied:  # the mined negatives are the first ones by anchor index
        nonzero = (np.abs(tl.grad.numpy()).sum(-1) > 0)
        assert nonzero.sum() < nonzero.size


def test_stable_ranks_equal_jax_argsort():
    scores = np.asarray([[1.0, 3.0, 3.0, -np.inf, 1.0, 3.0, 0.0]], np.float32)
    want = np.asarray(jnp.argsort(jnp.argsort(-jnp.asarray(scores), axis=1), axis=1))
    np.testing.assert_array_equal(tssd.stable_ranks(T(scores)).numpy(), want)


# ---------------------------------------------------------------------------
# host NMS and VOC AP (numpy copies)
# ---------------------------------------------------------------------------

def _detection_case(seed=1, nb_img=6, nb_anchors=120, nb_classes=6):
    rng = np.random.default_rng(seed)
    probs = rng.dirichlet(np.ones(nb_classes) * 0.3, size=(nb_img, nb_anchors)).astype(np.float32)
    probs[0, :3] = probs[0, 3]  # equal scores
    boxes = _random_boxes(rng, (nb_img, nb_anchors))
    gts = []
    for i in range(nb_img):
        g = np.zeros((5, 6), np.float32)
        n = int(rng.integers(1, 5))
        g[:n, 0] = rng.integers(1, nb_classes, n)
        g[:n, 1:5] = boxes[i, rng.choice(nb_anchors, n, replace=False)]
        g[:n, 5] = 1.0
        if n > 1:
            g[n - 1, 5] = -1.0  # difficult
        gts.append(g)
    return probs, boxes, gts


def test_host_nms_parse_and_voc_ap_exact():
    probs, boxes, gts = _detection_case()
    np.testing.assert_array_equal(tnms.nms(boxes[0], probs[0, :, 1], 0.45, 50),
                                  jnms.nms(boxes[0], probs[0, :, 1], 0.45, 50))
    dets_t = [tnms.parse_detections(p, b, 0.2, 0.45) for p, b in zip(probs, boxes)]
    dets_j = [jnms.parse_detections(p, b, 0.2, 0.45) for p, b in zip(probs, boxes)]
    assert dets_t == dets_j and sum(map(len, dets_t)) > 10
    class_boxes = np.repeat(boxes[:, :, None], probs.shape[-1], axis=2)  # [A, C, 4] form
    assert [tnms.parse_detections(p, b, 0.2) for p, b in zip(probs, class_boxes)] == \
        [jnms.parse_detections(p, b, 0.2) for p, b in zip(probs, class_boxes)]
    for use_07 in (False, True):
        want = jvoc.evaluate_detections(dets_j, gts, probs.shape[-1], use_07_metric=use_07)
        got = tvoc.evaluate_detections(dets_t, gts, probs.shape[-1], use_07_metric=use_07)
        assert got == want and 0.0 < got['mAP'] < 1.0


# ---------------------------------------------------------------------------
# Faster R-CNN pieces
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def rpn_case():
    rng = np.random.default_rng(2)
    nb_img, nb_anchors = 3, 400
    anchors = _random_boxes(rng, (nb_anchors,), 0.05, 0.5)
    scores = rng.uniform(size=(nb_img, nb_anchors)).astype(np.float32)
    scores[:, 10:20] = scores[:, 10:11]  # ties: the lower index first
    deltas = (0.3 * rng.normal(size=(nb_img, nb_anchors, 4))).astype(np.float32)
    labels = _labels(rng, nb_img, 6)
    return anchors, scores, deltas, labels


def test_nms_fixed_exact(rpn_case):
    anchors, scores, _, _ = rpn_case
    boxes = np.broadcast_to(anchors, (scores.shape[0],) + anchors.shape).copy()
    for max_out in (40, 400):  # 400: past the last pick, slots go invalid
        want = jax.vmap(lambda b, s: jfr.nms_fixed(b, s, max_out, 0.5))(
            jnp.asarray(boxes), jnp.asarray(scores))
        got = tfr.nms_fixed(T(boxes), T(scores), max_out, 0.5)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert not got[1].numpy().all()


def test_propose_exact(rpn_case):
    anchors, scores, deltas, _ = rpn_case
    want = jax.vmap(lambda s, d: jfr.propose(s, d, jnp.asarray(anchors), 64, 24, 0.7))(
        jnp.asarray(scores), jnp.asarray(deltas))
    got = tfr.propose(T(scores), T(deltas), T(anchors), 64, 24, 0.7)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-6)
    top = tfr.top_k_stable(T(scores), 15)[1].numpy()
    np.testing.assert_array_equal(top, np.asarray(jax.lax.top_k(jnp.asarray(scores), 15)[1]))


def test_roi_align_matches(rpn_case):
    anchors, scores, _, _ = rpn_case
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(3, 9, 11, 5)).astype(np.float32)
    rois = np.concatenate([anchors[:20].reshape(1, 20, 4).repeat(3, 0),
                           np.asarray([[[0.0, 0.0, 1.0, 1.0]] * 3]).transpose(1, 0, 2)
                           .astype(np.float32)], axis=1)
    want = jax.vmap(lambda f, r: jfr.roi_align(f, r, 7))(jnp.asarray(feats), jnp.asarray(rois))
    got = tfr.roi_align(T(feats), T(rois), 7)
    assert got.shape == (3, 21, 7, 7, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    lin = tfr.roi_linspace(T(rois[..., 0]), T(rois[..., 2]), 7).numpy()
    np.testing.assert_array_equal(lin, np.asarray(jax.vmap(jax.vmap(
        lambda a, b: jnp.linspace(a, b, 7)))(jnp.asarray(rois[..., 0]), jnp.asarray(rois[..., 2]))))


def _assert_targets(got, want, box_index):
    """Every output exactly equal but the box targets, within 1e-6 relative."""
    for idx, (g, w) in enumerate(zip(got, want)):
        if idx == box_index:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_rpn_and_proposal_targets_exact(rpn_case):
    anchors, _, _, labels = rpn_case
    gtb, gtc, gtv = labels[..., 1:5], labels[..., 0], labels[..., 5]
    want = jax.vmap(lambda b, v: jfr.rpn_targets(b, v, jnp.asarray(anchors)))(
        jnp.asarray(gtb), jnp.asarray(gtv))
    got = tfr.rpn_targets(T(gtb), T(gtv), T(anchors))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6, atol=1e-6)
    assert (got[0].numpy() == 1).any() and (got[0].numpy() == -1).any()
    props = np.broadcast_to(anchors[:50], (3, 50, 4)).copy()
    valid = np.arange(50)[None].repeat(3, 0) < np.asarray([[50], [40], [10]])
    want = jax.vmap(jfr.proposal_targets)(jnp.asarray(props), jnp.asarray(valid),
                                          jnp.asarray(gtb), jnp.asarray(gtc), jnp.asarray(gtv))
    got = tfr.proposal_targets(T(props), T(valid), T(gtb), T(gtc), T(gtv))
    _assert_targets(got, want, box_index=1)


def test_sample_rois_exact_given_jax_tie(rpn_case):
    anchors, _, _, labels = rpn_case
    gtb, gtc, gtv = labels[..., 1:5], labels[..., 0], labels[..., 5]
    pool = np.concatenate([np.broadcast_to(anchors[:60], (3, 60, 4)), gtb], axis=1)
    pool_valid = np.concatenate([np.ones((3, 60), bool), gtv > 0.5], axis=1)
    key = jax.random.PRNGKey(5)
    tie = np.asarray(jax.random.uniform(key, pool.shape[:2][1:]))
    want = jax.vmap(lambda p, v, b, c, g: jfr.sample_rois(p, v, b, c, g, key, 32, 0.25))(
        jnp.asarray(pool), jnp.asarray(pool_valid), jnp.asarray(gtb), jnp.asarray(gtc),
        jnp.asarray(gtv))
    got = tfr.sample_rois(T(pool), T(pool_valid), T(gtb), T(gtc), T(gtv),
                          T(np.broadcast_to(tie, pool.shape[:2]).copy()), 32, 0.25)
    _assert_targets(got, want, box_index=2)
    assert got[3].numpy().sum() > 0  # foreground slots exist (the ground truths joined)


def test_tie_hash_within_bound(rpn_case):
    anchors, _, _, _ = rpn_case
    coef = jnp.asarray([12.9898, 78.233, 37.719, 4.581], jnp.float32)
    h = jnp.sin(jnp.sum(jnp.asarray(anchors) * coef, axis=1) * 43758.5453)
    want = np.asarray(h - jnp.floor(h))
    got = tfr.tie_hash(T(anchors)).numpy()
    diff = np.abs(got - want)
    diff = np.minimum(diff, 1.0 - diff)  # mod 1
    assert diff.max() <= 4e-3 and ((got >= 0) & (got < 1)).all()


def test_rpn_and_rcnn_loss(rpn_case):
    anchors, scores, deltas, labels = rpn_case
    rng = np.random.default_rng(4)
    gtb, gtv = labels[..., 1:5], labels[..., 5]
    lab, box_t = tfr.rpn_targets(T(gtb), T(gtv), T(anchors))
    logits = rng.normal(size=scores.shape).astype(np.float32)
    want = jax.vmap(jfr.rpn_loss)(jnp.asarray(logits), jnp.asarray(deltas),
                                  jnp.asarray(lab.numpy()), jnp.asarray(box_t.numpy()))
    got = tfr.rpn_loss(T(logits), T(deltas), lab, box_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    nb_rois, nb_c = 16, 21
    cls_l = rng.normal(size=(3, nb_rois, nb_c)).astype(np.float32)
    box_d = rng.normal(size=(3, nb_rois, nb_c * 4)).astype(np.float32)
    cls_t = rng.integers(0, nb_c, (3, nb_rois)).astype(np.int32)
    box_tr = rng.normal(size=(3, nb_rois, 4)).astype(np.float32)
    fg = (rng.uniform(size=(3, nb_rois)) < 0.3).astype(np.float32)
    vm = (rng.uniform(size=(3, nb_rois)) < 0.8).astype(np.float32)
    want = jax.vmap(jfr.rcnn_loss)(*map(jnp.asarray, (cls_l, box_d, cls_t, box_tr, fg, vm)))
    got = tfr.rcnn_loss(T(cls_l), T(box_d), T(cls_t).long(), T(box_tr), T(fg), T(vm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
