"""The shared detection eval loop: the dump_n_eval loop of both detection
helpers (counterpart of pocketflow_tpu/nets/detection/eval_loop.py).

* The batch count comes from the samples actually loaded
  (``nb_smpls_loaded`` after ``build()``), and the wrap-around tail is
  dropped, so no image is scored twice.
* Under data parallelism each rank scores its shard (an equal floor share),
  and the detections and ground truths of all ranks are gathered before
  scoring, so every rank reports the mAP of the whole set.  The gather is
  ``core/mesh.all_gather_rows`` (a zero-padded sum: only all-reduce runs
  with CUDA tensors over gloo), the detections packed into
  [n_img, cap, 6] rows with cap the largest count of any rank.
* ``timings`` (seconds): the forward ('forward'), the decode on the device
  and its copy to the host ('decode'), the per-class host NMS ('nms') and
  the VOC evaluation ('voc_eval'), each ended by a synchronize.

``DetectionHelperMixin`` is the eval side of both helpers around it.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.core import checkpoint as ckpt_lib
from pocketflow_tpu_torch.core import mesh
from pocketflow_tpu_torch.core.metrics import get_logger
from pocketflow_tpu_torch.nets.detection import voc_eval


def _per_process_eval_count(dataset) -> int:
    """Samples this rank scores: the whole loaded set at world size 1, the
    equal floor share of it under data parallelism."""
    nb_smpls = getattr(dataset, 'nb_smpls_loaded', None)
    if nb_smpls is None:
        nb_smpls = dataset.spec.nb_smpls_eval
    world = mesh.num_workers()
    return max(1, nb_smpls // world) if world > 1 else nb_smpls


def nb_eval_batches(dataset, nb_batches: Optional[int] = None) -> int:
    """Batches covering this rank's share once (ceil; the tail that wraps
    around is dropped after the loop)."""
    if nb_batches is not None:
        return nb_batches
    return max(1, -(-_per_process_eval_count(dataset) // dataset.batch_size))


def allgather_detections(detections: List[List[dict]], groundtruth: List[np.ndarray]
                         ) -> Tuple[List[List[dict]], List[np.ndarray]]:
    """Every rank's detections and ground truths, in the set's order: each
    rank's detections packed into [n_img, cap, 6] rows (class, score, box), cap the
    largest count of any rank, then gathered with the counts and the ground
    truths."""
    n_img = len(detections)
    local_max = torch.tensor([max((len(d) for d in detections), default=0)], dtype=torch.float64,
                             device=mesh.comm_device())
    cap = max(1, int(mesh.all_reduce_max_(local_max).item()))
    packed = np.zeros((n_img, cap, 6), np.float64)
    for i, dets in enumerate(detections):
        for j, d in enumerate(dets):
            packed[i, j, 0] = float(d['class'])
            packed[i, j, 1] = float(d['score'])
            packed[i, j, 2:6] = np.asarray(d['box'], np.float32)
    counts = np.asarray([len(d) for d in detections], np.float64)
    gts = np.stack([np.asarray(g, np.float32) for g in groundtruth]).astype(np.float64)
    g_packed = mesh.all_gather_rows(packed)       # [P, n_img, cap, 6]
    g_counts = mesh.all_gather_rows(counts)       # [P, n_img]
    g_gts = mesh.all_gather_rows(gts)             # [P, n_img, M, 6]

    # rank p's i-th image is the set's image p + i * world (the shards are
    # images[rank::world]): put them back in that order, the order one rank
    # scores them in, so that tied scores rank alike
    all_dets: List[List[dict]] = []
    all_gts: List[np.ndarray] = []
    for i in range(n_img):
        for p in range(g_packed.shape[0]):
            dets = []
            for j in range(int(g_counts[p, i])):
                row = g_packed[p, i, j].astype(np.float32)
                dets.append({'class': int(row[0]), 'score': float(row[1]),
                             'box': row[2:6].tolist()})
            all_dets.append(dets)
            all_gts.append(g_gts[p, i].astype(np.float32))
    return all_dets, all_gts


def _synced(device: torch.device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    return time.perf_counter()


@torch.no_grad()
def run_detection_eval(helper, dataset, forward_fn, device, nb_batches: Optional[int] = None,
                       timings: Optional[Dict[str, float]] = None) -> Dict[str, float]:
    """Drive the helper's ``decode`` / ``dump_decoded`` / ``dump_n_eval``
    over the eval set; returns the mAP result dict ('mAP' and 'ap_cls_<k>').
    `forward_fn(images)` is the eval forward on `device`; `timings`, if
    given, gains the seconds by part (see the module docstring)."""
    timings = {} if timings is None else timings
    for key in ('forward', 'decode', 'nms', 'voc_eval'):
        timings.setdefault(key, 0.0)
    iterator = dataset.build()  # build first: it sets nb_smpls_loaded
    nb = nb_eval_batches(dataset, nb_batches)
    helper.dump_n_eval(action='init')
    for _ in range(nb):
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for k, v in next(iterator).items()}
        abatch = dataset.augment_batch(batch, None, False)
        start = _synced(device)
        out = forward_fn(abatch['image'])
        t_fwd = _synced(device)
        decoded = helper.decode(out, abatch['label'])
        t_dec = time.perf_counter()
        helper.dump_decoded(decoded)
        t_nms = time.perf_counter()
        timings['forward'] += t_fwd - start
        timings['decode'] += t_dec - t_fwd
        timings['nms'] += t_nms - t_dec
    if nb_batches is None:  # drop the wrapped-around head: each image once
        target = _per_process_eval_count(dataset)
        helper._detections = helper._detections[:target]
        helper._groundtruth = helper._groundtruth[:target]
    if mesh.num_workers() > 1:
        helper._detections, helper._groundtruth = allgather_detections(
            helper._detections, helper._groundtruth)
    start = time.perf_counter()
    result = helper.dump_n_eval(action='eval')
    timings['voc_eval'] += time.perf_counter() - start
    return result


class DetectionHelperMixin:
    """The eval side both detection helpers share: the dump_n_eval protocol
    over ``decode`` (device -> host arrays) and ``parse`` (one image's host
    NMS), ``evaluate_map`` and ``warm_start``'s graft under `BACKBONE`."""

    BACKBONE = ''

    def _init_eval(self):
        self._detections: List[List[Dict]] = []
        self._groundtruth: List[np.ndarray] = []

    def dump_decoded(self, decoded):
        """Parse one decoded batch (its images' host arrays) into detections."""
        *arrays, labels = decoded
        for i in range(labels.shape[0]):
            self._detections.append(self.parse(*(a[i] for a in arrays)))
            self._groundtruth.append(labels[i])

    def dump_n_eval(self, outputs=None, action: str = 'init'):
        if action == 'init':
            self._init_eval()
            return None
        if action == 'dump':
            self.dump_decoded(self.decode(*outputs))
            return None
        if action == 'eval':
            return voc_eval.evaluate_detections(self._detections, self._groundtruth,
                                                self.nb_classes)
        raise ValueError('unrecognized dump_n_eval action: ' + action)

    def evaluate_map(self, model: torch.nn.Module, dataset, nb_batches: Optional[int] = None,
                     policy=None, timings: Optional[Dict[str, float]] = None):
        """VOC mAP of `model` (under `policy`, e.g. a QuantPolicy) over the
        whole loaded eval set, or its first `nb_batches` batches."""
        device = next(model.parameters()).device
        return run_detection_eval(
            self, dataset, lambda x: self.forward_eval(model, x, policy=policy), device,
            nb_batches, timings)

    def warm_start(self, state):
        """Graft the conv and BN tensors of a classification checkpoint
        (``--save_path``) into the backbone by name and shape."""
        nb = ckpt_lib.restore_intersecting(FLAGS.save_path, state.model,
                                           prefix_map={'': self.BACKBONE})
        log = get_logger()
        if nb:
            log.info('warm start: %d backbone tensors grafted from %s', nb, FLAGS.save_path)
        else:
            log.warning('warm_start grafted NO tensors from %s: is the checkpoint missing or '
                        'from a different trunk?', FLAGS.save_path)
        return state
