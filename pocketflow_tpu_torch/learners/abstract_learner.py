"""Abstract learner: lifecycle + the shared train/eval machinery
(counterpart of pocketflow_tpu/learners/abstract_learner.py).

The train state is one object (`TrainState`): the module with its parameters
and BN running statistics, the SGD optimizer with its momentum buffers, the
host-side step count and the learner's `extra` tensors.  A train step is a
plain function of (state, device batch, generator) that updates the state in
place and returns it with its metrics as device tensors: nothing in a step
waits for the device, and only the loops read values back, every
``summ_step``.

Data parallelism (``core/mesh.py``): one process per device, each with a
replica of the state, broadcast from rank 0 after it is made or restored,
and its rows of the global batch (``per-chip batch x world``, which sets
the learning rate).  A step all-reduces the mean of every gradient after
the backward (one coalesced call), before any gradient transform, so that
every rank applies the same update to the same bits; BN takes its
statistics over the global batch (``nn/layers.py``) and per-tensor
activation ranges are global (``ops/fake_quant.py``).  Explicit all-reduces
rather than ``DistributedDataParallel``: ``TrainState.params`` keys
parameters by module path, ``copy_state`` deep-copies the model for every
roll-out, and frozen teachers and auxiliary heads leave parameters without
gradients.

Tensor parallelism (``--enbl_tensor_parallel`` with a "model" mesh axis > 1,
``core/mesh.py``): the model is drawn whole from the seed stream, as at any
mesh, and each rank keeps its shard of every kernel the JAX package's rule
shards (``nn/layers.shard_model_``); the SGD momentum follows its
parameter's shard.  The data collectives above run over the rank's data
group.  A checkpoint holds the full state (gathered over the model group,
written by rank 0), so that it resumes on any mesh; loading it takes each
rank's shard.  Learners whose compression is not written for sharded
kernels name their ROADMAP item in ``tp_todo`` and raise under tensor
parallelism; the searches that do host surgery raise through
``require_dp_only``.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import inspect
import os
from abc import ABC, abstractmethod
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.core import checkpoint as ckpt_lib
from pocketflow_tpu_torch.core import mesh
from pocketflow_tpu_torch.core.metrics import ProgressMonitor, SummaryWriter, get_logger
from pocketflow_tpu_torch.core.profiling import ProfilerHook, span
from pocketflow_tpu_torch.core.schedules import Schedule
from pocketflow_tpu_torch.nn import layers
from pocketflow_tpu_torch.nn.layers import CompressionPolicy

DOWNLOAD_BYTES_BOUND = 16 << 30  # download_model's extraction bound: far above any model tarball


def resolve_device(device) -> torch.device:
    """The device a learner runs on; a CUDA device must exist.  Under data
    parallelism a CUDA device without an index is the rank's own,
    ``cuda:LOCAL_RANK``; one with an index is kept (two ranks may share a
    card)."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('device %s requested but torch.cuda.is_available() is False'
                           % device)
    if device.type == 'cuda' and device.index is None and mesh.world_size() > 1:
        from pocketflow_tpu_torch.utils.devices import rank_device
        device = rank_device()
    return device


@dataclasses.dataclass
class TrainState:
    """The whole training state; train steps update it in place."""
    step: int
    model: torch.nn.Module          # parameters + BN running statistics
    optimizer: torch.optim.Optimizer  # SGD momentum buffers
    extra: Any = None               # learner-specific tensors (bits, masks, ...)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """Parameters keyed by Flax-style path ('stage1_block0/conv1/kernel')."""
        return {name.replace('.', '/'): p for name, p in self.model.named_parameters()}

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return {name.replace('.', '/'): b for name, b in self.model.named_buffers()}


class Sgd:
    """``optax.sgd(schedule, momentum)``: torch.optim.SGD with dampening 0,
    no Nesterov and no weight decay (it stays in the loss), its learning rate
    set from the schedule at the step count before the increment."""

    def __init__(self, schedule: Schedule, momentum: float):
        self.schedule = schedule
        self.momentum = momentum

    def init(self, model: torch.nn.Module, extra_leaves: Sequence[torch.Tensor] = ()
             ) -> torch.optim.SGD:
        """The optimizer over `model`'s parameters and, in a second group,
        `extra_leaves`: trainable tensors of a learner's `extra` (the
        non-uniform learner's codebooks)."""
        groups = [{'params': list(model.parameters())}]
        if extra_leaves:
            groups.append({'params': list(extra_leaves)})
        return torch.optim.SGD(groups, lr=self.schedule(0), momentum=self.momentum,
                               dampening=0.0, nesterov=False, weight_decay=0.0)

    def update(self, optimizer: torch.optim.Optimizer, step: int):
        lr = self.schedule(step)
        for group in optimizer.param_groups:
            group['lr'] = lr
        optimizer.step()


class AbstractLearner(ABC):
    """Lifecycle (`train` / `evaluate`) + shared train-loop pieces."""

    # a learner whose compression does not handle sharded kernels yet: the
    # ROADMAP item that ports it (init_state raises under tensor parallelism)
    tp_todo: Optional[str] = None

    def __init__(self, sm_writer: Optional[SummaryWriter], model_helper, device='cuda'):
        mesh.setup_groups()  # the mesh's data and model groups, before any shard is read
        self.sm_writer = sm_writer
        self.model_helper = model_helper
        self.device = resolve_device(device)
        self.log = get_logger()

        self.build_dataset_train = model_helper.build_dataset_train
        self.build_dataset_eval = model_helper.build_dataset_eval
        self.forward_train = model_helper.forward_train
        self.forward_eval = model_helper.forward_eval
        self.calc_loss = model_helper.calc_loss
        self.setup_lrn_rate = model_helper.setup_lrn_rate
        self.warm_start = model_helper.warm_start
        self.model_name = model_helper.model_name
        self.dataset_name = model_helper.dataset_name
        self.forward_w_labels = model_helper.forward_w_labels

        self.dataset_train = self.build_dataset_train()
        self.dataset_eval = self.build_dataset_eval()
        self.nb_workers = mesh.num_workers()
        self.batch_size_per_chip = self.dataset_train.spec.batch_size
        self.global_batch_size = self.batch_size_per_chip * self.nb_workers
        self.dataset_train.batch_size = self.batch_size_per_chip
        self.dataset_eval.batch_size = self.dataset_eval.spec.batch_size_eval

        self._seeds = np.random.default_rng(FLAGS.rand_seed)
        # tensor parallelism: --enbl_tensor_parallel with a "model" mesh axis
        # > 1; a model axis alone replicates the model on its ranks
        self.enbl_tp = bool(FLAGS.get('enbl_tensor_parallel')) and mesh.model_size() > 1

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    @abstractmethod
    def train(self):
        """Train a model and periodically produce checkpoint files."""

    @abstractmethod
    def evaluate(self):
        """Restore from the latest checkpoint and measure eval performance."""

    # ------------------------------------------------------------------
    # shared helpers
    # ------------------------------------------------------------------

    def require_dp_only(self, phase: str):
        """Fail loudly if a host-surgery search phase runs under tensor
        parallelism, as the JAX package does: search data-parallel, then
        fine-tune the resulting checkpoint under TP."""
        if self.enbl_tp:
            raise NotImplementedError(
                '%s does not support tensor parallelism during %s; run with a '
                '--mesh_shape without a "model" axis > 1 (e.g. --mesh_shape=data:N) and '
                'fine-tune the resulting checkpoint under TP' % (type(self).__name__, phase))

    def next_seed(self) -> int:
        return int(self._seeds.integers(0, 2 ** 62))

    def generator(self, seed: int) -> torch.Generator:
        """A generator on the learner's device (augmentation randomness)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return gen

    def create_model(self, shard: bool = True) -> torch.nn.Module:
        """A freshly initialized model on the device (parameters drawn on the
        host from the learner's seed stream, so a seed gives the same weights
        on every device and at every mesh); under tensor parallelism, with
        `shard`, this rank's shards of it."""
        model = self.model_helper.create_model()
        model.reset_parameters(torch.Generator().manual_seed(self.next_seed()))
        if shard and self.enbl_tp:
            layers.shard_model_(model)
        return model.to(self.device)

    def init_state(self, extra: Any = None) -> Tuple[TrainState, Sgd, Schedule]:
        """Initialize the model + optimizer; returns (state, tx, lr_schedule)."""
        if self.enbl_tp and self.tp_todo:
            raise NotImplementedError(
                '%s does not support tensor parallelism yet (%s); run with a --mesh_shape '
                'without a "model" axis > 1' % (type(self).__name__, self.tp_todo))
        schedule, self.nb_iters_train = self.setup_lrn_rate(self.global_batch_size)
        tx = Sgd(schedule, FLAGS.momentum)
        model = self.create_model()
        state = TrainState(step=0, model=model, optimizer=tx.init(model), extra=extra)
        return self.broadcast_state(state), tx, schedule

    def broadcast_state(self, state: TrainState) -> TrainState:
        """Rank 0's parameters, buffers, optimizer buffers and `extra` on every
        rank, in place (a shard and its momentum its model index's; nothing
        at world size 1)."""
        if mesh.world_size() > 1:
            mesh.broadcast_module_(state.model)
            for param, buffers in state.optimizer.state.items():
                for buf in buffers.values():
                    if isinstance(buf, torch.Tensor):
                        mesh.broadcast_like_(buf, param)
            state.extra = mesh.broadcast_from_primary(state.extra)
        return state

    def build_train_step(self, tx: Sgd,
                         policy_fn: Optional[Callable[[TrainState], Optional[CompressionPolicy]]] = None,
                         loss_extra_fn: Optional[Callable] = None,
                         grad_transform_fn: Optional[Callable] = None,
                         post_update_fn: Optional[Callable] = None,
                         frozen_bn: bool = False):
        """Build the train step ``step_fn(state, batch, generator) -> (state, metrics)``.

        * policy_fn(state)        -> CompressionPolicy for this step (or None)
        * loss_extra_fn(state, outputs, images, labels) -> (extra_loss, extra_metrics)
        * grad_transform_fn(state) -> None; edits the parameters' .grad in place
        * post_update_fn(state)   -> state
        * frozen_bn: the forward runs in eval mode (BN normalizes with its
          running statistics and leaves them unchanged), gradients included
        """
        helper = self.model_helper
        augment_xy = self.dataset_train.augment_xy
        loss_takes_step = 'step' in inspect.signature(helper.calc_loss).parameters

        def step_fn(state: TrainState, batch: Dict[str, torch.Tensor],
                    generator: Optional[torch.Generator]):
            with span('train.augment'):
                images, labels = augment_xy(batch, generator, True)
            with span('train.forward'):
                policy = policy_fn(state) if policy_fn is not None else None
                if frozen_bn:
                    outputs = helper.forward_eval(state.model, images, policy=policy)
                else:
                    outputs = helper.forward_train(
                        state.model, images, policy=policy,
                        labels=labels if self.forward_w_labels else None)
                params = state.params.items()
                if loss_takes_step:
                    loss, metrics = helper.calc_loss(labels, outputs, params, step=state.step)
                else:
                    loss, metrics = helper.calc_loss(labels, outputs, params)
                if loss_extra_fn is not None:
                    extra_loss, extra_metrics = loss_extra_fn(state, outputs, images, labels)
                    loss = loss + extra_loss
                    metrics = {**metrics, **extra_metrics}
            with span('train.backward'):
                state.optimizer.zero_grad(set_to_none=True)
                loss.backward()
            with span('train.grad_sync'):
                # the gradient of the global batch's mean loss, before any transform
                mesh.all_reduce_grads_([p for group in state.optimizer.param_groups
                                        for p in group['params']])
            with span('train.update'):
                if grad_transform_fn is not None:
                    grad_transform_fn(state)
                tx.update(state.optimizer, state.step)
                state.step += 1
                if post_update_fn is not None:
                    state = post_update_fn(state)
            metrics = {'loss': loss.detach(), **{k: v.detach() for k, v in metrics.items()}}
            return state, metrics

        return step_fn

    def build_eval_step(self, policy_fn=None):
        helper = self.model_helper
        augment_xy = self.dataset_eval.augment_xy

        @torch.no_grad()
        def step_fn(state: TrainState, batch):
            images, labels = augment_xy(batch, None, False)
            policy = policy_fn(state) if policy_fn is not None else None
            outputs = helper.forward_eval(state.model, images, policy=policy)
            loss, metrics = helper.calc_loss(labels, outputs, state.params.items())
            return {'loss': loss, **metrics}

        return step_fn

    # ------------------------------------------------------------------
    # loops
    # ------------------------------------------------------------------

    def put_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Copy a host batch to the device without waiting for it (pinned
        host memory, asynchronous copy on the current stream)."""
        out = {}
        for key, value in batch.items():
            tensor = torch.from_numpy(np.ascontiguousarray(value))
            if self.device.type == 'cuda':
                tensor = tensor.pin_memory()
            out[key] = tensor.to(self.device, non_blocking=True)
        return out

    def device_prefetch(self, iterator: Iterator, depth: int = 2) -> Iterator:
        """Keep `depth` batches in flight on the device ahead of the step."""
        buf = collections.deque()
        try:
            for _ in range(depth):
                buf.append(self.put_batch(next(iterator)))
            while True:
                buf.append(self.put_batch(next(iterator)))
                yield buf.popleft()
        except StopIteration:
            pass
        while buf:
            yield buf.popleft()

    def run_train_loop(self, state: TrainState, train_step, nb_iters: Optional[int] = None,
                       save_path: Optional[str] = None, eval_fn=None,
                       iterator: Optional[Iterator] = None,
                       log_prefix: str = 'train') -> TrainState:
        """The hot loop: feed batches, log every summ_step, save every save_step;
        under --enbl_profiler, trace its window of steps (``core/profiling.py``;
        the trace's path is then ``self.profile_path``)."""
        nb_iters = nb_iters if nb_iters is not None else self.nb_iters_train
        save_path = save_path or FLAGS.save_path
        iterator = iterator if iterator is not None else self.dataset_train.build()
        iterator = self.device_prefetch(iterator)
        monitor = ProgressMonitor(self.sm_writer if self.is_primary_worker() else None,
                                  self.dataset_train.batch_size, self.nb_workers,
                                  prefix=log_prefix)
        # every rank draws alike: the augmentation takes its rows of draws
        # made for the global batch
        base_seed = self.next_seed()
        profiler = ProfilerHook(device=self.device)  # --enbl_profiler's window
        try:
            for idx_iter in range(state.step, nb_iters):
                batch = next(iterator)
                profiler.before_step(idx_iter)
                state, metrics = train_step(state, batch, self.generator(base_seed + idx_iter))
                profiler.after_step(idx_iter)
                if (idx_iter + 1) % FLAGS.summ_step == 0:
                    monitor.report(idx_iter + 1, FLAGS.summ_step, self.global_scalars(metrics))
                if (idx_iter + 1) % FLAGS.save_step == 0:
                    self.save_model(state, save_path)
                    if eval_fn is not None:
                        eval_fn(state)
        finally:
            profiler.close(state.step)
        if profiler.path is not None:
            self.profile_path = profiler.path
        self.save_model(state, save_path)  # its barrier ends the loop on every rank
        ckpt_lib.wait_for_async_saves()  # --ckpt_backend=orbax: the saves complete
        mesh.auto_barrier()
        return state

    def global_scalars(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """The scalar metrics of a step as floats, each its mean over the
        ranks (one all-reduce)."""
        keys = [k for k, v in metrics.items() if v.dim() == 0]
        if not keys:
            return {}
        values = torch.stack([metrics[k].detach().to(torch.float64) for k in keys])
        mesh.all_reduce_mean_([values])
        return dict(zip(keys, values.tolist()))

    def run_eval_loop(self, state: TrainState, eval_step, nb_batches: Optional[int] = None,
                      log_prefix: str = 'eval') -> Dict[str, float]:
        iterator = self.dataset_eval.build()
        if nb_batches is None:
            nb_smpls = getattr(self.dataset_eval, 'nb_smpls_loaded',
                               self.dataset_eval.spec.nb_smpls_eval)
            # each global step takes a batch from every rank's disjoint
            # shard, and the iterators cycle their shards seamlessly: pick
            # the smallest k >= ceil-coverage with k*bs*world an exact
            # multiple of nb_smpls (searching a bounded window), so every
            # sample counts equally often; otherwise ceil coverage.  The
            # exact multiple needs equal shards, so it is claimed only when
            # the world divides nb_smpls
            per_step = self.dataset_eval.batch_size * self.nb_workers
            base = max(1, -(-nb_smpls // per_step))
            nb_batches = base
            if nb_smpls % self.nb_workers == 0:
                for k in range(base, min(base * 8, base + 64) + 1):
                    if (k * per_step) % nb_smpls == 0:
                        nb_batches = k
                        break
        totals: Dict[str, torch.Tensor] = {}
        for _ in range(nb_batches):
            metrics = eval_step(state, self.put_batch(next(iterator)))
            for key, value in metrics.items():
                if value.dim() == 0:
                    totals[key] = totals.get(key, 0.0) + value.double()
        if totals and self.nb_workers > 1:  # the global totals, one all-reduce
            keys = list(totals)
            summed = mesh.all_reduce_sum_(torch.stack([totals[k] for k in keys]))
            totals = {k: v / self.nb_workers for k, v in zip(keys, summed)}
        means = {k: float(v) / nb_batches for k, v in totals.items()}
        self.log.info('%s: %s', log_prefix,
                      ' | '.join('%s = %.4f' % kv for kv in means.items()))
        return means

    def eval_map(self, state: TrainState, policy: Optional[CompressionPolicy] = None,
                 timings: Optional[Dict[str, float]] = None) -> Dict[str, float]:
        """A detection helper's VOC mAP ('mAP' and 'ap_cls_<k>') of `state`'s
        model under `policy` over the whole eval set, logged (`timings`
        gains its seconds by part); {} for a helper without ``evaluate_map``."""
        if not hasattr(self.model_helper, 'evaluate_map'):
            return {}
        metrics = self.model_helper.evaluate_map(state.model, self.dataset_eval, policy=policy,
                                                 timings=timings)
        self.log.info('detection eval: mAP = %.4f', metrics.get('mAP', 0.0))
        return metrics

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------

    def save_model(self, state: TrainState, save_path: Optional[str] = None) -> str:
        """Rank 0 writes the checkpoint of the full state (under tensor
        parallelism gathered over the model group, or with
        --ckpt_backend=orbax each rank writes its shards); every rank waits
        for it."""
        save_path = save_path or FLAGS.save_path
        path = ckpt_lib.save_state(save_path, state.step, state.model, state.optimizer,
                                   state.extra)
        mesh.auto_barrier()
        if self.is_primary_worker():
            self.log.info('model saved to %s', path)
        return path

    def restore_model(self, target_state: TrainState,
                      save_path: Optional[str] = None) -> Optional[TrainState]:
        """Load the newest checkpoint under `save_path` into `target_state`."""
        save_path = save_path or FLAGS.save_path
        mesh.auto_barrier()  # no rank reads a file another is writing
        payload = ckpt_lib.restore_latest(save_path, map_location=self.device)
        if payload is None:
            return None
        layers.load_full_state_dict(target_state.model, payload['model'])
        ckpt_lib.load_optimizer(target_state.optimizer, target_state.model, payload['optimizer'])
        target_state.step = int(payload['step'])
        target_state.extra = ckpt_lib.local_extra(target_state.model, payload['extra'])
        self.broadcast_state(target_state)
        self.log.info('model restored from %s',
                      ckpt_lib.latest_checkpoint(os.path.dirname(save_path) or '.'))
        return target_state

    def download_model(self):
        """Pretrained-model bootstrap: a no-op when the save directory holds
        a checkpoint (the port's or the JAX package's); otherwise rank 0
        fetches the tarball at ``--model_http_url`` (http, https or file)
        and extracts its plain files, flattened by basename, into the save
        directory, while the other ranks wait at the barrier.  A URL that is
        not a tarball is a base: 'models_<model>_at_<dataset>.tar.gz' is
        appended.  Raises ValueError without a URL, on two members of one
        basename or past 16 GiB extracted, and FileNotFoundError when no
        checkpoint landed."""
        save_dir = os.path.dirname(FLAGS.save_path) or '.'
        if ckpt_lib.latest_checkpoint(save_dir) is not None:
            return
        url = FLAGS.get('model_http_url')
        if not url:
            raise ValueError(
                'local model files do not exist and <model_http_url> is not '
                'set (reference abstract_learner.py:116-117)')
        if not url.endswith(('.tar', '.tar.gz', '.tgz')):
            tarball = 'models_%s_at_%s.tar.gz' % (
                getattr(self.model_helper, 'model_name', 'model'),
                getattr(self.model_helper, 'dataset_name', 'dataset'))
            url = url.rstrip('/') + '/' + tarball
        if self.is_primary_worker():
            import tarfile
            import tempfile
            import urllib.request
            os.makedirs(save_dir, exist_ok=True)
            with tempfile.NamedTemporaryFile(suffix='.tar.gz') as tmp:
                with urllib.request.urlopen(url) as resp:
                    while True:
                        chunk = resp.read(1 << 20)
                        if not chunk:
                            break
                        tmp.write(chunk)
                tmp.flush()
                with tarfile.open(tmp.name) as tar:
                    # plain files only, by basename, never absolute or parent
                    # paths; two members of one basename would overwrite each
                    # other, and the extracted bytes are bounded
                    seen = set()
                    budget = DOWNLOAD_BYTES_BOUND
                    for member in tar.getmembers():
                        if not member.isfile():
                            continue
                        name = os.path.basename(member.name)
                        if not name or name.startswith('..'):
                            continue
                        if name in seen:
                            raise ValueError(
                                'tarball %s has duplicate basename %r — '
                                'refusing to silently overwrite' % (url, name))
                        seen.add(name)
                        budget -= max(0, member.size)
                        if budget < 0:
                            raise ValueError(
                                'tarball %s exceeds the extraction size '
                                'bound' % url)
                        src = tar.extractfile(member)
                        with open(os.path.join(save_dir, name), 'wb') as out:
                            while True:
                                chunk = src.read(1 << 20)
                                if not chunk:
                                    break
                                out.write(chunk)
            self.log.info('pretrained model fetched from %s into %s', url, save_dir)
        mesh.auto_barrier()
        if ckpt_lib.latest_checkpoint(save_dir) is None:
            raise FileNotFoundError(
                'no checkpoint found under %s after downloading %s' % (save_dir, url))

    @staticmethod
    def is_primary_worker(scope: str = 'global') -> bool:
        """Whether this process writes shared files (checkpoints, search
        state): rank 0 ('global'), or LOCAL_RANK 0 ('local')."""
        return mesh.is_primary_worker(scope)

    def copy_state(self, state: TrainState) -> TrainState:
        """A state that shares no tensor with `state`: a new model with
        copies of its parameters and buffers, a copy of `extra`, and a new
        optimizer of the same kind over the copies of the tensors it trains
        (the model's parameters, and any trainable leaves of `extra`), with
        copies of its momentum.  A roll-out of an RL search trains such a
        copy; the baseline it starts from stays as it was."""
        copies = {}  # id of each tensor copied -> its copy
        model = copy.deepcopy(state.model, copies)
        extra = copy.deepcopy(state.extra, copies)
        groups = [{**group, 'params': [copies[id(p)] for p in group['params']]}
                  for group in state.optimizer.param_groups]
        optimizer = type(state.optimizer)(groups, **state.optimizer.defaults)
        # the optimizer casts loaded buffers with .to(), which can keep the
        # very tensor: copy them first
        optimizer.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
        return TrainState(step=state.step, model=model, optimizer=optimizer, extra=extra)

    def set_extra(self, state: TrainState, extra: Any) -> TrainState:
        """Attach/replace the learner-specific `extra` tensors."""
        state.extra = extra
        return state

    def restore_baseline(self, state: TrainState,
                         save_path: Optional[str] = None) -> Tuple[TrainState, bool]:
        """Warm-start parameters and BN statistics from the full-precision
        baseline checkpoint, keeping this learner's step, optimizer and extra.
        Returns (state, restored?)."""
        save_path = save_path or FLAGS.save_path
        mesh.auto_barrier()
        payload = ckpt_lib.restore_latest(save_path, map_location=self.device)
        if payload is None:
            return state, False
        layers.load_full_state_dict(state.model, payload['model'])
        mesh.broadcast_module_(state.model)
        self.log.info('baseline params restored from %s',
                      ckpt_lib.latest_checkpoint(os.path.dirname(save_path) or '.'))
        return state, True
