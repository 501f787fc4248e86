"""Abstract learner: lifecycle + the shared train/eval machinery
(counterpart of pocketflow_tpu/learners/abstract_learner.py).

The train state is one object (`TrainState`): the module with its parameters
and BN running statistics, the SGD optimizer with its momentum buffers, the
host-side step count and the learner's `extra` tensors.  A train step is a
plain function of (state, device batch, generator) that updates the state in
place and returns it with its metrics as device tensors: nothing in a step
waits for the device, and only the loops read values back, every
``summ_step``.  Single device: there is no mesh, and ghost-BN sees one shard.
"""

from __future__ import annotations

import collections
import dataclasses
import inspect
import os
from abc import ABC, abstractmethod
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.core import checkpoint as ckpt_lib
from pocketflow_tpu_torch.core.metrics import ProgressMonitor, SummaryWriter, get_logger
from pocketflow_tpu_torch.core.schedules import Schedule
from pocketflow_tpu_torch.nn.layers import CompressionPolicy


def resolve_device(device) -> torch.device:
    """The device a learner runs on; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('device %s requested but torch.cuda.is_available() is False'
                           % device)
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

    def init(self, model: torch.nn.Module) -> torch.optim.SGD:
        return torch.optim.SGD(model.parameters(), lr=self.schedule(0), momentum=self.momentum,
                               dampening=0.0, nesterov=False, weight_decay=0.0)

    def update(self, optimizer: torch.optim.Optimizer, step: int):
        lr = self.schedule(step)
        for group in optimizer.param_groups:
            group['lr'] = lr
        optimizer.step()


class AbstractLearner(ABC):
    """Lifecycle (`train` / `evaluate`) + shared train-loop pieces."""

    def __init__(self, sm_writer: Optional[SummaryWriter], model_helper, device='cuda'):
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
        self.nb_workers = 1
        self.batch_size_per_chip = self.dataset_train.spec.batch_size
        self.global_batch_size = self.batch_size_per_chip
        self.dataset_train.batch_size = self.batch_size_per_chip
        self.dataset_eval.batch_size = self.dataset_eval.spec.batch_size_eval

        self._seeds = np.random.default_rng(FLAGS.rand_seed)

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

    def next_seed(self) -> int:
        return int(self._seeds.integers(0, 2 ** 62))

    def generator(self, seed: int) -> torch.Generator:
        """A generator on the learner's device (augmentation randomness)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return gen

    def create_model(self) -> torch.nn.Module:
        """A freshly initialized model on the device (parameters drawn on the
        host from the learner's seed stream, so a seed gives the same weights
        on every device)."""
        model = self.model_helper.create_model()
        model.reset_parameters(torch.Generator().manual_seed(self.next_seed()))
        return model.to(self.device)

    def init_state(self, extra: Any = None) -> Tuple[TrainState, Sgd, Schedule]:
        """Initialize the model + optimizer; returns (state, tx, lr_schedule)."""
        schedule, self.nb_iters_train = self.setup_lrn_rate(self.global_batch_size)
        tx = Sgd(schedule, FLAGS.momentum)
        model = self.create_model()
        state = TrainState(step=0, model=model, optimizer=tx.init(model), extra=extra)
        return state, tx, schedule

    def build_train_step(self, tx: Sgd,
                         policy_fn: Optional[Callable[[TrainState], Optional[CompressionPolicy]]] = None,
                         loss_extra_fn: Optional[Callable] = None,
                         grad_transform_fn: Optional[Callable] = None,
                         post_update_fn: Optional[Callable] = None):
        """Build the train step ``step_fn(state, batch, generator) -> (state, metrics)``.

        * policy_fn(state)        -> CompressionPolicy for this step (or None)
        * loss_extra_fn(state, outputs, images, labels) -> (extra_loss, extra_metrics)
        * grad_transform_fn(state) -> None; edits the parameters' .grad in place
        * post_update_fn(state)   -> state
        """
        helper = self.model_helper
        augment_xy = self.dataset_train.augment_xy
        loss_takes_step = 'step' in inspect.signature(helper.calc_loss).parameters

        def step_fn(state: TrainState, batch: Dict[str, torch.Tensor],
                    generator: Optional[torch.Generator]):
            images, labels = augment_xy(batch, generator, True)
            policy = policy_fn(state) if policy_fn is not None else None
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
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
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
        """The hot loop: feed batches, log every summ_step, save every save_step."""
        nb_iters = nb_iters if nb_iters is not None else self.nb_iters_train
        save_path = save_path or FLAGS.save_path
        iterator = iterator if iterator is not None else self.dataset_train.build()
        iterator = self.device_prefetch(iterator)
        monitor = ProgressMonitor(self.sm_writer, self.dataset_train.batch_size, 1,
                                  prefix=log_prefix)
        base_seed = self.next_seed()
        for idx_iter in range(state.step, nb_iters):
            batch = next(iterator)
            state, metrics = train_step(state, batch, self.generator(base_seed + idx_iter))
            if (idx_iter + 1) % FLAGS.summ_step == 0:
                monitor.report(idx_iter + 1, FLAGS.summ_step,
                               {k: float(v) for k, v in metrics.items() if v.dim() == 0})
            if (idx_iter + 1) % FLAGS.save_step == 0:
                self.save_model(state, save_path)
                if eval_fn is not None:
                    eval_fn(state)
        self.save_model(state, save_path)
        return state

    def run_eval_loop(self, state: TrainState, eval_step, nb_batches: Optional[int] = None,
                      log_prefix: str = 'eval') -> Dict[str, float]:
        iterator = self.dataset_eval.build()
        if nb_batches is None:
            nb_smpls = getattr(self.dataset_eval, 'nb_smpls_loaded',
                               self.dataset_eval.spec.nb_smpls_eval)
            # the iterator cycles the set seamlessly: pick the smallest
            # k >= ceil-coverage with k*bs an exact multiple of nb_smpls
            # (searching a bounded window), so every sample counts equally
            # often; otherwise ceil coverage
            per_step = self.dataset_eval.batch_size
            base = max(1, -(-nb_smpls // per_step))
            nb_batches = base
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
        means = {k: float(v) / nb_batches for k, v in totals.items()}
        self.log.info('%s: %s', log_prefix,
                      ' | '.join('%s = %.4f' % kv for kv in means.items()))
        return means

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------

    def save_model(self, state: TrainState, save_path: Optional[str] = None) -> str:
        save_path = save_path or FLAGS.save_path
        path = ckpt_lib.save(save_path, {
            'step': state.step,
            'model': state.model.state_dict(),
            'optimizer': state.optimizer.state_dict(),
            'extra': state.extra}, state.step)
        self.log.info('model saved to %s', path)
        return path

    def restore_model(self, target_state: TrainState,
                      save_path: Optional[str] = None) -> Optional[TrainState]:
        """Load the newest checkpoint under `save_path` into `target_state`."""
        save_path = save_path or FLAGS.save_path
        payload = ckpt_lib.restore_latest(save_path, map_location=self.device)
        if payload is None:
            return None
        target_state.model.load_state_dict(payload['model'])
        target_state.optimizer.load_state_dict(payload['optimizer'])
        target_state.step = int(payload['step'])
        target_state.extra = payload['extra']
        self.log.info('model restored from %s',
                      ckpt_lib.latest_checkpoint(os.path.dirname(save_path) or '.'))
        return target_state

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
        payload = ckpt_lib.restore_latest(save_path, map_location=self.device)
        if payload is None:
            return state, False
        state.model.load_state_dict(payload['model'])
        self.log.info('baseline params restored from %s',
                      ckpt_lib.latest_checkpoint(os.path.dirname(save_path) or '.'))
        return state, True
