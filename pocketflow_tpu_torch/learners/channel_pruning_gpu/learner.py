"""Channel pruning by proximal gradient descent on a group LASSO
(chn-pruned-gpu; counterpart of pocketflow_tpu/learners/channel_pruning_gpu/learner.py).

Per maskable conv kernel (HWIO), input channels are selected by iterating

    w   <- w - lr * rms(w) * g / rms(g)                 (relative step)
    n_c  = ||w[:, :, c, :]||_2                          (per-input-channel norm)
    thr  = percentile(n, rising schedule -> target)
    w   <- w * max(1 - thr / n_c, 0)                    (group-LASSO shrinkage)

where g is the gradient of the L2 distance between the pruned and the full
network's conv outputs, and each layer's lr adapts (x cpg_lrn_rate_pgd_incr
when its loss falls, x cpg_lrn_rate_pgd_decr otherwise).  All layers prune at
once: every layer input is detached, so the summed loss gives each layer its
own regression gradient.  Channels whose norm reaches zero are masked; the
survivors restart from the ORIGINAL weights and are reconstructed by a
relative Adam (the Adam direction scaled by -lr * max(rms(w), 1e-4)); the
global finetune with the task loss follows on the surviving channels.  The
full model is the regression target and is never written: the selection
trains a copy of it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.core import mesh
from pocketflow_tpu_torch.learners.abstract_learner import AbstractLearner, TrainState
from pocketflow_tpu_torch.learners.capture import capture_forward
from pocketflow_tpu_torch.learners.distillation_helper import DistillationHelper
from pocketflow_tpu_torch.learners.weight_sparsification import masking

FLAGS.DEFINE_string('cpg_save_path', './models_cpg/model.ckpt', "CPG: model's save path")
FLAGS.DEFINE_string('cpg_save_path_eval', './models_cpg_eval/model.ckpt',
                    "CPG: model's save path for evaluation")
FLAGS.DEFINE_string('cpg_prune_ratio_type', 'uniform',
                    "CPG: pruning ratio type ('uniform' | 'list')")
FLAGS.DEFINE_float('cpg_prune_ratio', 0.5, 'CPG: uniform pruning ratio')
FLAGS.DEFINE_boolean('cpg_skip_ht_layers', True, 'CPG: skip head & tail layers')
FLAGS.DEFINE_string('cpg_prune_ratio_file', None,
                    'CPG: file storing comma-separated per-layer pruning ratios')
FLAGS.DEFINE_float('cpg_lrn_rate_pgd_init', 1e-10, 'CPG: PGD initial learning rate')
FLAGS.DEFINE_float('cpg_lrn_rate_pgd_incr', 1.4, 'CPG: PGD lr increase ratio')
FLAGS.DEFINE_float('cpg_lrn_rate_pgd_decr', 0.7, 'CPG: PGD lr decrease ratio')
FLAGS.DEFINE_float('cpg_lrn_rate_adam', 1e-2, "CPG: Adam's learning rate")
FLAGS.DEFINE_integer('cpg_nb_iters_layer', 1000, 'CPG: # of iterations for layer-wise FT')


def channel_norms(kernel: torch.Tensor) -> torch.Tensor:
    """Per-input-channel L2 norm of an HWIO kernel -> [1, 1, I, 1]."""
    return torch.sqrt(torch.sum(torch.square(kernel.to(torch.float32)), dim=(0, 1, 3),
                                keepdim=True))


def group_lasso_shrink(kernel: torch.Tensor, percentile) -> torch.Tensor:
    """max(1 - thr/||w_c||, 0) shrinkage at the given percentile (:375-383),
    thr the linear-interpolation quantile of the channel norms.  Percentile
    0 (skipped head/tail layers) is a no-op: the quantile at 0 is the
    smallest norm, which would zero the weakest channel and shrink the
    others at every step."""
    norms = channel_norms(kernel)
    pct = torch.clamp(torch.as_tensor(percentile, dtype=torch.float32,
                                      device=kernel.device) / 100.0, 0.0, 1.0)
    thr = torch.where(pct > 0.0, torch.quantile(norms.reshape(-1), pct),
                      torch.zeros((), device=kernel.device))
    shrink = torch.clamp_min(1.0 - thr / torch.clamp_min(norms, 1e-20), 0.0)
    return (kernel.to(torch.float32) * shrink).to(kernel.dtype)


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(torch.square(x.to(torch.float32))))


def _module_path(name: str) -> str:
    """'stage1_block0.conv1.kernel' -> 'stage1_block0/conv1'."""
    return name.rsplit('.', 1)[0].replace('.', '/')


def reg_losses(full: torch.nn.Module, pruned: torch.nn.Module, images: torch.Tensor,
               names: List[str]) -> torch.Tensor:
    """Per-layer regression losses [L] of `pruned` onto `full`'s conv
    outputs (both in eval mode), aligned with the kernel `names`: 0.5 * the
    sum of squared differences, every layer input of `pruned` detached."""
    with torch.no_grad():
        targets = dict(capture_forward(full, images))
    outs = dict(capture_forward(pruned, images, stop_input_grads=True))
    return torch.stack([
        0.5 * torch.sum(torch.square(outs[_module_path(n)].to(torch.float32)
                                     - targets[_module_path(n)].to(torch.float32)))
        for n in names])


def pgd_step(learner, full: torch.nn.Module, pruned: torch.nn.Module, names: List[str],
             lrn_rates: torch.Tensor, percentiles: torch.Tensor,
             batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One PGD step on `pruned`'s kernels `names` in place: the relative
    normalized step (lr * rms(w) * g / rms(g), a non-finite result keeping
    the old weights), then the group-LASSO shrinkage at each layer's
    percentile.  Returns the losses [L] before the step."""
    images = learner.dataset_train.augment_images(batch, None, False)
    params = dict(pruned.named_parameters())
    losses = reg_losses(full, pruned, images, names)
    grads = torch.autograd.grad(losses.sum(), [params[n] for n in names])
    mesh.all_reduce_mean_(grads)
    with torch.no_grad():
        for idx, (name, g) in enumerate(zip(names, grads)):
            p = params[name]
            p32, g32 = p.to(torch.float32), g.to(torch.float32)
            g_rms = _rms(g32) + 1e-20
            p_rms = torch.clamp_min(_rms(p32), 1e-8)
            w_new = p32 - lrn_rates[idx] * p_rms * (g32 / g_rms)
            # overshoot guard: a non-finite update keeps the old weights (the
            # adaptive rule then decays this layer's rate)
            w_new = torch.where(torch.isfinite(w_new), w_new, p32)
            p.copy_(group_lasso_shrink(w_new, percentiles[idx]).to(p.dtype))
    return losses.detach()


class RelativeAdam:
    """optax.scale_by_adam() (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) times
    -lr * max(rms(w), 1e-4) per tensor, rms taken before the update: each
    step moves a kernel by at most ~lr of its own RMS, whatever the
    backbone's scale."""

    def __init__(self, params: List[torch.Tensor], lr: float, b1=0.9, b2=0.999, eps=1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = params, lr, b1, b2, eps
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]):
        self.count += 1
        c1 = float(1 - np.float32(self.b1) ** np.float32(self.count))
        c2 = float(1 - np.float32(self.b2) ** np.float32(self.count))
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = g.to(torch.float32)
            mu.mul_(self.b1).add_((1 - self.b1) * g)
            nu.mul_(self.b2).add_((1 - self.b2) * g.square())
            u = (mu / c1) / ((nu / c2).sqrt() + self.eps)
            scale = -self.lr * torch.clamp_min(_rms(p), 1e-4)
            p.add_((scale * u).to(p.dtype))


def recon_step(learner, full: torch.nn.Module, pruned: torch.nn.Module, names: List[str],
               masks: Dict[str, torch.Tensor], optimizer: RelativeAdam,
               batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One reconstruction step (Adam, :385-392) of `pruned`'s kernels on
    their surviving channels: the regression gradient times the mask.
    Returns the losses [L] before the step."""
    images = learner.dataset_train.augment_images(batch, None, False)
    params = dict(pruned.named_parameters())
    losses = reg_losses(full, pruned, images, names)
    grads = torch.autograd.grad(losses.sum(), [params[n] for n in names])
    mesh.all_reduce_mean_(grads)
    optimizer.step([g * masks[n].to(g.dtype) for n, g in zip(names, grads)])
    return losses.detach()


class ChannelPrunedGpuLearner(AbstractLearner):
    """Channel pruning with on-device PGD channel selection."""

    def __init__(self, sm_writer, model_helper, device='cuda'):
        super().__init__(sm_writer, model_helper, device)
        self.helper_dst = None
        if FLAGS.enbl_dst:
            self.helper_dst = DistillationHelper(model_helper, self.device)

    # ------------------------------------------------------------------

    @staticmethod
    def prunable_paths(params: Dict[str, torch.Tensor]) -> List[str]:
        """Conv kernels with prunable input channels (4-d, more than one
        input channel; depthwise kernels are not maskable), in the JAX
        package's tree order."""
        return [n for n in masking.maskable_paths(params)
                if params[n].dim() == 4 and params[n].shape[2] > 1]

    def ratio_list(self, nb_layers: int) -> List[float]:
        if FLAGS.cpg_prune_ratio_type == 'uniform':
            ratios = [FLAGS.cpg_prune_ratio] * nb_layers
            if FLAGS.cpg_skip_ht_layers and nb_layers >= 2:
                ratios[0] = 0.0
                ratios[-1] = 0.0
            return ratios
        if FLAGS.cpg_prune_ratio_type == 'list':
            with open(FLAGS.cpg_prune_ratio_file) as fin:
                text = fin.read().replace('\n', ',')
            ratios = [float(s) for s in text.split(',') if s.strip()]
            if len(ratios) != nb_layers:
                raise ValueError('cpg_prune_ratio_file has %d ratios but the model has %d '
                                 'prunable conv layers' % (len(ratios), nb_layers))
            return ratios
        raise ValueError('unrecognized pruning ratio type: ' + FLAGS.cpg_prune_ratio_type)

    @staticmethod
    def masks_of(model: torch.nn.Module, names: List[str]) -> Dict[str, torch.Tensor]:
        """Channel masks [1, 1, I, 1] of the surviving (nonzero) channels of
        the kernels `names`; 0-d ones elsewhere."""
        with torch.no_grad():
            return {n: ((channel_norms(p) > 0).to(torch.float32) if n in names
                        else torch.ones((), dtype=torch.float32, device=p.device))
                    for n, p in model.named_parameters()}

    # ------------------------------------------------------------------

    def choose_channels(self, state: TrainState) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """PGD channel selection + reconstruction on a copy of `state`;
        returns (the pruned copy with its masks in extra['masks'], the masks)."""
        full = state.model
        names = self.prunable_paths(dict(full.named_parameters()))
        ratios = self.ratio_list(len(names))
        batches = self.device_prefetch(self.dataset_train.build())
        nb_iters = max(1, FLAGS.cpg_nb_iters_layer // self.nb_workers)

        pruned = self.copy_state(state)
        lrn_rates = np.full(len(names), FLAGS.cpg_lrn_rate_pgd_init, np.float32)
        # +inf: the adaptive rule must see a real previous loss before it
        # decays (zeros would cut every rate on the first iteration)
        losses_prev = np.full(len(names), np.inf, np.float32)
        target = np.asarray(ratios, np.float32) * 100.0
        for idx_iter in range(nb_iters):
            percentiles = target * (idx_iter + 1) / nb_iters
            losses = pgd_step(self, full, pruned.model, names,
                              torch.from_numpy(lrn_rates).to(self.device),
                              torch.from_numpy(percentiles).to(self.device), next(batches))
            losses = losses.cpu().numpy()
            # adaptive per-layer lr (reference :490-495)
            lrn_rates = np.where(losses < losses_prev,
                                 lrn_rates * FLAGS.cpg_lrn_rate_pgd_incr,
                                 lrn_rates * FLAGS.cpg_lrn_rate_pgd_decr).astype(np.float32)
            losses_prev = losses
            if (idx_iter + 1) % max(1, nb_iters // 4) == 0:
                self.log.info('PGD iter %d/%d: reg losses %s', idx_iter + 1, nb_iters,
                              np.round(losses, 3).tolist())

        masks = self.masks_of(pruned.model, names)
        # survivors restart from the ORIGINAL weights: the shrinkage selects
        # channels, it is no start for the reconstruction
        params = dict(pruned.model.named_parameters())
        with torch.no_grad():
            for n, p in full.named_parameters():
                params[n].copy_(p)
        masking.apply_masks_(params, masks)
        optimizer = RelativeAdam([params[n] for n in names], FLAGS.cpg_lrn_rate_adam)
        losses = None
        for _ in range(nb_iters):
            losses = recon_step(self, full, pruned.model, names, masks, optimizer, next(batches))
        self.log.info('reconstruction done: reg losses %s',
                      np.round(losses.cpu().numpy(), 3).tolist())
        # pruned channels exactly zero after the reconstruction
        masking.apply_masks_(params, masks)
        # the PGD losses (so the adaptive rates and the shrinkage) came from
        # each rank's own shard: rank 0's result on every rank
        mesh.broadcast_module_(pruned.model)
        masks = mesh.broadcast_from_primary(masks)
        state = self.set_extra(pruned, {'masks': masks})
        return state, masks

    # ------------------------------------------------------------------

    def train(self) -> TrainState:
        state, tx, _ = self.init_state()
        state, _ = self.restore_baseline(state)
        state, _ = self.choose_channels(state)
        grad_transform, post_update = masking.masked_update_hooks(state.model)
        loss_extra = self.helper_dst.loss_extra_fn() if self.helper_dst else None
        train_step = self.build_train_step(tx, loss_extra_fn=loss_extra,
                                           grad_transform_fn=grad_transform,
                                           post_update_fn=post_update)
        eval_step = self.build_pruned_eval_step()
        state = self.run_train_loop(state, train_step, save_path=FLAGS.cpg_save_path,
                                    eval_fn=lambda s: self.run_eval_loop(s, eval_step))
        self.run_eval_loop(state, eval_step)
        return state

    def evaluate(self) -> Dict[str, float]:
        state, _, _ = self.init_state()
        params = dict(state.model.named_parameters())
        names = self.prunable_paths(params)
        masks = {n: (torch.ones((1, 1, p.shape[2], 1), device=p.device) if n in names
                     else torch.ones((), device=p.device)) for n, p in params.items()}
        state = self.set_extra(state, {'masks': masks})
        restored = self.restore_model(state, FLAGS.cpg_save_path)
        if restored is None:
            raise FileNotFoundError('no checkpoint found under ' + FLAGS.cpg_save_path)
        return self.run_eval_loop(restored, self.build_pruned_eval_step())

    def build_pruned_eval_step(self):
        """The eval step, which also reports the fraction of zero parameters
        (pr_trn)."""
        eval_step = self.build_eval_step()

        @torch.no_grad()
        def step_fn(state: TrainState, batch):
            return {**eval_step(state, batch),
                    'pr_trn': masking.calc_prune_ratio(dict(state.model.named_parameters()))}

        return step_fn
