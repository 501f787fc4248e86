"""Discrimination-aware channel pruning, Zhuang et al. NeurIPS'18
(dis-chn-pruned; counterpart of pocketflow_tpu/learners/discr_channel_pruning/learner.py).

The network's convs are split into ``dcp_nb_stages + 1`` blocks; each block
boundary gets an auxiliary classifier head (training-mode BN + ReLU + global
average pool + dense, reference :355-361) whose cross-entropy is the
"discrimination-aware" signal.  Per block:

1. block finetune: the pruned net and the heads train on the block's head
   loss plus the final loss (twice in the last block), gradients masked;
2. greedy channel selection, layer by layer (the first conv is never
   pruned): the layer starts with no channel, and the input channel with the
   largest gradient norm of (the layer's regression loss + the block's
   loss) is added, its weights restored from the backup, and the layer
   finetuned briefly, until the layer's pruning ratio reaches
   ``dcp_prune_ratio`` (reference :461-528).

The gradient norms are those of the kernel parameter itself at its zeroed
weights, never of a masked product, so a pruned channel keeps its signal and
can come back.  A backup of every maskable parameter keeps the values of
the channels live under the OLD mask; a channel added under the new mask
restarts from it (the reference's mask/var_bkup/prune assign chain).  Every
step augments with a generator seeded 0, as the JAX programs use
PRNGKey(0).  The full model is the regression target; selection trains a
copy of it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.core import mesh
from pocketflow_tpu_torch.learners.abstract_learner import AbstractLearner, TrainState
from pocketflow_tpu_torch.learners.capture import (
    CapturePolicy, capture_forward, capture_forward_with_output)
from pocketflow_tpu_torch.learners.channel_pruning.channel_pruner import conv_modules, run_until
from pocketflow_tpu_torch.learners.channel_pruning.learner import kernel_masks
from pocketflow_tpu_torch.learners.distillation_helper import DistillationHelper
from pocketflow_tpu_torch.learners.weight_sparsification import masking
from pocketflow_tpu_torch.nn.layers import variance_scaling_

FLAGS.DEFINE_string('dcp_save_path', './models_dcp/model.ckpt', "DCP: model's save path")
FLAGS.DEFINE_string('dcp_save_path_eval', './models_dcp_eval/model.ckpt',
                    "DCP: model's save path for evaluation")
FLAGS.DEFINE_float('dcp_prune_ratio', 0.5, 'DCP: target channel pruning ratio')
FLAGS.DEFINE_integer('dcp_nb_stages', 3, 'DCP: # of channel pruning stages')
FLAGS.DEFINE_float('dcp_lrn_rate_adam', 1e-3, "DCP: Adam's learning rate")
FLAGS.DEFINE_integer('dcp_nb_iters_block', 10000, 'DCP: # of iterations for block-wise FT')
FLAGS.DEFINE_integer('dcp_nb_iters_layer', 500, 'DCP: # of iterations for layer-wise FT')


class _HeadDense(nn.Module):
    """Flax's nn.Dense: kernel [in, out] (lecun_normal), bias (zeros), fp32."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        cin, cout = self.kernel.shape
        variance_scaling_(self.kernel, 1.0, 'fan_in', cin, cout, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        return x @ self.kernel + self.bias


class AuxHead(nn.Module):
    """BN with the batch's statistics (biased variance, eps 1e-5) + ReLU +
    global average pool + dense, on NCHW input in fp32; Flax's parameter
    names ('gamma', 'beta', 'fc/kernel', 'fc/bias')."""

    def __init__(self, channels: int, nb_classes: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))
        self.fc = _HeadDense(channels, nb_classes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.gamma.fill_(1.0)
            self.beta.zero_()
        self.fc.reset_parameters(generator)

    def forward(self, x):
        x = x.to(torch.float32)
        mean = torch.mean(x, dim=(0, 2, 3))
        var = torch.var(x, dim=(0, 2, 3), unbiased=False)
        x = ((x - mean[:, None, None]) * torch.rsqrt(var + 1e-5)[:, None, None]
             * self.gamma[:, None, None] + self.beta[:, None, None])
        x = torch.relu(x)
        return self.fc(torch.mean(x, dim=(2, 3)))


@torch.no_grad()
def discover_structure(model: torch.nn.Module, sample_images: torch.Tensor):
    """(conv paths in call order, block index of each, aux-head sites)."""
    recorder = run_until(model, sample_images, CapturePolicy())
    convs = conv_modules(model)
    conv_paths = [path for path, _ in recorder.captured if path in convs]
    nb_layers = len(conv_paths)
    per_block = int(math.ceil((nb_layers + 1) / (FLAGS.dcp_nb_stages + 1)))
    boundaries = [idx for idx in range(nb_layers) if (idx + 1) % per_block == 0]
    head_sites = [conv_paths[idx] for idx in boundaries]
    # block index = the number of head sites strictly before the layer: the
    # actual head count defines the blocks (reference learner.py:253-255)
    layer_to_block = [sum(1 for b in boundaries if idx > b) for idx in range(nb_layers)]
    return conv_paths, layer_to_block, head_sites


def _kernel(params: Dict[str, torch.Tensor], path: str) -> torch.Tensor:
    return params[path.replace('/', '.') + '.kernel']


def selection_loss(learner, full: torch.nn.Module, model: torch.nn.Module,
                   heads: Dict[str, AuxHead], head_sites: List[str], images, labels,
                   block_onehot: List[float], layer_path: Optional[str] = None):
    """The block's loss (the block's head loss, plus the final loss where
    the one-hot's entry past the heads is set), plus `layer_path`'s
    regression loss onto `full` when given.  One forward of `model` (eval
    mode) gives both its captured outputs and its logits; terms the one-hot
    weighs 0 are not computed."""
    ce = learner.model_helper.softmax_cross_entropy
    captured, logits = capture_forward_with_output(model, images)
    outs = dict(captured)
    loss = sum(ce(labels, heads[site](outs[site]))
               for i, site in enumerate(head_sites) if block_onehot[i])
    if block_onehot[len(head_sites)]:
        loss = loss + ce(labels, logits)
    if layer_path is not None:
        with torch.no_grad():
            target = dict(capture_forward(full, images))[layer_path]
        loss = loss + 0.5 * torch.sum(torch.square(outs[layer_path].to(torch.float32)
                                                   - target.to(torch.float32)))
    return loss, logits


def block_ft_step(learner, full, model, heads, head_sites, masks, optimizer, batch,
                  block_onehot):
    """One block finetune step of `model` and the heads (Adam): the block's
    loss + the final loss, the model's maskable gradients masked."""
    images, labels = learner.dataset_train.augment_xy(batch, learner.generator(0), True)
    loss, logits = selection_loss(learner, full, model, heads, head_sites, images, labels,
                                  block_onehot)
    loss = loss + learner.model_helper.softmax_cross_entropy(labels, logits)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    mesh.all_reduce_grads_([p for group in optimizer.param_groups for p in group['params']])
    masking.mask_gradients_({n: p.grad for n, p in model.named_parameters()}, masks)
    optimizer.step()


def grad_norm_step(learner, full, model, heads, head_sites, batch, layer_path,
                   block_onehot) -> torch.Tensor:
    """Per-input-channel norms [c_in] of the selection loss's gradient with
    respect to `layer_path`'s kernel parameter itself, at its zeroed
    weights (no mask in the product)."""
    images, labels = learner.dataset_train.augment_xy(batch, learner.generator(0), False)
    loss, _ = selection_loss(learner, full, model, heads, head_sites, images, labels,
                             block_onehot, layer_path)
    kernel = _kernel(dict(model.named_parameters()), layer_path)
    grad, = torch.autograd.grad(loss, [kernel])
    mesh.all_reduce_mean_([grad])
    return torch.sqrt(torch.sum(torch.square(grad.to(torch.float32)), dim=(0, 1, 3)))


def layer_ft_step(learner, full, model, heads, head_sites, masks, optimizer, batch,
                  layer_path, block_onehot):
    """One layer finetune step: only `layer_path`'s kernel trains (Adam), on
    its masked gradient of the selection loss."""
    images, labels = learner.dataset_train.augment_xy(batch, learner.generator(0), True)
    loss, _ = selection_loss(learner, full, model, heads, head_sites, images, labels,
                             block_onehot, layer_path)
    name = layer_path.replace('/', '.') + '.kernel'
    kernel = dict(model.named_parameters())[name]
    grad, = torch.autograd.grad(loss, [kernel])
    mesh.all_reduce_mean_([grad])
    kernel.grad = grad * masks[name].to(grad.dtype)
    optimizer.step()
    kernel.grad = None


@torch.no_grad()
def merge_bkup(model: torch.nn.Module, bkup: Dict[str, torch.Tensor],
               masks_old: Dict[str, torch.Tensor], masks_new: Dict[str, torch.Tensor]):
    """bkup <- where(OLD mask > 0.5, param, bkup); param <- bkup * NEW mask,
    on every maskable parameter, in place.  The backup is refreshed from the
    channels live under the old mask: refreshing it under the new one would
    copy the zeros of a just-added channel over its saved weights."""
    for name, p in model.named_parameters():
        if not masking.is_maskable_path(name):
            continue
        bkup[name] = torch.where(masks_old[name] > 0.5, p.to(torch.float32), bkup[name])
        p.copy_((bkup[name] * masks_new[name]).to(p.dtype))


class DisChnPrunedLearner(AbstractLearner):
    """Discrimination-aware channel pruning learner."""

    tp_todo = ('ROADMAP item 30: the channel-pruning searches on sharded kernels; the JAX '
               'package guards their search phases too')

    def __init__(self, sm_writer, model_helper, device='cuda'):
        super().__init__(sm_writer, model_helper, device)
        self.helper_dst = None
        if FLAGS.enbl_dst:
            self.helper_dst = DistillationHelper(model_helper, self.device)
        self.nb_classes = self.dataset_train.spec.nb_classes
        self.aux_heads: Dict[str, AuxHead] = {}

    def _sample_images(self) -> torch.Tensor:
        sample = self.put_batch(self.dataset_train.peek_batch(2))
        return self.dataset_train.augment_images(sample, None, False)

    # ------------------------------------------------------------------
    # channel selection (reference __choose_discr_chns, :461-528)
    # ------------------------------------------------------------------

    def choose_discr_chns(self, state: TrainState) -> TrainState:
        conv_paths, layer_to_block, head_sites = discover_structure(
            state.model, self._sample_images())
        nb_blocks = int(FLAGS.dcp_nb_stages + 1)
        nb_layers = len(conv_paths)
        full = state.model
        pruned = self.copy_state(state)
        model = pruned.model
        params = dict(model.named_parameters())
        bkup = {n: p.detach().to(torch.float32).clone() for n, p in params.items()
                if masking.is_maskable_path(n)}
        batches = self.device_prefetch(self.dataset_train.build())
        chn_counts = {p: _kernel(params, p).shape[2] for p in conv_paths}
        host_masks = {p: np.ones(chn_counts[p], np.float32) for p in conv_paths}

        def device_masks():
            return kernel_masks(model, {p: torch.from_numpy(m.copy())
                                        for p, m in host_masks.items()})

        # the heads, drawn from the learner's seed stream; the JAX package
        # takes their shapes from one batch, which is drawn here as well
        next(batches)
        generator = torch.Generator().manual_seed(self.next_seed())
        self.aux_heads = {}
        for site in head_sites:
            head = AuxHead(_kernel(params, site).shape[3], self.nb_classes)
            head.reset_parameters(generator)
            self.aux_heads[site] = head.to(self.device)
        heads = self.aux_heads
        head_params = [p for site in head_sites for p in heads[site].parameters()]
        nb_iters_block = max(1, FLAGS.dcp_nb_iters_block // self.nb_workers)
        nb_iters_layer = max(1, FLAGS.dcp_nb_iters_layer // self.nb_workers)

        def adam(tensors):
            return torch.optim.Adam(tensors, lr=FLAGS.dcp_lrn_rate_adam, betas=(0.9, 0.999),
                                    eps=1e-8, weight_decay=0.0)

        for idx_block in range(nb_blocks):
            block_onehot = [0.0] * nb_blocks
            block_onehot[idx_block] = 1.0
            masks = device_masks()
            optimizer = adam(list(model.parameters()) + head_params)
            for _ in range(nb_iters_block):
                block_ft_step(self, full, model, heads, head_sites, masks, optimizer,
                              next(batches), block_onehot)

            for idx_layer in range(1, nb_layers):  # never prune the first layer
                if layer_to_block[idx_layer] != idx_block:
                    continue
                path = conv_paths[idx_layer]
                nb_chns = chn_counts[path]
                masks_before = device_masks()  # the layer still fully live
                host_masks[path] = np.zeros(nb_chns, np.float32)
                grad_norm_mask = np.ones(nb_chns)
                # save the layer's block-FT weights in the backup (old mask:
                # all ones), then zero it (new mask)
                masks = device_masks()
                merge_bkup(model, bkup, masks_before, masks)
                layer_opt = adam([_kernel(params, path)])
                prune_ratio = 1.0
                while prune_ratio > FLAGS.dcp_prune_ratio:
                    norms = grad_norm_step(self, full, model, heads, head_sites, next(batches),
                                           path, block_onehot).cpu().numpy()[:nb_chns]
                    idx_chn = int(np.argmax((norms + 1e-8) * grad_norm_mask))
                    masks_old = masks
                    host_masks[path][idx_chn] = 1.0
                    grad_norm_mask[idx_chn] = 0.0
                    masks = device_masks()
                    # restore the added channel's weights from the backup
                    merge_bkup(model, bkup, masks_old, masks)
                    for _ in range(nb_iters_layer):
                        layer_ft_step(self, full, model, heads, head_sites, masks, layer_opt,
                                      next(batches), path, block_onehot)
                    prune_ratio = 1.0 - float(np.count_nonzero(host_masks[path])) / nb_chns
                self.log.info('layer %s: prune_ratio = %.4f', path, prune_ratio)

        # rank 0's parameters and channel choices on every rank
        mesh.broadcast_module_(pruned.model)
        host_masks.update(mesh.broadcast_from_primary(host_masks))
        masks = device_masks()
        masking.apply_masks_(params, masks)
        return self.set_extra(pruned, {'masks': masks})

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def train(self) -> TrainState:
        self.require_dp_only('the greedy channel-selection phase')
        state, tx, _ = self.init_state()
        state, _ = self.restore_baseline(state)
        state = self.choose_discr_chns(state)
        grad_transform, post_update = masking.masked_update_hooks(state.model)
        loss_extra = self.helper_dst.loss_extra_fn() if self.helper_dst else None
        train_step = self.build_train_step(tx, loss_extra_fn=loss_extra,
                                           grad_transform_fn=grad_transform,
                                           post_update_fn=post_update)
        eval_step = self.build_eval_step()
        state = self.run_train_loop(state, train_step, save_path=FLAGS.dcp_save_path,
                                    eval_fn=lambda s: self.run_eval_loop(s, eval_step))
        self.run_eval_loop(state, eval_step)
        return state

    def evaluate(self) -> Dict[str, float]:
        state, _, _ = self.init_state()
        conv_paths, _, _ = discover_structure(state.model, self._sample_images())
        params = dict(state.model.named_parameters())
        masks = kernel_masks(state.model, {p: torch.ones(_kernel(params, p).shape[2])
                                           for p in conv_paths})
        state = self.set_extra(state, {'masks': masks})
        restored = self.restore_model(state, FLAGS.dcp_save_path)
        if restored is None:
            raise FileNotFoundError('no checkpoint found under ' + FLAGS.dcp_save_path)
        return self.run_eval_loop(restored, self.build_eval_step())
