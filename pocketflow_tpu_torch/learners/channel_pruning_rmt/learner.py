"""Channel pruning, "remastered" (chn-pruned-rmt; counterpart of
pocketflow_tpu/learners/channel_pruning_rmt/learner.py).

The same selection and reconstruction idea as the 'channel' learner, with
iterative solvers instead of the alpha search and the closed-form solve:

* **meta-LASSO**: ISTA with a fixed learning rate (``cpr_ista_lrn_rate`` x
  ``cpr_ista_nb_iters``, gradient divided by the number of rows) scores the
  input channels; the top (1 - ``cpr_prune_ratio``) by |beta| survive.  It
  runs on the Gram form of channel_pruner.py (G = P^T P, P^T y, formed once);
* **meta-least-square**: Adam (optax.adam's update, written out) on the
  normal-equation gradient 2 (X^T X / n W - X^T Y / n) reconstructs the
  surviving kernel slice from the original weights;
* sampling uses a larger bank: ``cpr_nb_smpls`` images (at most four times
  ``cp_nb_batches`` batches) x ``cpr_nb_crops_per_smpl`` positions.

Layers are skipped by ``cpr_skip_frst_layer`` / ``cpr_skip_last_layer`` /
``cpr_skip_op_names``.  The prune pass works on a copy of the baseline, which
stays the reconstruction target of every layer.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.core import mesh
from pocketflow_tpu_torch.learners.abstract_learner import AbstractLearner, TrainState
from pocketflow_tpu_torch.learners.channel_pruning import channel_pruner as cp_lib
from pocketflow_tpu_torch.learners.channel_pruning.learner import kernel_masks
from pocketflow_tpu_torch.learners.distillation_helper import DistillationHelper
from pocketflow_tpu_torch.learners.weight_sparsification import masking

FLAGS.DEFINE_string('cpr_save_path', './models_cpr/model.ckpt', "CPR: model's save path")
FLAGS.DEFINE_string('cpr_save_path_eval', './models_cpr_eval/model.ckpt',
                    "CPR: model's save path for evaluation")
FLAGS.DEFINE_string('cpr_save_path_ws', './models_cpr_ws/model.ckpt',
                    "CPR: model's save path for warm start")
FLAGS.DEFINE_float('cpr_prune_ratio', 0.5, 'CPR: pruning ratio')
FLAGS.DEFINE_boolean('cpr_skip_frst_layer', True, 'CPR: skip the first layer')
FLAGS.DEFINE_boolean('cpr_skip_last_layer', False, 'CPR: skip the last layer')
FLAGS.DEFINE_string('cpr_skip_op_names', None,
                    'CPR: comma-separated layer names to skip')
FLAGS.DEFINE_integer('cpr_nb_smpls', 5000, 'CPR: # of samples for regression')
FLAGS.DEFINE_integer('cpr_nb_crops_per_smpl', 10, 'CPR: # of random crops per sample')
FLAGS.DEFINE_float('cpr_ista_lrn_rate', 1e-2, "CPR: ISTA's learning rate")
FLAGS.DEFINE_integer('cpr_ista_nb_iters', 100, 'CPR: # of iterations in ISTA')
FLAGS.DEFINE_float('cpr_lstsq_lrn_rate', 1e-3,
                   "CPR: least-square regression's learning rate")
FLAGS.DEFINE_integer('cpr_lstsq_nb_iters', 100,
                     'CPR: # of iterations in least-square regression')
FLAGS.DEFINE_boolean('cpr_warm_start', False,
                     'CPR: warm-start from the weight-sparsified model')


def make_meta_lasso(nb_iters: int, lrn_rate: float):
    """solve(problem, n, alpha) -> beta: ISTA at a fixed learning rate on a
    `channel_pruner.lasso_problem` of n rows, b <- softshrink(b - lr (G b -
    P^T y) / n, lr * alpha), from zero (reference :432-468)."""
    def solve(problem, n: int, alpha: float) -> torch.Tensor:
        G, Pty, _ = problem
        thr = float(np.float32(lrn_rate) * np.float32(alpha))
        with cp_lib.full_precision():
            beta = torch.zeros_like(Pty)
            for _ in range(nb_iters):
                grad = torch.addmv(Pty, G, beta, beta=-1.0) / n
                beta = F.softshrink(torch.add(beta, grad, alpha=-lrn_rate), thr)
        return beta
    return solve


def make_meta_lstsq(nb_iters: int, lrn_rate: float):
    """solve(X, Y, W0) -> W: min ||Y - X W||^2 by Adam (b1 0.9, b2 0.999, eps
    1e-8, eps_root 0) on 2 (X^T X / n W - X^T Y / n) from the warm start W0
    [d, c_out] (reference :470-523); the update in optax's order."""
    b1, b2, eps = 0.9, 0.999, 1e-8

    def solve(X: torch.Tensor, Y: torch.Tensor, W0: torch.Tensor) -> torch.Tensor:
        with cp_lib.full_precision():
            X32, Y32 = X.to(torch.float32), Y.to(torch.float32)
            n = X32.shape[0]
            XtX = X32.T @ X32 / n
            XtY = X32.T @ Y32 / n
            W = W0.to(torch.float32).clone()
            mu, nu = torch.zeros_like(W), torch.zeros_like(W)
            for count in range(1, nb_iters + 1):
                grad = 2.0 * (XtX @ W - XtY)
                mu = (1 - b1) * grad + b1 * mu
                nu = (1 - b2) * grad.square() + b2 * nu
                mu_hat = mu / float(1 - np.float32(b1) ** np.float32(count))
                nu_hat = nu / float(1 - np.float32(b2) ** np.float32(count))
                W = W + (-lrn_rate) * (mu_hat / (nu_hat.sqrt() + eps))
        return W
    return solve


class ChannelPrunedRmtLearner(AbstractLearner):
    """Remastered channel pruning: meta-LASSO + iterative least squares."""

    def __init__(self, sm_writer, model_helper, device='cuda'):
        super().__init__(sm_writer, model_helper, device)
        self.helper_dst = None
        if FLAGS.enbl_dst:
            self.helper_dst = DistillationHelper(model_helper, self.device)
        self.specs = None
        self.pruner = None
        self._cpr_train_iter = None

    # ------------------------------------------------------------------

    def _setup(self, state: TrainState):
        sample = self.put_batch(self.dataset_train.peek_batch(2))
        images = self.dataset_train.augment_images(sample, None, False)
        specs = cp_lib.conv_layer_specs(state.model, images)
        skip_names = set()
        if FLAGS.cpr_skip_op_names:
            skip_names = set(FLAGS.cpr_skip_op_names.split(','))
        if FLAGS.cpr_skip_frst_layer and specs:
            skip_names.add(specs[0]['path'])
        if FLAGS.cpr_skip_last_layer and specs:
            skip_names.add(specs[-1]['path'])
        self.specs = [s for s in specs if s['path'] not in skip_names
                      and s['kernel_shape'][2] > 1]
        self.pruner = cp_lib.ChannelPruner(self.dataset_train, self.specs)
        self.meta_lasso = make_meta_lasso(FLAGS.cpr_ista_nb_iters, FLAGS.cpr_ista_lrn_rate)
        self.meta_lstsq = make_meta_lstsq(FLAGS.cpr_lstsq_nb_iters, FLAGS.cpr_lstsq_lrn_rate)

    @torch.no_grad()
    def prune_layer(self, spec: dict, kernel: torch.Tensor, X: torch.Tensor, Y: torch.Tensor):
        """(new kernel, channel mask bool [c_in]) of one layer: the top
        (1 - cpr_prune_ratio) channels by meta-LASSO |beta|, the kernel
        reconstructed on them by meta-least-squares."""
        h, w, c_in, c_out = spec['kernel_shape']
        c_keep = max(1, int(round((1.0 - FLAGS.cpr_prune_ratio) * c_in)))
        W2 = kernel.detach().to(torch.float32)
        with cp_lib.full_precision():
            # meta-LASSO channel scores on the same row subsample as 'channel'
            P, y = cp_lib.lasso_inputs(X, Y, W2)
            beta = self.meta_lasso(cp_lib.lasso_problem(P, y), P.shape[0], 1e-3)
            del P
            order = np.argsort(-np.abs(beta.cpu().numpy()))
            keep = np.zeros(c_in, bool)
            keep[order[:c_keep]] = True
            idxs = torch.from_numpy(keep).to(X.device)

            # meta-least-square reconstruction, warm-started from W2
            Xsel = X[:, idxs].reshape(X.shape[0], -1)
            W0 = W2[:, :, idxs, :].permute(2, 0, 1, 3).reshape(c_keep * h * w, c_out)
            Wnew = self.meta_lstsq(Xsel, Y, W0).reshape(c_keep, h, w, c_out)
        new_kernel = torch.zeros_like(W2)
        new_kernel[:, :, idxs, :] = Wnew.permute(1, 2, 0, 3)
        return new_kernel.to(kernel.dtype), idxs

    def prune_all_layers(self, state: TrainState) -> TrainState:
        """A copy of `state` with every selected layer pruned in order (X from
        the copy, Y from `state`'s model) and its masks in extra['masks']."""
        pruned = self.copy_state(state)
        orig, cur = state.model, pruned.model
        if self._cpr_train_iter is None:
            self._cpr_train_iter = self.device_prefetch(self.dataset_train.build())
        params = dict(cur.named_parameters())
        # sample bank sized to cpr_nb_smpls x crops via the cp sampler knobs
        nb_batches = max(1, FLAGS.cpr_nb_smpls // max(1, self.dataset_train.batch_size))
        chn_masks: Dict[str, torch.Tensor] = {}
        with FLAGS.scope(cp_nb_batches=min(nb_batches, FLAGS.cp_nb_batches * 4),
                         cp_nb_points_per_layer=FLAGS.cpr_nb_crops_per_smpl):
            for spec in self.specs:
                path = spec['path']
                X, Y = self.pruner.collect(spec, orig, cur, self._cpr_train_iter,
                                           self.generator(self.next_seed()))
                kernel = params[path.replace('/', '.') + '.kernel']
                new_kernel, idxs = self.prune_layer(spec, kernel, X, Y)
                del X, Y
                with torch.no_grad():
                    kernel.copy_(new_kernel)
                chn_masks[path] = idxs.to(torch.float32)
                self.log.info('layer %s: kept %d/%d channels', path, int(idxs.sum()),
                              spec['kernel_shape'][2])
        # each rank sampled its own shard: rank 0's kernels and channels on all
        mesh.broadcast_module_(cur)
        chn_masks = mesh.broadcast_from_primary(chn_masks)
        return self.set_extra(pruned, {'masks': kernel_masks(cur, chn_masks)})

    # ------------------------------------------------------------------

    def train(self) -> TrainState:
        self.require_dp_only('the meta-LASSO prune phase')
        state, tx, _ = self.init_state()
        if FLAGS.cpr_warm_start:
            state, _ = self.restore_baseline(state, FLAGS.cpr_save_path_ws)
        else:
            state, _ = self.restore_baseline(state)
        self._setup(state)
        state = self.prune_all_layers(state)
        grad_transform, post_update = masking.masked_update_hooks(state.model)
        loss_extra = self.helper_dst.loss_extra_fn() if self.helper_dst else None
        train_step = self.build_train_step(tx, loss_extra_fn=loss_extra,
                                           grad_transform_fn=grad_transform,
                                           post_update_fn=post_update)
        eval_step = self.build_eval_step()
        state = self.run_train_loop(state, train_step, save_path=FLAGS.cpr_save_path,
                                    eval_fn=lambda s: self.run_eval_loop(s, eval_step))
        self.run_eval_loop(state, eval_step)
        return state

    def evaluate(self) -> Dict[str, float]:
        state, _, _ = self.init_state()
        self._setup(state)
        masks = kernel_masks(state.model, {s['path']: torch.ones(s['kernel_shape'][2])
                                           for s in self.specs})
        state = self.set_extra(state, {'masks': masks})
        restored = self.restore_model(state, FLAGS.cpr_save_path)
        if restored is None:
            raise FileNotFoundError('no checkpoint found under ' + FLAGS.cpr_save_path)
        return self.run_eval_loop(restored, self.build_eval_step())
