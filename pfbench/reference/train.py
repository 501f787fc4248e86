"""The reference's train steps: from the harness's weights, batches and
augmentation seeds, a step is the flip and normalization of the uint8
batch, the net's forward in training mode under the recipe, softmax cross
entropy plus the weight decay on the kernels, the gradient, and SGD with
momentum (the buffer the first gradient, then momentum * buffer +
gradient; the parameter minus the learning rate times the buffer).
Returns each step's loss, each leaf's first gradient and its change over
the steps (on the host) and their norms, as the comparison reads them.

``precision='fp8'`` is the control (every tensor the program stores in
bf16 stored in float8, ``reference/ops.py``); ``rows`` keeps the leading
rows of each batch (the fault that leaves half of the batch out)."""

from __future__ import annotations

import importlib
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from pfbench.reference import exact_float32
from pfbench.reference.ops import Ops

IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)
NETS = {'resnet_v1': 'pfbench.reference.resnet', 'mobilenet_v1': 'pfbench.reference.mobilenet_v1'}


def net(cfg: Dict):
    return importlib.import_module(NETS[cfg['arch']]).forward


def augment(images: torch.Tensor, seed: int) -> torch.Tensor:
    """A flip of each image with probability 1/2 (one uniform draw an image
    from a generator seeded with `seed` on the images' device, flipped
    under 0.5), then (x - mean) / std in float32."""
    gen = torch.Generator(device=images.device)
    gen.manual_seed(seed)
    flip = torch.rand(images.shape[0], generator=gen, device=images.device) < 0.5
    x = torch.where(flip[:, None, None, None], images.flip(2), images).to(torch.float32)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=images.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=images.device)
    return (x - mean) / std


def learning_rate(traffic: Dict, batch: int) -> float:
    """The quant finetune's first rate: lr_base * batch / batch_size_norm *
    lr_decay, rounded to float32."""
    args = traffic['recipe_args']
    return float(np.float32(args['lr_base'] * batch / args['batch_size_norm'] * args['lr_decay']))


def make_recipe(cfg: Dict, traffic: Dict, device):
    module = importlib.import_module('pfbench.reference.' + traffic['recipe'])
    if traffic['recipe'] == 'uniform_tf':
        return module.Recipe(cfg, traffic, device=device)
    return module.Recipe(cfg, traffic)


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.detach().double().norm()) for k, v in tensors.items()}


def run_steps(cfg: Dict, traffic: Dict, weights: Dict[str, torch.Tensor], batches: List[Dict],
              seeds: List[int], precision: str = 'fp32', rows: Optional[int] = None) -> Dict:
    exact_float32()
    device = batches[0]['image'].device
    params = {k: v.detach().to(device, torch.float32).clone() for k, v in weights.items()}
    trainable = [k for k in params if not k.endswith(('.bn.mean', '.bn.var'))]
    kernels = [k for k in trainable if k.endswith('.kernel')
               and not any('bn' in part for part in k.split('.'))]
    for k in trainable:
        params[k].requires_grad_(True)
    start = {k: params[k].detach().clone() for k in trainable}
    recipe = make_recipe(cfg, traffic, device)
    extra0 = {k: v.clone() for k, v in recipe.extra_leaves().items()}
    forward = net(cfg)
    lr = learning_rate(traffic, batches[0]['image'].shape[0])
    momentum = float(traffic['recipe_args']['momentum'])
    weight_decay = float(cfg['weight_decay'])
    buffers, losses, grad1 = {}, [], None
    for i, (batch, seed) in enumerate(zip(batches, seeds)):
        images = augment(batch['image'], seed)
        labels = batch['label'].long()
        if rows is not None:
            images, labels = images[:rows], labels[:rows]
        ops = Ops(params, train=True, epsilon=cfg['bn_epsilon'], weight_fn=recipe.weight_fn,
                  act_fn=recipe.act_fn, precision=precision)
        logits = forward(cfg, ops, images)
        loss = F.cross_entropy(logits, labels) + weight_decay * torch.stack(
            [params[k].square().sum() for k in kernels]).sum()
        grads = torch.autograd.grad(loss, [params[k] for k in trainable])
        with torch.no_grad():
            for k, g in zip(trainable, grads):
                buf = buffers.get(k)
                buffers[k] = g.clone() if buf is None else buf.mul_(momentum).add_(g)
                params[k].sub_(lr * buffers[k])
        recipe.after_update()
        losses.append(float(loss.detach()))
        if i == 0:
            grad1 = {k: v.detach().to('cpu', copy=True) for k, v in buffers.items()}
        del logits, loss, grads, ops
    change = {k: (params[k].detach() - start[k]).cpu() for k in trainable}
    change.update({k: (v - extra0[k]).cpu() for k, v in recipe.extra_leaves().items()})
    return {'losses': losses, 'grad1_t': grad1, 'change_t': change,
            'grad1': _norms(grad1), 'change': _norms(change)}
