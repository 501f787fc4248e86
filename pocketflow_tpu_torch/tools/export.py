"""Compressed-model export: the deployment artifact (counterpart of
pocketflow_tpu/tools/export.py).

The artifact is a packed ``.npz`` plus a JSON manifest, in the JAX
package's format ('/' -> '__' keys, quantized kernels as '#codes', '#alpha',
'#beta' arrays, their metadata under the manifest's 'quantized'), so either
package serves what the other wrote; beside it the eval forward as a
``torch.export`` program (``<output>.pt2``), where the JAX package writes
StableHLO.

* channel-pruned models: all-zero input channels leave the kernels, their
  indices go into the manifest (``shrink_channel_pruned``; the residual-
  aware producer shrink is tools/shrink_graph.py);
* quantized models: int codes + per-bucket (alpha, beta) scales
  (``pack_quantized``);
* BN folding (``fold_batch_norm``) and a numeric self-check against the live
  model.

The packing, folding and format functions are numpy copies of the JAX
package's and work on the numpy trees of ``core/bridge.to_jax_numpy``.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from pocketflow_tpu_torch.core.metrics import get_logger
from pocketflow_tpu_torch.learners.weight_sparsification import masking
from pocketflow_tpu_torch.tools.shrink_graph import tree_leaves

log = get_logger()


# ---------------------------------------------------------------------------
# channel-pruned export: physical kernel shrinking
# ---------------------------------------------------------------------------

def shrink_channel_pruned(params) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Remove all-zero input channels from conv kernels.

    Returns (packed, manifest): packed maps param path -> shrunk array; the
    manifest records the surviving input channels of each shrunk kernel.
    """
    packed, manifest = {}, {}
    for pstr, leaf in tree_leaves(params):
        arr = np.asarray(leaf)
        if masking.is_maskable_path(tuple(pstr.split('/'))) and arr.ndim == 4 \
                and arr.shape[2] > 1:
            norms = np.abs(arr).sum(axis=(0, 1, 3))
            keep = np.nonzero(norms > 0)[0]
            if keep.size < arr.shape[2]:
                arr = arr[:, :, keep, :]
                manifest[pstr] = {'kept_in_channels': keep.tolist(),
                                  'orig_in_channels': int(norms.size)}
        packed[pstr] = arr
    return packed, manifest


# ---------------------------------------------------------------------------
# batch-norm folding
# ---------------------------------------------------------------------------

def fold_batch_norm(params, batch_stats, epsilon: float = 1e-5):
    """Fold inference-mode BN into the preceding conv/dense kernels.

    W' = W * gamma / sqrt(var + eps) (per output channel); BN keeps the shift
    beta + (b - mean) * factor, its scale becomes 1, its mean 0 and its
    variance 1 - eps, so the same model definition serves the folded
    checkpoint.  Pairing by the zoo's names: 'convX'<->'bnX',
    'conv_init'<->'bn_init', 'dw'<->'bn_dw', 'pw'<->'bn_pw', 'pw_expand'<->
    'bn_expand', 'pw_project'<->'bn_project', 'pw_head'<->'bn_head'.

    Returns (params, batch_stats) as new numpy trees.
    """
    params = copy.deepcopy(params)
    batch_stats = copy.deepcopy(batch_stats)

    def bn_name_for(conv_name: str):
        if conv_name.startswith('conv'):
            return 'bn' + conv_name[len('conv'):]
        if conv_name.startswith('pw_'):
            return 'bn_' + conv_name[len('pw_'):]
        if conv_name in ('dw', 'pw'):
            return 'bn_' + conv_name
        return None

    def walk(pnode, snode):
        if not isinstance(pnode, dict):
            return
        for name in list(pnode.keys()):
            child = pnode[name]
            if not isinstance(child, dict):
                continue
            bn_name = bn_name_for(name)
            if ('kernel' in child and bn_name and bn_name in pnode
                    and isinstance(snode, dict) and bn_name in snode):
                bn_p = pnode[bn_name].get('bn', pnode[bn_name])
                bn_s = snode[bn_name].get('bn', snode[bn_name])
                gamma = np.asarray(bn_p.get('scale', 1.0), np.float32)
                beta = np.asarray(bn_p.get('bias', 0.0), np.float32)
                mean = np.asarray(bn_s['mean'], np.float32)
                var = np.asarray(bn_s['var'], np.float32)
                factor = gamma / np.sqrt(var + epsilon)
                kernel = np.asarray(child['kernel'], np.float32)
                child['kernel'] = (kernel * factor).astype(kernel.dtype)
                old_bias = np.asarray(child.get('bias', 0.0), np.float32)
                if 'bias' in child:
                    child['bias'] = np.zeros_like(old_bias)
                if 'bias' in bn_p:
                    bn_p['bias'] = (beta + (old_bias - mean) * factor).astype(np.float32)
                if 'scale' in bn_p:
                    bn_p['scale'] = np.ones_like(gamma)
                bn_s['mean'] = np.zeros_like(mean)
                # var' = 1 - eps so the BN's 1/sqrt(var' + eps) == 1
                bn_s['var'] = np.full_like(var, 1.0 - epsilon)
            walk(child, snode.get(name, {}) if isinstance(snode, dict) else {})

    walk(params, batch_stats)
    return params, batch_stats


# ---------------------------------------------------------------------------
# quantized export: integer packing
# ---------------------------------------------------------------------------

def pack_quantized(params, weight_paths, w_bit_list, bucket_type: Optional[str] = None,
                   bucket_size: int = 256) -> Dict[str, Any]:
    """Store quantized kernels as integer codes + (alpha, beta) scales."""
    packed = {}
    bits_of = dict(zip(weight_paths, w_bit_list))
    for pstr, leaf in tree_leaves(params):
        arr = np.asarray(leaf, np.float32)
        module = pstr[:-len('/kernel')] if pstr.endswith('/kernel') else None
        if module in bits_of and bits_of[module] < 32:
            bits = int(bits_of[module])
            k = 2 ** bits - 1
            if bucket_type == 'channel':
                cols = arr.reshape(-1, arr.shape[-1])
            elif bucket_type == 'split':
                flat = arr.reshape(-1)
                nb = -(-flat.size // bucket_size)
                pad = nb * bucket_size - flat.size
                flat = np.concatenate([flat, np.repeat(flat[-1:], pad)])
                cols = flat.reshape(bucket_size, nb)
            else:
                cols = arr.reshape(-1, 1)
            w_min = cols.min(axis=0)
            alpha = cols.max(axis=0) - w_min + 1e-10
            codes = np.round((cols - w_min) / alpha * k)
            dtype = np.uint8 if bits <= 8 else np.uint16
            packed[pstr] = {'codes': codes.astype(dtype), 'alpha': alpha, 'beta': w_min,
                            'bits': bits, 'shape': arr.shape, 'bucket_type': bucket_type,
                            'bucket_size': bucket_size}
        else:
            packed[pstr] = arr
    return packed


def unpack_quantized(packed: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Dequantize a packed dict back to fp32 arrays (serving-side load)."""
    out = {}
    for pstr, item in packed.items():
        if isinstance(item, dict) and 'codes' in item:
            k = 2 ** item['bits'] - 1
            cols = item['codes'].astype(np.float32) / k * item['alpha'] + item['beta']
            n = int(np.prod(item['shape']))
            out[pstr] = cols.reshape(-1)[:n].reshape(item['shape']) \
                if item['bucket_type'] == 'split' else cols.reshape(item['shape'])
        else:
            out[pstr] = item
    return out


# ---------------------------------------------------------------------------
# serving program export + self-check
# ---------------------------------------------------------------------------

def _eval_logits(model: torch.nn.Module, images: torch.Tensor) -> np.ndarray:
    was_training = model.training
    model.eval()
    with torch.no_grad():
        out = model(images).to(torch.float32).cpu().numpy()
    model.train(was_training)
    return out


def export_program(model: torch.nn.Module, sample_images: torch.Tensor, out_path: str) -> str:
    """Save the eval forward as a ``torch.export`` program (``torch.export.
    load(out_path).module()`` runs it), the counterpart of the JAX package's
    StableHLO module."""
    was_training = model.training
    try:
        program = torch.export.export(model.eval(), (sample_images,))
    finally:
        model.train(was_training)
    os.makedirs(os.path.dirname(out_path) or '.', exist_ok=True)
    torch.export.save(program, out_path)
    log.info('torch.export program written to %s (%d bytes)', out_path,
             os.path.getsize(out_path))
    return out_path


def numeric_self_check(model: torch.nn.Module, restored: torch.nn.Module,
                       sample_images: torch.Tensor) -> float:
    """Max |logits delta| between the live model and the one restored from
    the exported parameters, on the same images."""
    delta = float(np.max(np.abs(_eval_logits(model, sample_images)
                                - _eval_logits(restored, sample_images))))
    log.info('export self-check: max |logits delta| = %.3e', delta)
    return delta


def save_packed(packed: Dict[str, Any], manifest: Dict[str, Any], out_path: str) -> str:
    """Serialize a packed dict to .npz + a JSON manifest.

    Quantized entries (dicts with codes/alpha/beta) flatten to
    '<path>#codes' / '#alpha' / '#beta' arrays, their metadata recorded in the
    manifest, so ``load_packed`` reconstructs them losslessly."""
    os.makedirs(os.path.dirname(out_path) or '.', exist_ok=True)
    arrays, manifest = {}, dict(manifest)
    qmeta = {}
    for key, value in packed.items():
        flat_key = key.replace('/', '__')
        if isinstance(value, dict) and 'codes' in value:
            arrays[flat_key + '#codes'] = value['codes']
            arrays[flat_key + '#alpha'] = value['alpha']
            arrays[flat_key + '#beta'] = value['beta']
            qmeta[key] = {'bits': value['bits'], 'shape': list(value['shape']),
                          'bucket_type': value['bucket_type'],
                          'bucket_size': value['bucket_size']}
        else:
            arrays[flat_key] = value
    if qmeta:
        manifest['quantized'] = qmeta
    np.savez_compressed(out_path, **arrays)
    with open(out_path + '.manifest.json', 'w') as fout:
        json.dump(manifest, fout, indent=2, default=str)
    return out_path


def load_packed(out_path: str) -> Dict[str, Any]:
    """Inverse of save_packed: returns the packed dict."""
    path = out_path if out_path.endswith('.npz') else out_path + '.npz'
    with open(path + '.manifest.json') as fin:
        manifest = json.load(fin)
    qmeta = manifest.get('quantized', {})
    packed = {}
    with np.load(path) as blob:
        for flat_key in blob.files:
            key = flat_key.split('#')[0].replace('__', '/')
            if '#' in flat_key:
                item = packed.setdefault(key, dict(qmeta[key]))
                item['shape'] = tuple(item['shape'])
                item[flat_key.split('#')[1]] = blob[flat_key]
            else:
                packed[key] = blob[flat_key]
    return packed
