"""Residual-aware physical channel shrink (counterpart of
pocketflow_tpu/tools/shrink_graph.py).

A channel pruned from every consumer of a producer conv can leave the
producer too, across skip connections: the physically smaller convs a
channel-pruned export serves.  The JAX package captures the conv graph from
the jaxpr of the eval forward; the port walks the ATen graph of
``torch.export.export(model.eval(), (x,))``:

1. placeholders map to parameter names through the graph signature
   (``conv_init.kernel`` -> 'conv_init/kernel'); a kernel reaches its conv
   through ``aten.to`` and ``aten.permute`` (HWIO -> OIHW), which carry the
   parameter's identity;
2. each value carries a *channel provenance* (which convs' output channels
   its channel axis holds) and the position of that axis: 1 for NCHW
   activations, the last axis after a pooled mean; a permute moves it.
   Elementwise ops, batch norm, 'SAME' pads and pooling over spatial axes,
   spatial means and reshapes that keep the axis preserve it; a residual
   ``add`` merges two producer sets; a depthwise conv (``conv2d`` with
   groups == C) passes it through; anything that mixes the channel axis
   breaks it.  relu6 is ``minimum(relu(x), 6)`` with a lifted constant, the
   JAX package's ``min`` branch.  The space-to-depth stem breaks it, so the
   stem conv reads no producer, as the image itself;
3. every conv/dense input is a site (consumer kernel path, producer set,
   clean?); producers read through a broken path or by the model's output
   are *protected*.

``shrink_residual_aware`` and the rest work on the Flax-style numpy trees of
``core/bridge.to_jax_numpy``, numpy copies of the JAX package's functions,
so both packages shrink the same parameters into the same packed arrays and
manifest.  One difference: where every channel of a component is dead (a
pruner left a consumer no input channel), its first channel stays, since a
conv of width 0 cannot run; the JAX package slices such a component to
width 0, which its own scatter-back check then refuses.
"""

from __future__ import annotations

import copy
import operator
from dataclasses import dataclass, field
from typing import Any, Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pocketflow_tpu_torch.core.metrics import get_logger

log = get_logger()

# ---------------------------------------------------------------------------
# provenance lattice
# ---------------------------------------------------------------------------

BROKEN = ('broken',)
INPUT = ('input',)


def _merge_prov(a, b):
    """Join two channel provenances (for residual adds)."""
    if a is None:
        return b
    if b is None:
        return a
    if a == BROKEN or b == BROKEN or a == INPUT or b == INPUT:
        return BROKEN
    return ('merge', frozenset(_producers(a) | _producers(b)))


def _producers(prov) -> FrozenSet[str]:
    if prov is None or prov in (BROKEN, INPUT):
        return frozenset()
    if prov[0] == 'conv':
        return frozenset([prov[1]])
    return prov[1]


def _clean(prov) -> bool:
    return prov is not None and prov not in (BROKEN, INPUT) and len(_producers(prov)) > 0


@dataclass
class ConsumerSite:
    """One conv/dense input site: which producers feed its channel axis."""
    consumer: str                 # kernel param path (module path)
    producers: FrozenSet[str]
    clean: bool                   # provenance was unbroken conv/merge
    in_dim: int                   # kernel axis indexing input channels (HWIO / [in, out])
    depthwise: bool = False


@dataclass
class ConvGraph:
    sites: List[ConsumerSite] = field(default_factory=list)
    protected: set = field(default_factory=set)   # producers we must not shrink
    depthwise: set = field(default_factory=set)   # depthwise kernel paths


# ---------------------------------------------------------------------------
# ATen graph capture
# ---------------------------------------------------------------------------

# ops that keep the channel identity of their first operand (the JAX
# package's elementwise list, casts and copies, batch norm); any op of no
# branch below protects what it reads
_PASS = {
    'to', '_to_copy', 'clone', 'contiguous', 'detach', 'alias', 'relu', 'sigmoid', 'tanh',
    'exp', 'log', 'rsqrt', 'sqrt', 'abs', 'sign', 'floor', 'ceil', 'round', 'neg', 'pow', 'erf',
    'native_batch_norm',
}
# two tensor operands: the merge/protect logic
_BINARY = {'add', 'sub', 'mul', 'div', 'maximum', 'minimum'}
_POOL = {'max_pool2d', 'avg_pool2d'}
_REDUCE = {'mean', 'sum'}
_RESHAPE = {'view', 'reshape', '_unsafe_view', 'flatten', 'squeeze', 'unsqueeze'}


def _op_name(node) -> str:
    """'conv2d' for aten.conv2d.default."""
    if node.target is operator.getitem:
        return 'getitem'
    name = getattr(node.target, '__name__', str(node.target))
    return name.split('.')[0]


def _shape(value) -> Tuple[int, ...]:
    val = value.meta.get('val') if hasattr(value, 'meta') else None
    return tuple(int(d) for d in val.shape) if isinstance(val, torch.Tensor) else ()


def _nodes(obj) -> List[torch.fx.Node]:
    """The graph nodes inside nested args."""
    if isinstance(obj, torch.fx.Node):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [n for item in obj for n in _nodes(item)]
    if isinstance(obj, dict):
        return [n for item in obj.values() for n in _nodes(item)]
    return []


def _reshape_axis(src: Sequence[int], dst: Sequence[int], axis: int) -> Optional[int]:
    """The axis of `dst` that holds `src`'s axis after a row-major reshape
    (same size, same product of the sizes before it), or None."""
    before = int(np.prod(src[:axis]))
    for j, size in enumerate(dst):
        if size == src[axis] and int(np.prod(dst[:j])) == before:
            return j
    return None


def capture_conv_graph(model: torch.nn.Module, sample_shape: Sequence[int],
                       dtype: torch.dtype = torch.float32) -> ConvGraph:
    """Export the eval forward of NHWC images of `sample_shape` and extract
    the conv producer/consumer graph."""
    device = next(model.parameters()).device
    was_training = model.training
    try:
        exported = torch.export.export(
            model.eval(), (torch.zeros(tuple(sample_shape), dtype=dtype, device=device),))
    finally:
        model.train(was_training)
    signature = exported.graph_signature
    params = {name: target.replace('.', '/')
              for name, target in signature.inputs_to_parameters.items()}

    prov: Dict[Any, Any] = {}      # node -> channel provenance
    axis: Dict[Any, int] = {}      # node -> position of its channel axis
    param_of: Dict[Any, str] = {}  # node -> parameter path (weight tracking)
    graph = ConvGraph()

    def protect(p):
        graph.protected.update(_producers(p))

    def get(v):
        return prov.get(v) if isinstance(v, torch.fx.Node) else None

    def set_out(node, p, ax):
        if p is not None:
            prov[node], axis[node] = p, ax

    def take_over(node, src):
        """`node` keeps `src`'s provenance, axis and parameter identity."""
        if not isinstance(src, torch.fx.Node):
            return
        if src in prov:
            # a broadcast to a higher rank adds leading axes
            rank_gap = len(_shape(node)) - len(_shape(src)) if _shape(src) else 0
            set_out(node, prov[src], axis[src] + max(rank_gap, 0))
        if src in param_of:
            param_of[node] = param_of[src]

    def site_input(x):
        """The provenance a contraction reads: broken (its producers
        protected) unless the channel axis is the one it contracts."""
        p = get(x)
        if p is not None and axis[x] != (1 if len(_shape(x)) == 4 else len(_shape(x)) - 1):
            protect(p)
            return BROKEN
        return p

    def module_of(w) -> Optional[str]:
        kpath = param_of.get(w) if isinstance(w, torch.fx.Node) else None
        return kpath[:-len('/kernel')] if kpath and kpath.endswith('/kernel') else kpath

    for node in exported.graph.nodes:
        if node.op == 'placeholder':
            if node.name in params:
                param_of[node] = params[node.name]
            elif node.name in signature.user_inputs:
                set_out(node, INPUT, len(_shape(node)) - 1)  # NHWC images
            continue
        if node.op == 'output':  # the logits' producer (the head) is protected
            for out in _nodes(node.args):
                graph.protected.update(_producers(get(out)))
            continue
        if node.op != 'call_function':
            continue
        name = _op_name(node)
        args = node.args
        if name == '_assert_tensor_metadata':
            continue

        if name == 'conv2d':
            x, w = args[0], args[1]
            groups = node.kwargs.get('groups', args[6] if len(args) > 6 else 1)
            module = module_of(w)
            in_prov = site_input(x)
            if module is None:
                protect(in_prov)
                set_out(node, BROKEN, 1)
            elif groups > 1 and _shape(w)[1] == 1:
                # depthwise: channels map 1:1 input -> output
                graph.depthwise.add(module)
                graph.sites.append(ConsumerSite(module, _producers(in_prov), _clean(in_prov),
                                                in_dim=3, depthwise=True))
                set_out(node, in_prov, 1)
            elif groups == 1:
                graph.sites.append(ConsumerSite(module, _producers(in_prov), _clean(in_prov),
                                                in_dim=2))
                set_out(node, ('conv', module), 1)
            else:
                protect(in_prov)
                set_out(node, BROKEN, 1)
            continue

        if name == 'matmul':
            x, w = args[0], args[1]
            module = module_of(w)
            if module is not None and len(_shape(w)) == 2:
                in_prov = site_input(x)
                graph.sites.append(ConsumerSite(module, _producers(in_prov), _clean(in_prov),
                                                in_dim=0))
                set_out(node, ('conv', module), len(_shape(node)) - 1)
            else:
                protect(get(x))
                protect(get(w))
                set_out(node, BROKEN, len(_shape(node)) - 1)
            continue

        if name in _BINARY:
            a, b = args[0], args[1]
            pa, pb = get(a), get(b)
            if pa is not None and pb is not None:
                if _shape(a) == _shape(b) and axis[a] == axis[b]:
                    merged = _merge_prov(pa, pb)      # residual merge
                    if merged == BROKEN:
                        # one side untracked (BROKEN/INPUT): the other side's
                        # producers are still read here
                        protect(pa)
                        protect(pb)
                    set_out(node, merged, axis[a])
                else:
                    # both tracked, channel axes not alignable (gating)
                    protect(pa)
                    protect(pb)
                    set_out(node, BROKEN, 1)
            else:
                # broadcast with per-channel params or scalars: pass through
                take_over(node, a if pa is not None else b)
            wp = (param_of.get(a) if isinstance(a, torch.fx.Node) else None) or (
                param_of.get(b) if isinstance(b, torch.fx.Node) else None)
            if wp is not None:
                param_of[node] = wp
            continue

        if name in _PASS:
            take_over(node, args[0])
            continue

        if name == 'getitem':
            src, index = args
            if index == 0:
                take_over(node, src)
            continue

        if name in _POOL:
            src = args[0]
            p = get(src)
            if p is not None and axis[src] == 1:
                set_out(node, p, 1)
            elif p is not None:
                protect(p)
                set_out(node, BROKEN, 1)
            continue

        if name in _REDUCE:
            src = args[0]
            p = get(src)
            rank = len(_shape(src))
            dims = args[1] if len(args) > 1 else None  # none: every axis
            dims = sorted(d % rank for d in ([dims] if isinstance(dims, int) else dims or range(rank)))
            keepdim = bool(args[2] if len(args) > 2 else node.kwargs.get('keepdim', False))
            if p is not None:
                if axis[src] in dims:
                    protect(p)
                else:
                    shift = 0 if keepdim else sum(d < axis[src] for d in dims)
                    set_out(node, p, axis[src] - shift)
            continue

        if name in _RESHAPE or name == 'permute':
            src = args[0]
            if src in param_of:
                param_of[node] = param_of[src]
            p = get(src)
            if p is None:
                continue
            if name == 'permute':
                set_out(node, p, list(args[1]).index(axis[src]))
                continue
            new_axis = _reshape_axis(_shape(src), _shape(node), axis[src])
            if new_axis is None:
                protect(p)
                set_out(node, BROKEN, 1)
            else:
                set_out(node, p, new_axis)
            continue

        if name == 'pad':
            src, pads = args[0], list(args[1])
            p = get(src)
            if p is None:
                continue
            pair = len(_shape(src)) - 1 - axis[src]  # the pad pair of the channel axis
            if pair < len(pads) // 2 and (pads[2 * pair], pads[2 * pair + 1]) != (0, 0):
                protect(p)
                set_out(node, BROKEN, 1)
            else:
                set_out(node, p, axis[src])
            continue

        # anything else: conservatively protect every tracked operand
        tracked = [get(v) for v in _nodes((args, node.kwargs)) if get(v) is not None]
        for p in tracked:
            if p != INPUT:
                protect(p)
        if tracked:
            set_out(node, BROKEN, 1)
    return graph


# ---------------------------------------------------------------------------
# the shrink (numpy trees, as the JAX package's)
# ---------------------------------------------------------------------------

class _UnionFind:
    def __init__(self):
        self.parent = {}

    def find(self, x):
        self.parent.setdefault(x, x)
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb


def tree_leaves(tree: Dict[str, Any], prefix: str = '') -> List[Tuple[str, Any]]:
    """('a/b/c', leaf) pairs of a nested dict in sorted key order (the order
    of ``jax.tree_util.tree_leaves_with_path``)."""
    out = []
    for key in sorted(tree):
        path = '%s/%s' % (prefix, key) if prefix else str(key)
        value = tree[key]
        if isinstance(value, dict):
            out.extend(tree_leaves(value, path))
        else:
            out.append((path, value))
    return out


def _copy_tree(tree):
    return {k: _copy_tree(v) if isinstance(v, dict) else v for k, v in tree.items()}


def _get_module(tree: dict, module_path: str) -> Optional[dict]:
    node = tree
    for part in module_path.split('/'):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node if isinstance(node, dict) else None


def _bn_candidates(module_path: str) -> List[str]:
    """BN module paths that normalize `module_path`'s output (zoo naming)."""
    parts = module_path.split('/')
    name = parts[-1]
    parent = parts[:-1]
    outs = []
    if name.startswith('conv'):
        outs.append('/'.join(parent + ['bn' + name[len('conv'):]]))
    if name.startswith('pw_'):
        outs.append('/'.join(parent + ['bn_' + name[len('pw_'):]]))
    if name in ('dw', 'pw'):
        outs.append('/'.join(parent + ['bn_' + name]))
    return outs


def shrink_residual_aware(params, batch_stats, graph: ConvGraph
                          ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Slice dead channels out of producers AND consumers, residual-aware.

    `params` and `batch_stats` are numpy trees (``to_jax_numpy``); they are
    not modified.  Returns (packed, manifest): packed maps param path ->
    (possibly smaller) array covering both trees (batch_stats paths prefixed
    'batch_stats/'); manifest records each component's kept channels, its
    producer and consumer slices, and the depthwise kernels.
    """
    params = _copy_tree(params)
    batch_stats = _copy_tree(batch_stats)

    # 1. components over producers (joined through shared sites)
    uf = _UnionFind()
    sites_by_producer: Dict[str, List[ConsumerSite]] = {}
    for site in graph.sites:
        if not site.clean or not site.producers:
            for p in site.producers:
                graph.protected.add(p)
            continue
        plist = sorted(site.producers)
        for p in plist[1:]:
            uf.union(plist[0], p)
        for p in plist:
            sites_by_producer.setdefault(p, []).append(site)

    components: Dict[str, set] = {}
    for p in sites_by_producer:
        components.setdefault(uf.find(p), set()).add(p)

    def dead_channels(site: ConsumerSite) -> Optional[np.ndarray]:
        module = _get_module(params, site.consumer)
        if module is None or 'kernel' not in module:
            return None
        k = np.asarray(module['kernel'])
        if site.depthwise:
            norms = np.abs(k).sum(axis=tuple(i for i in range(k.ndim) if i != 3))
        elif k.ndim == 4:
            norms = np.abs(k).sum(axis=(0, 1, 3))
        elif k.ndim == 2:
            norms = np.abs(k).sum(axis=1)
        else:
            return None
        return norms == 0.0

    manifest: Dict[str, Any] = {'components': [], 'leaf_slices': {},
                                'depthwise': sorted(graph.depthwise)}

    def record_slice(module_path: str, leaf: str, axis: int, comp_idx: int,
                     in_stats: bool = False):
        pstr = ('batch_stats/' if in_stats else '') + module_path + '/' + leaf
        manifest['leaf_slices'].setdefault(pstr, []).append([axis, comp_idx])

    for root, producers in sorted(components.items()):
        if producers & graph.protected:
            continue
        sites = []
        seen = set()
        for p in producers:
            for s in sites_by_producer[p]:
                key = (s.consumer, s.in_dim)
                if key not in seen:
                    seen.add(key)
                    sites.append(s)
        # dead channels: the intersection over the real consumer sites;
        # depthwise sites pass channels through and are only sliced
        dead = None
        ok = True
        for s in sites:
            if s.depthwise:
                continue
            d = dead_channels(s)
            if d is None:
                ok = False
                break
            dead = d if dead is None else (dead & d)
        if not ok or dead is None or not dead.any():
            continue
        if dead.all():  # no conv runs at width 0: one dead channel stays (it adds exactly 0)
            dead[0] = False
        keep = np.nonzero(~dead)[0]
        nb_orig = int(dead.size)

        prod_ok = True
        for p in producers:
            module = _get_module(params, p)
            if module is None or 'kernel' not in module \
                    or np.asarray(module['kernel']).shape[-1] != nb_orig:
                prod_ok = False
                break
        if not prod_ok:
            continue

        comp_idx = len(manifest['components'])
        comp_record = {'producers': sorted(producers),
                       'consumers': sorted({s.consumer for s in sites}),
                       'kept_channels': keep.tolist(),
                       'orig_channels': nb_orig}

        def slice_bias_and_bn(module_path: str):
            """A module's bias and its BN params/stats sliced to `keep`."""
            module = _get_module(params, module_path)
            if 'bias' in module:
                module['bias'] = np.asarray(module['bias'])[keep]
                record_slice(module_path, 'bias', 0, comp_idx)
            for bn_path in _bn_candidates(module_path):
                bn_p = _get_module(params, bn_path)
                if bn_p is not None:
                    inner = 'bn' if 'bn' in bn_p else None
                    bn_p = bn_p.get('bn', bn_p)
                    for key in ('scale', 'bias'):
                        if key in bn_p:
                            bn_p[key] = np.asarray(bn_p[key])[keep]
                            record_slice(bn_path + ('/bn' if inner else ''), key, 0, comp_idx)
                bn_s = _get_module(batch_stats, bn_path)
                if bn_s is not None:
                    inner = 'bn' if 'bn' in bn_s else None
                    bn_s = bn_s.get('bn', bn_s)
                    for key in ('mean', 'var'):
                        if key in bn_s:
                            bn_s[key] = np.asarray(bn_s[key])[keep]
                            record_slice(bn_path + ('/bn' if inner else ''), key, 0, comp_idx,
                                         in_stats=True)

        for p in sorted(producers):  # kernel out-dim, bias, BN params/stats
            module = _get_module(params, p)
            k = np.asarray(module['kernel'])
            module['kernel'] = k[..., keep]
            record_slice(p, 'kernel', k.ndim - 1, comp_idx)
            slice_bias_and_bn(p)
        for s in sites:  # kernel in-dim (depthwise also its output side)
            module = _get_module(params, s.consumer)
            k = np.asarray(module['kernel'])
            module['kernel'] = np.take(k, keep, axis=s.in_dim)
            record_slice(s.consumer, 'kernel', s.in_dim, comp_idx)
            if s.depthwise:
                slice_bias_and_bn(s.consumer)
        manifest['components'].append(comp_record)

    packed = {path: np.asarray(leaf) for path, leaf in tree_leaves(params)}
    for path, leaf in tree_leaves(batch_stats):
        packed['batch_stats/' + path] = np.asarray(leaf)
    nb = sum(len(c['kept_channels']) for c in manifest['components'])
    log.info('residual-aware shrink: %d components, %d channels kept of %d originals',
             len(manifest['components']), nb,
             sum(c['orig_channels'] for c in manifest['components']))
    return packed, manifest


def expand_to_dense(packed: Dict[str, Any], manifest: Dict[str, Any],
                    like_params, like_batch_stats):
    """Scatter a shrunk tree back to the original dense shapes (zeros in the
    removed channels), for the exact-equality export self-check."""
    params = copy.deepcopy(like_params)
    batch_stats = copy.deepcopy(like_batch_stats)

    def set_leaf(tree, pstr, value):
        parts = pstr.split('/')
        node = tree
        for part in parts[:-1]:
            node = node[part]
        node[parts[-1]] = value

    def get_shape(tree, pstr):
        node = tree
        for part in pstr.split('/'):
            node = node[part]
        return np.shape(node)

    leaf_slices = manifest.get('leaf_slices', {})
    for pstr, arr in packed.items():
        tree = batch_stats if pstr.startswith('batch_stats/') else params
        rel = pstr[len('batch_stats/'):] if pstr.startswith('batch_stats/') else pstr
        target_shape = get_shape(tree, rel)
        sub = np.asarray(arr)
        if sub.shape == tuple(target_shape):
            set_leaf(tree, rel, sub)
            continue
        # scatter with the exact slices recorded at shrink time
        dense = np.zeros(target_shape, sub.dtype)
        idx: List[Any] = [np.arange(n) for n in target_shape]
        for axis, comp_idx in leaf_slices.get(pstr, []):
            idx[axis] = np.asarray(manifest['components'][comp_idx]['kept_channels'])
        dense[np.ix_(*idx)] = sub
        set_leaf(tree, rel, dense)
    return params, batch_stats


# ---------------------------------------------------------------------------
# the shrunk serving net
# ---------------------------------------------------------------------------

def width_map_from_packed(packed: Dict[str, Any],
                          manifest: Optional[Dict[str, Any]] = None) -> Dict[str, int]:
    """Per-module output-channel counts of a shrunk packed tree, the zoo
    nets' ``width_map`` (depthwise kernels are left out: their width follows
    their input).  With the shrink's manifest the depthwise kernels are the
    captured graph's; without it a kernel with one input channel counts as
    depthwise."""
    depthwise = set(manifest.get('depthwise', ())) if manifest else None
    wm = {}
    for pstr, arr in packed.items():
        if pstr.startswith('batch_stats/') or not pstr.endswith('/kernel'):
            continue
        arr = np.asarray(arr)
        if arr.ndim != 4:
            continue
        module = pstr[:-len('/kernel')]
        if depthwise is not None:
            if module + '/kernel' in depthwise or module in depthwise:
                continue
        elif arr.shape[2] == 1:
            continue
        wm[module] = int(arr.shape[-1])
    return wm


def variables_from_packed(packed: Dict[str, Any]) -> Dict[str, Any]:
    """Nest a packed path->array dict back into {'params', 'batch_stats'}."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def insert(tree, pstr, value):
        parts = pstr.split('/')
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.asarray(value)

    for pstr, arr in packed.items():
        if pstr.startswith('batch_stats/'):
            insert(stats, pstr[len('batch_stats/'):], arr)
        else:
            insert(params, pstr, arr)
    return {'params': params, 'batch_stats': stats}
