"""The eval forward of a port net as TensorFlow ops: the port's stand-in for
jax2tf, which the JAX package's tools/export_tflite.py lowers through.

Two stages:

1. ``lower(model, sample_shape)`` needs no TensorFlow.  It takes
   ``torch.export.export(model.eval(), (x,))``, folds the parameters and
   buffers into numpy constants and returns a ``Plan``: an ordered list of op
   records over NHWC float32 values.  An ATen op outside ``_TABLE`` raises
   ``NotImplementedError`` naming the op and the node; nothing falls back.
2. ``emit_tf(plan)`` builds a ``tf.function`` of the plan from TF ops
   (``tf.nn.conv2d``, ``depthwise_conv2d``, ``max_pool2d``, ``matmul``, ...),
   which the TFLite converter and ``tf.saved_model`` take.

Layout.  The port's nets take NHWC images and permute them to NCHW views,
keep conv kernels in HWIO and permute them to OIHW at each call, and flatten
in NHWC order; TFLite's convs and pools are NHWC only.  So each value carries
its physical array with a tag, ``perm``, for its logical torch order
(logical axis i is physical axis perm[i]): a ``permute`` only changes the
tag, and the input permute, the kernel permutes (folded with the constants)
and the flatten permute cancel.  A real transpose is emitted only where an op
needs the logical order in another layout: a reshape of a permuted value (the
space-to-depth stem's 6-D permute) or two operands of an add that disagree.

'SAME' padding.  The nets pad 'SAME' windows with an explicit ``F.pad`` (0
before a conv, -inf before a max pool), putting the odd row and column at the
end, as TF's 'SAME' does.  A pad read only by a conv or a max pool whose
window it pads exactly so becomes that op's ``padding='SAME'``; any other pad
stays a pad op.
"""

from __future__ import annotations

import collections
import operator
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

aten = torch.ops.aten
NCHW_IN_NHWC = (0, 3, 1, 2)  # a logical NCHW value held as an NHWC array


@dataclass
class Op:
    """One TF op of a plan: `kind` applied to the values named `inputs`,
    its result named `out` (after the ATen node it lowers); `attrs` hold
    numpy constants and ints."""
    kind: str
    out: str
    inputs: Tuple[str, ...]
    attrs: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Plan:
    """The lowered forward: NHWC float32 `input_shape` in, the value named
    `output` out; `nb_nodes` ATen call nodes lowered."""
    input_name: str
    input_shape: Tuple[int, ...]
    ops: List[Op]
    output: str
    nb_nodes: int

    def counts(self) -> Dict[str, int]:
        """The plan's ops by kind."""
        return dict(sorted(collections.Counter(op.kind for op in self.ops).items()))


@dataclass(frozen=True)
class _Act:
    """A value computed from the input: the physical array's name, the
    logical (torch) shape and ``perm`` (logical axis i is physical axis
    perm[i])."""
    name: str
    perm: Tuple[int, ...]
    shape: Tuple[int, ...]


def _inverse(perm: Sequence[int]) -> Tuple[int, ...]:
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return tuple(inv)


def _same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF's 'SAME' padding of one axis (the odd pixel at the end), which
    nn/layers.same_pad reproduces."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _bind(node) -> Dict[str, Any]:
    """The node's arguments by schema name, defaults filled in."""
    bound = {}
    for i, arg in enumerate(node.target._schema.arguments):
        if i < len(node.args):
            bound[arg.name] = node.args[i]
        elif arg.name in node.kwargs:
            bound[arg.name] = node.kwargs[arg.name]
        elif arg.has_default_value():
            bound[arg.name] = arg.default_value
    return bound


def _pair(v) -> Tuple[int, int]:
    v = [int(x) for x in (v if isinstance(v, (list, tuple)) else [v])]
    return (v[0], v[0]) if len(v) == 1 else (v[0], v[1])


class _Lowering:
    """The state of one ``lower`` call: the value of each node and the ops
    emitted so far."""

    def __init__(self):
        self.values: Dict[Any, Any] = {}
        self.ops: List[Op] = []
        self.node = None

    def refuse(self, what: str):
        raise NotImplementedError('tf_lowering: %s at node %s (%s)'
                                  % (what, self.node.name, self.node.target))

    def value(self, arg):
        if isinstance(arg, torch.fx.Node):
            return self.values[arg]
        if isinstance(arg, (list, tuple)):
            return type(arg)(self.value(a) for a in arg)
        return arg

    def act(self, arg) -> _Act:
        v = self.value(arg)
        if not isinstance(v, _Act):
            self.refuse('an operand that must be computed from the input is %s' % type(v).__name__)
        return v

    def const(self, arg) -> Optional[np.ndarray]:
        v = self.value(arg)
        if isinstance(v, _Act):
            self.refuse('a weight computed from the input')
        return None if v is None else v.detach().to('cpu', torch.float32).numpy()

    def emit(self, kind, inputs, perm, logical, **attrs) -> _Act:
        """Append an op; its result has tag `perm` and logical shape `logical`."""
        out = '%s_%d' % (self.node.name, len(self.ops))
        self.ops.append(Op(kind, out, tuple(x.name for x in inputs), attrs))
        return _Act(out, tuple(perm), tuple(int(d) for d in logical))

    def layout(self, x: _Act, perm: Sequence[int]) -> _Act:
        """`x` held with tag `perm`: a transpose when its tag differs."""
        perm = tuple(perm)
        if x.perm == perm:
            return x
        inv = _inverse(perm)
        return self.emit('transpose', [x], perm, x.shape,
                         axes=tuple(x.perm[inv[j]] for j in range(len(perm))))

    def physical(self, c: np.ndarray, x: _Act) -> np.ndarray:
        """A constant that broadcasts against logical `x`, laid out like x's
        physical array."""
        c = np.asarray(c, np.float32)
        c = c.reshape((1,) * (len(x.shape) - c.ndim) + c.shape)
        return np.ascontiguousarray(np.transpose(c, _inverse(x.perm)))

    def out_shape(self) -> Tuple[int, ...]:
        return tuple(int(d) for d in self.node.meta['val'].shape)


# ---------------------------------------------------------------------------
# the op table: one handler for each ATen op the nets' eval forwards use
# ---------------------------------------------------------------------------

def _skip(lw, a):
    return None


def _to(lw, a):
    x = lw.act(a['self'])
    src = lw.node.args[0].meta['val'].dtype
    if a['dtype'] != torch.float32 or src != torch.float32:
        lw.refuse('a cast from %s to %s (TFLite builtins are float32)' % (src, a['dtype']))
    return x


def _permute(lw, a):
    x = lw.act(a['self'])
    dims = [d % len(x.shape) for d in a['dims']]
    return _Act(x.name, tuple(x.perm[d] for d in dims), lw.out_shape())


def _reshape(lw, a):
    x = lw.act(a['self'])
    x = lw.layout(x, range(len(x.shape)))
    shape = lw.out_shape()
    return lw.emit('reshape', [x], range(len(shape)), shape, shape=shape)


def _pad(lw, a):
    x = lw.act(a['self'])
    if a['mode'] != 'constant':
        lw.refuse("pad mode %r" % a['mode'])
    pad = [int(p) for p in a['pad']]
    if min(pad) < 0:
        lw.refuse('a negative pad')
    logical = [(0, 0)] * len(x.shape)
    for k in range(len(pad) // 2):
        logical[len(x.shape) - 1 - k] = (pad[2 * k], pad[2 * k + 1])
    paddings = [(0, 0)] * len(x.shape)
    for i, p in enumerate(x.perm):
        paddings[p] = logical[i]
    in_shape = tuple(x.shape[i] for i in _inverse(x.perm))
    return lw.emit('pad', [x], x.perm, lw.out_shape(), paddings=tuple(paddings),
                   value=float(a['value'] or 0.0), in_shape=in_shape)


def _conv2d(lw, a):
    x = lw.layout(lw.act(a['input']), NCHW_IN_NHWC)
    w = lw.const(a['weight'])
    bias = lw.const(a['bias'])
    if any(int(p) for p in a['padding']):
        lw.refuse('conv padding %s (the nets pad with an explicit F.pad)' % (a['padding'],))
    if any(int(d) != 1 for d in a['dilation']):
        lw.refuse('conv dilation %s' % (a['dilation'],))
    groups = int(a['groups'])
    attrs = dict(strides=_pair(a['stride']), padding='VALID', bias=bias)
    if groups == 1:
        kind, attrs['filter'] = 'conv2d', np.ascontiguousarray(w.transpose(2, 3, 1, 0))
    elif groups == x.shape[1] == w.shape[0] and w.shape[1] == 1:
        kind, attrs['filter'] = 'depthwise_conv2d', np.ascontiguousarray(w.transpose(2, 3, 0, 1))
    else:
        lw.refuse('a grouped conv of %d groups that is not depthwise' % groups)
    return lw.emit(kind, [x], NCHW_IN_NHWC, lw.out_shape(), **attrs)


def _batch_norm(lw, a):
    if a['training']:
        lw.refuse('train-mode batch norm')
    x = lw.act(a['input'])
    channels = x.shape[1]
    w, b = lw.const(a['weight']), lw.const(a['bias'])
    mean, var = lw.const(a['running_mean']), lw.const(a['running_var'])
    w = np.ones(channels, np.float32) if w is None else w
    b = np.zeros(channels, np.float32) if b is None else b
    scale = (w / np.sqrt(var + np.float32(a['eps']))).astype(np.float32)
    shift = (b - mean * scale).astype(np.float32)
    shape = [1] * len(x.shape)
    shape[1] = channels
    y = lw.emit('affine', [x], x.perm, x.shape,
                scale=lw.physical(scale.reshape(shape), x),
                shift=lw.physical(shift.reshape(shape), x))
    return (y, None, None)  # the batch statistics of eval mode are never read


def _binary(kind):
    def lower(lw, a):
        lhs, rhs = lw.value(a['self']), lw.value(a['other'])
        if a.get('alpha', 1) != 1:
            lw.refuse('add with alpha %r' % a['alpha'])
        if isinstance(lhs, _Act) and isinstance(rhs, _Act):
            if lhs.shape != rhs.shape:
                lw.refuse('a broadcast between two computed operands')
            return lw.emit(kind, [lhs, lw.layout(rhs, lhs.perm)], lhs.perm, lhs.shape)
        x, c = (lhs, rhs) if isinstance(lhs, _Act) else (rhs, lhs)
        c = c.detach().to('cpu', torch.float32).numpy() if torch.is_tensor(c) else np.float32(c)
        return lw.emit(kind + '_const', [x], x.perm, lw.out_shape(), const=lw.physical(c, x))
    return lower


def _relu(lw, a):
    x = lw.act(a['self'])
    return lw.emit('relu', [x], x.perm, x.shape)


def _clamp(lw, a):
    """clamp.default: scalar bounds (clamp.Tensor is not in the table)."""
    x = lw.act(a['self'])
    lo, hi = a['min'], a['max']
    return lw.emit('clamp', [x], x.perm, x.shape,
                   lo=None if lo is None else float(lo), hi=None if hi is None else float(hi))


def _max_pool(lw, a):
    x = lw.layout(lw.act(a['self']), NCHW_IN_NHWC)
    window = _pair(a['kernel_size'])
    strides = _pair(a['stride']) if len(a['stride']) else window
    if any(_pair(a['padding'])) or _pair(a['dilation']) != (1, 1) or a['ceil_mode']:
        lw.refuse('max pool padding/dilation/ceil_mode')
    return lw.emit('max_pool', [x], NCHW_IN_NHWC, lw.out_shape(), window=window,
                   strides=strides, padding='VALID')


def _mean(lw, a):
    x = lw.act(a['self'])
    if a.get('dtype') is not None:
        lw.refuse('mean with a dtype')
    dims = sorted({d % len(x.shape) for d in a['dim']})
    axes = tuple(sorted(x.perm[d] for d in dims))
    if a['keepdim']:
        perm = x.perm
    else:
        rest = [i for i in range(len(x.shape)) if i not in dims]
        kept = sorted(x.perm[i] for i in rest)
        perm = tuple(kept.index(x.perm[i]) for i in rest)
    return lw.emit('mean', [x], perm, lw.out_shape(), axes=axes, keepdims=bool(a['keepdim']))


def _matmul(lw, a):
    x = lw.act(a['self'])
    w = lw.const(a['other'])
    if len(x.shape) != 2 or w.ndim != 2:
        lw.refuse('a matmul of ranks %d and %d' % (len(x.shape), w.ndim))
    x = lw.layout(x, (0, 1))
    return lw.emit('matmul', [x], (0, 1), lw.out_shape(), weight=w)


_TABLE = {
    aten._assert_tensor_metadata.default: _skip,
    aten.to.dtype: _to,
    aten.permute.default: _permute,
    aten.reshape.default: _reshape,
    aten.unsqueeze.default: _reshape,
    aten.pad.default: _pad,
    aten.conv2d.default: _conv2d,
    aten.native_batch_norm.default: _batch_norm,
    aten.add.Tensor: _binary('add'),
    aten.minimum.default: _binary('minimum'),
    aten.relu.default: _relu,
    aten.clamp.default: _clamp,
    aten.max_pool2d.default: _max_pool,
    aten.mean.dim: _mean,
    aten.matmul.default: _matmul,
}


def _fuse_same_pads(ops: List[Op], output: str) -> List[Op]:
    """Fold each pad that only pads a conv's or a max pool's window as TF's
    'SAME' would (zeros for a conv, -inf for a max pool) into that op."""
    uses = collections.Counter(name for op in ops for name in op.inputs)
    uses[output] += 1
    pads = {op.out: op for op in ops if op.kind == 'pad'}
    fused = set()
    for op in ops:
        pad = pads.get(op.inputs[0]) if op.inputs else None
        if pad is None or uses[pad.out] != 1:
            continue
        if op.kind in ('conv2d', 'depthwise_conv2d'):
            window, value = op.attrs['filter'].shape[:2], 0.0
        elif op.kind == 'max_pool':
            window, value = op.attrs['window'], float('-inf')
        else:
            continue
        (_, h, w, _), (sh, sw) = pad.attrs['in_shape'], op.attrs['strides']
        want = ((0, 0), _same_pads(h, window[0], sh), _same_pads(w, window[1], sw), (0, 0))
        if pad.attrs['value'] == value and tuple(pad.attrs['paddings']) == want:
            op.inputs = pad.inputs
            op.attrs['padding'] = 'SAME'
            fused.add(pad.out)
    return [op for op in ops if op.out not in fused]


def lower(model: torch.nn.Module, sample_shape: Sequence[int]) -> Plan:
    """Stage 1: the plan of `model`'s eval forward on float32 NHWC images of
    `sample_shape`, on the model's device.  Raises NotImplementedError on an
    op outside the table."""
    device = next(model.parameters()).device
    was_training = model.training
    try:
        exported = torch.export.export(
            model.eval(), (torch.zeros(tuple(sample_shape), dtype=torch.float32, device=device),))
    finally:
        model.train(was_training)
    sig = exported.graph_signature
    tensors = {**exported.state_dict, **exported.constants}
    named = {**sig.inputs_to_parameters, **sig.inputs_to_buffers,
             **sig.inputs_to_lifted_tensor_constants}
    lw = _Lowering()
    input_name, output, nb_nodes = None, None, 0
    for node in exported.graph.nodes:
        lw.node = node
        if node.op == 'placeholder':
            if node.name in named:
                lw.values[node] = tensors[named[node.name]]
            elif node.name in sig.user_inputs and input_name is None:
                input_name = node.name
                lw.values[node] = _Act(node.name, tuple(range(len(sample_shape))),
                                       tuple(int(d) for d in sample_shape))
            else:
                lw.refuse('a second input')
        elif node.op == 'call_function':
            nb_nodes += 1
            if node.target is operator.getitem:
                lw.values[node] = lw.value(node.args[0])[node.args[1]]
                continue
            handler = _TABLE.get(node.target)
            if handler is None:
                lw.refuse('no TF lowering for this op')
            args = _bind(node)
            if any(isinstance(v, _Act) for v in _flat(lw.value(list(args.values())))):
                lw.values[node] = handler(lw, args)
            else:  # every operand a constant: fold it, with the op itself
                lw.values[node] = node.target(*lw.value(list(node.args)),
                                              **{k: lw.value(v) for k, v in node.kwargs.items()})
        elif node.op == 'output':
            outs = list(_flat(node.args[0]))
            if len(outs) != 1:
                lw.refuse('%d outputs' % len(outs))
            y = lw.act(outs[0])
            output = lw.layout(y, range(len(y.shape))).name
        else:
            lw.refuse('a %s node' % node.op)
    return Plan(input_name, tuple(int(d) for d in sample_shape),
                _fuse_same_pads(lw.ops, output), output, nb_nodes)


def _flat(obj):
    if isinstance(obj, (list, tuple)):
        for item in obj:
            yield from _flat(item)
    else:
        yield obj


# ---------------------------------------------------------------------------
# stage 2: TensorFlow
# ---------------------------------------------------------------------------

def _tf():
    try:
        import tensorflow as tf  # local import: TF is needed only to emit
    except ImportError as exc:  # pragma: no cover - env without TF
        raise RuntimeError('the TF lowering needs the optional tensorflow dependency '
                           '(used only for the converter/interpreter)') from exc
    return tf


def _emitters(tf):
    def conv(x, op):
        sh, sw = op.attrs['strides']
        if op.kind == 'conv2d':
            y = tf.nn.conv2d(x, op.attrs['filter'], [1, sh, sw, 1], op.attrs['padding'])
        else:
            y = tf.nn.depthwise_conv2d(x, op.attrs['filter'], [1, sh, sw, 1],
                                       op.attrs['padding'])
        return y if op.attrs['bias'] is None else tf.nn.bias_add(y, op.attrs['bias'])

    def clamp(x, op):
        if op.attrs['lo'] is not None:
            x = tf.maximum(x, op.attrs['lo'])
        return x if op.attrs['hi'] is None else tf.minimum(x, op.attrs['hi'])

    return {
        'transpose': lambda x, op: tf.transpose(x, op.attrs['axes']),
        'reshape': lambda x, op: tf.reshape(x, op.attrs['shape']),
        'pad': lambda x, op: tf.pad(x, op.attrs['paddings'], constant_values=op.attrs['value']),
        'conv2d': conv,
        'depthwise_conv2d': conv,
        'affine': lambda x, op: x * op.attrs['scale'] + op.attrs['shift'],
        'add': lambda x, y, op: x + y,
        'add_const': lambda x, op: x + op.attrs['const'],
        'minimum': lambda x, y, op: tf.minimum(x, y),
        'minimum_const': lambda x, op: tf.minimum(x, op.attrs['const']),
        'relu': lambda x, op: tf.nn.relu(x),
        'clamp': clamp,
        'max_pool': lambda x, op: tf.nn.max_pool2d(x, op.attrs['window'], op.attrs['strides'],
                                                   op.attrs['padding']),
        'mean': lambda x, op: tf.reduce_mean(x, axis=op.attrs['axes'],
                                             keepdims=op.attrs['keepdims']),
        'matmul': lambda x, op: tf.matmul(x, op.attrs['weight']),
    }


def emit_tf(plan: Plan, input_name: str = 'images'):
    """Stage 2: a ``tf.function`` of `plan` over one float32 input of the
    plan's shape named `input_name`."""
    tf = _tf()
    emit = _emitters(tf)

    def forward(images):
        env = {plan.input_name: images}
        for op in plan.ops:
            env[op.out] = emit[op.kind](*[env[name] for name in op.inputs], op)
        return env[plan.output]

    return tf.function(forward, autograph=False, input_signature=[
        tf.TensorSpec(plan.input_shape, tf.float32, name=input_name)])
