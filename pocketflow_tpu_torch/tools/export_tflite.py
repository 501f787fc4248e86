"""TFLite and SavedModel export (counterpart of
pocketflow_tpu/tools/export_tflite.py).

The eval forward, with the weights as constants, is lowered to plain TF ops
by tools/tf_lowering.py (the JAX package lowers through jax2tf), converted by
``tf.lite.TFLiteConverter`` to TFLite builtins, optionally
post-training-quantized (dynamic-range, or full int8 calibrated on a
representative dataset), numerically self-checked against the live model,
and latency-benchmarked with the TFLite interpreter (100 warm-up and 100
timed invocations).

A forward here is a module that maps NHWC float32 images to logits: the
model itself in eval mode, or one of ``build_qat_deploy_forward``'s.
`variables` is None (the model's own parameters) or the Flax-style
``{'params', 'batch_stats'}`` trees of numpy arrays that core/bridge maps
(a JAX checkpoint's, or ``to_jax_numpy``'s), loaded into a copy of the
model.  TensorFlow is imported only inside the functions that convert, save
or run an artifact; the converter and the interpreter are host programs.
"""

from __future__ import annotations

import contextlib
import copy
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from pocketflow_tpu_torch.core.metrics import get_logger
from pocketflow_tpu_torch.nn.layers import CompressionPolicy, compression
from pocketflow_tpu_torch.tools import tf_lowering

log = get_logger()

QUANT_MODES = ('none', 'dynamic', 'int8')


def _tf():
    try:
        import tensorflow as tf  # local import: TF is optional at runtime
    except ImportError as exc:  # pragma: no cover - env without TF
        raise RuntimeError(
            'TFLite export needs the optional tensorflow dependency '
            '(used only for the converter/interpreter)') from exc
    return tf


class _PolicyForward(torch.nn.Module):
    """`model`'s eval forward (`model` is set to eval mode) under the policy
    `make_policy()` builds anew for each call (None: no policy)."""

    def __init__(self, model: torch.nn.Module, make_policy: Callable = lambda: None):
        super().__init__()
        self.model = model
        self.make_policy = make_policy
        self.eval()

    def forward(self, images):
        with compression(self.make_policy()):
            return self.model(images)


def _with_variables(model: torch.nn.Module, variables) -> torch.nn.Module:
    """`model`, or a copy of it holding `variables` (Flax-style trees)."""
    if variables is None:
        return model
    from pocketflow_tpu_torch.core.bridge import load_jax_numpy
    return load_jax_numpy(copy.deepcopy(model), variables['params'],
                          variables.get('batch_stats', {}))


def _frozen_forward(model, variables):
    """The eval forward with the weights closed over as constants."""
    return _PolicyForward(_with_variables(model, variables))


@contextlib.contextmanager
def _fp32_reference(device: torch.device):
    """On the card, convs and matmuls in full fp32 for the block: cuDNN's
    default TF32 would move the reference by ~1e-3 relative, and the check
    must compare the artifact against the fp32 function."""
    if device.type != 'cuda':
        yield
        return
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _reference(forward: torch.nn.Module, images) -> np.ndarray:
    """`forward`'s fp32 logits of `images` (numpy or a tensor) on its device."""
    device = next(forward.parameters()).device
    x = torch.as_tensor(_host(images), device=device)
    with torch.no_grad(), _fp32_reference(device):
        return forward(x).to(torch.float32).cpu().numpy()


def _host(images) -> np.ndarray:
    if torch.is_tensor(images):
        images = images.detach().to('cpu', torch.float32).numpy()
    return np.asarray(images, np.float32)


def build_qat_deploy_forward(model, variables, qat_spec: Dict):
    """Deployment forward carrying the uniform-tf learner's trained
    quantization:

    * the kernels at ``qat_spec['weight_paths']`` (module paths) are folded
      onto the QAT per-channel grid in one grouped K2' call
      (``fake_quant_bucket_group``, channel buckets, no select; each result
      equals ``fake_quant_channel_bucket``'s), at the spec's weight bits, so
      the converter's symmetric per-channel int8 re-quantization of the
      already-gridded constants is ~exact;
    * activations are clipped at the trained EMA (min, max) ranges inside
      the graph, so the int8 runtime's affine grid over the calibrated tensor
      reproduces the QAT quantizer instead of re-deriving ranges from data.

    Returns (deploy_forward, qat_reference_forward): the latter is the live
    QAT eval function (``RangeQuantPolicy``, full fake-quant) the int8
    artifact must match.
    """
    from pocketflow_tpu_torch.learners.uniform_quantization.utils import quant_weights
    from pocketflow_tpu_torch.learners.uniform_quantization_tf.learner import RangeQuantPolicy
    from pocketflow_tpu_torch.ops import fake_quant as fq

    weight_paths = list(qat_spec['weight_paths'])
    act_min = np.asarray(qat_spec['act_min'], np.float32)
    act_max = np.asarray(qat_spec['act_max'], np.float32)
    base = _with_variables(model, variables).eval()
    device = next(base.parameters()).device
    # bits come from the SPEC, not FLAGS: the exporting process may not have
    # the training run's flag values
    w_bits = torch.full((len(weight_paths),), float(qat_spec.get('weight_bits', 8)),
                        device=device)
    a_bits = torch.tensor(float(qat_spec.get('act_bits', 8)), device=device)

    deploy = copy.deepcopy(base)
    with torch.no_grad():
        kernels = quant_weights(deploy, weight_paths)
        folded = fq.fake_quant_bucket_group(kernels, w_bits, 'channel', 0, select=False)
        for kernel, value in zip(kernels, folded):
            kernel.copy_(value)

    class _ClipPolicy(CompressionPolicy):
        def process_act(self, path, act):
            if not path.startswith('act/') or act_min.shape[0] == 0:
                return act
            idx = int(path.split('/')[1])
            return torch.clamp(act, float(act_min[idx]), float(act_max[idx]))

    ranges = (torch.as_tensor(act_min, device=device), torch.as_tensor(act_max, device=device))
    deploy_forward = _PolicyForward(deploy, _ClipPolicy)
    qat_reference_forward = _PolicyForward(base, lambda: RangeQuantPolicy(
        weight_paths, quant_weights(base, weight_paths), w_bits, *ranges, a_bits,
        enabled=True, record=False))
    return deploy_forward, qat_reference_forward


def _leaves(tree):
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _leaves(value)
    elif tree is not None:
        yield tree


def _computes_in_bf16(model, variables) -> bool:
    """Whether a layer of the model computes in bfloat16, or the model or
    `variables` holds a bfloat16 tensor."""
    tensors = list(model.parameters()) + list(model.buffers()) + list(_leaves(variables))
    return (any(getattr(m, 'dtype', None) == torch.bfloat16 for m in model.modules())
            or any(str(t.dtype) in ('bfloat16', 'torch.bfloat16') for t in tensors))


def convert_to_tflite(model, variables, sample_images,
                      quantize: str = 'none',
                      representative_fn: Optional[Callable] = None,
                      input_uint8: bool = False,
                      forward_fn: Optional[Callable] = None) -> bytes:
    """Convert the model's eval forward to a TFLite flatbuffer.

    quantize: 'none' (fp32 builtins), 'dynamic' (int8 weights, fp32 compute
    at op granularity), or 'int8' (full integer quantization calibrated on
    `representative_fn`, by default the sample repeated 8 times).
    input_uint8 puts a uint8 quantize stub at the input (phone-camera path).
    `forward_fn` replaces the model's eval forward (the QAT deploy forward).
    """
    if quantize not in QUANT_MODES:
        raise ValueError('quantize must be one of %s' % (QUANT_MODES,))
    tf = _tf()
    sample = _host(sample_images)
    # the zoo models cast their LOGITS to f32, so inspect the compute dtype
    # attribute (and any non-f32 variables), not the outputs
    if _computes_in_bf16(model, variables):
        raise ValueError(
            'model computes in bfloat16, which TFLite builtins cannot '
            'legalize — rebuild the helper under compute_dtype=float32 '
            'for serving export')
    forward = forward_fn or _frozen_forward(model, variables)
    tf_fn = tf_lowering.emit_tf(tf_lowering.lower(forward, sample.shape))
    converter = tf.lite.TFLiteConverter.from_concrete_functions(
        [tf_fn.get_concrete_function()], tf_fn)

    if quantize == 'dynamic':
        converter.optimizations = [tf.lite.Optimize.DEFAULT]
    elif quantize == 'int8':
        if representative_fn is None:
            def representative_fn():
                for _ in range(8):
                    yield [sample]
        converter.optimizations = [tf.lite.Optimize.DEFAULT]
        converter.representative_dataset = representative_fn
        converter.target_spec.supported_ops = [
            tf.lite.OpsSet.TFLITE_BUILTINS_INT8]
        if input_uint8:
            converter.inference_input_type = tf.uint8
        converter.inference_output_type = tf.float32

    blob = converter.convert()
    log.info('tflite convert (%s): %d bytes', quantize, len(blob))
    return blob


def export_saved_model(model, variables, sample_images, out_dir: str) -> str:
    """Write a TF SavedModel of the eval forward (the reference's frozen .pb
    serving artifact): a ``tf.Module`` whose ``serve`` takes 'images', under
    the 'serving_default' signature.  The artifact is reloaded and held
    against the live model within max(1e-3, 2e-3 max|logits|)."""
    tf = _tf()
    sample = _host(sample_images)
    forward = _frozen_forward(model, variables)
    module = tf.Module()
    module.serve = tf_lowering.emit_tf(tf_lowering.lower(forward, sample.shape), 'images')
    os.makedirs(out_dir, exist_ok=True)
    tf.saved_model.save(module, out_dir,
                        signatures={'serving_default': module.serve})
    restored = tf.saved_model.load(out_dir)
    got = np.asarray(restored.serve(tf.constant(sample)))
    ref = _reference(forward, sample)
    delta = float(np.max(np.abs(got - ref)))
    log.info('saved_model self-check: max |logits delta| = %.3e', delta)
    # scale-aware: the reference may come from the card, whose conv sums
    # run in another order than the serving host's
    tol = max(1e-3, 2e-3 * float(np.max(np.abs(ref))))
    if delta > tol:
        raise AssertionError('SavedModel diverged from the torch model '
                             '(max delta %.3e, tol %.3e)' % (delta, tol))
    log.info('SavedModel written to %s', out_dir)
    return out_dir


def run_tflite(blob: bytes, images) -> np.ndarray:
    """Run a TFLite flatbuffer on a batch (handles uint8-quantized inputs)."""
    tf = _tf()
    interp = tf.lite.Interpreter(model_content=blob)
    interp.allocate_tensors()
    idet = interp.get_input_details()[0]
    odet = interp.get_output_details()[0]
    images = _host(images)
    if idet['dtype'] == np.uint8:
        scale, zero = idet['quantization']
        images = np.clip(np.round(images / scale + zero), 0, 255) \
            .astype(np.uint8)
    interp.set_tensor(idet['index'], images)
    interp.invoke()
    out = interp.get_tensor(odet['index'])
    if odet['dtype'] == np.uint8:
        scale, zero = odet['quantization']
        out = (out.astype(np.float32) - zero) * scale
    return out


def self_check(blob: bytes, model, variables, sample_images,
               reference_forward: Optional[Callable] = None) -> float:
    """Max |logits delta| between the TFLite artifact and the live model.
    For QAT exports `reference_forward` is the QAT eval function: the
    artifact must match the trained quantized semantics, not the float
    model."""
    forward = reference_forward or _frozen_forward(model, variables)
    ref = _reference(forward, sample_images)
    got = run_tflite(blob, sample_images)
    delta = float(np.max(np.abs(ref - got)))
    log.info('tflite self-check: max |logits delta| = %.3e', delta)
    return delta


def measure_latency(blob: bytes, nb_warmup: int = 100, nb_timed: int = 100,
                    nb_threads: int = 1) -> Dict[str, float]:
    """Interpreter latency on the host CPU, the reference's protocol:
    nb_warmup untimed then nb_timed timed invocations."""
    tf = _tf()
    interp = tf.lite.Interpreter(model_content=blob, num_threads=nb_threads)
    interp.allocate_tensors()
    idet = interp.get_input_details()[0]
    rng = np.random.default_rng(0)
    if idet['dtype'] == np.uint8:
        images = rng.integers(0, 256, idet['shape'], np.uint8)
    else:
        images = rng.standard_normal(idet['shape']).astype(np.float32)
    interp.set_tensor(idet['index'], images)
    for _ in range(nb_warmup):
        interp.invoke()
    times = []
    for _ in range(nb_timed):
        start = time.perf_counter()
        interp.invoke()
        times.append((time.perf_counter() - start) * 1e3)
    times = np.asarray(times)
    result = {'mean_ms': float(times.mean()), 'std_ms': float(times.std()),
              'p50_ms': float(np.percentile(times, 50))}
    log.info('tflite latency: %.2f +- %.2f ms', result['mean_ms'],
             result['std_ms'])
    return result


def export_tflite(model, variables, sample_images, out_path: str,
                  quantize: str = 'none',
                  representative_fn: Optional[Callable] = None,
                  input_uint8: bool = False,
                  check_atol: Optional[float] = 1e-2,
                  qat_spec: Optional[Dict] = None) -> str:
    """Convert, self-check, and write `<out_path>` (.tflite appended if
    missing).  For quantized artifacts the numeric check is informational
    (quantization error is expected); for fp32 it must pass `check_atol`.

    With `qat_spec` (from UniformQuantTFLearner.export_quant_spec) the int8
    artifact embeds the trained fake-quant semantics and the self-check runs
    against the QAT eval forward."""
    deploy_fwd = qat_ref_fwd = None
    if qat_spec is not None:
        if quantize != 'int8':
            raise ValueError('qat_spec requires quantize="int8"')
        deploy_fwd, qat_ref_fwd = build_qat_deploy_forward(
            model, variables, qat_spec)
    blob = convert_to_tflite(model, variables, sample_images,
                             quantize=quantize,
                             representative_fn=representative_fn,
                             input_uint8=input_uint8,
                             forward_fn=deploy_fwd)
    delta = self_check(blob, model, variables, sample_images,
                       reference_forward=qat_ref_fwd)
    if quantize == 'none' and check_atol is not None and delta > check_atol:
        raise AssertionError(
            'tflite export diverged from the torch model: max delta %.3e '
            '(atol %.1e)' % (delta, check_atol))
    if not out_path.endswith('.tflite'):
        out_path += '.tflite'
    os.makedirs(os.path.dirname(out_path) or '.', exist_ok=True)
    with open(out_path, 'wb') as fout:
        fout.write(blob)
    log.info('tflite artifact written to %s (%d bytes, quantize=%s)',
             out_path, len(blob), quantize)
    return out_path
