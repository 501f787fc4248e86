"""Profiler hook of the train loop (counterpart of pocketflow_tpu/core/profiling.py)
and the program's spans.

With ``--enbl_profiler``, ``torch.profiler`` traces steps
[profiler_start_step, profiler_start_step + profiler_nb_steps) into
``<log_dir>/profile`` as a Chrome trace (``trace_steps_<a>-<b>.json``): the
host's ops and, when the model is on the card, its kernels, copies and
memsets.  Each traced step is a user annotation ``train_step_<i>``;
``tools/profile_step.py:trace_summary`` reads such a file back, with the
device ms, host ms and launches of each program span.

``span(name, detail)`` names a part of the program for whatever profiler
records: ``record_function('pf.<name>[ <detail>]')``, in the same trace as
the kernels it launches, so that each kernel and each idle gap of the card
can be put down to the span the host was in.  While no profiler records it
returns one shared no-op context and formats nothing.  The spans, from the
train step down:

    pf.train.augment          the step's augmentation (``augment_xy``)
    pf.train.forward          the policy, the forward, the loss and any extra loss
    pf.train.backward         zero_grad and the backward (autograd's own ops)
    pf.train.grad_sync        the gradient all-reduce; returns at once at world 1
    pf.train.update           gradient transform, the optimizer step, post-update
                              (uniform-tf's range EMA)
    pf.quant.act              an activation site's quantization: its range
                              record and the fake-quant (sites at < 32 bits)
    pf.quant.act_backward     the STE backward of an activation site, on
                              autograd's thread
    pf.int8.site <path>       one int8 serving site's wrapper and kernel
    pf.remat.recompute <blk>  a remat block's recompute in the backward
    pf.data.crop_resize       ILSVRC-12's train crop-resize (full-frame shards)
    pf.det.loss               a detector's calc_loss (matching, targets, loss)
    pf.det.propose            Faster R-CNN's proposal layer (top-k, NMS)
    pf.det.roi_align          Faster R-CNN's ROI-align (forward)
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.core.metrics import get_logger

# the help is the JAX registry's, word for word, as for every global flag
FLAGS.DEFINE_boolean('enbl_profiler', False, 'capture a jax.profiler trace')
FLAGS.DEFINE_integer('profiler_start_step', 10, 'first step of the trace window')
FLAGS.DEFINE_integer('profiler_nb_steps', 5, '# of steps to trace')

STEP_PREFIX = 'train_step_'  # the annotation of each traced step
SPAN_PREFIX = 'pf.'  # the annotation of each program span

_OFF = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled


def span(name: str, detail: Optional[str] = None):
    """The context of program span ``pf.<name>`` (``pf.<name> <detail>``
    with a detail): a ``record_function`` while a profiler records, else
    the shared no-op."""
    if not _recording():
        return _OFF
    if detail is not None:
        name = '%s %s' % (name, detail)
    return torch.profiler.record_function(SPAN_PREFIX + name)


class ProfilerHook:
    """Start and stop a ``torch.profiler`` trace around a window of steps."""

    def __init__(self, log_dir: Optional[str] = None, device=None):
        self.enabled = bool(FLAGS.enbl_profiler)
        self.log_dir = os.path.join(log_dir or FLAGS.log_dir, 'profile')
        self.start_step = int(FLAGS.profiler_start_step)
        self.stop_step = self.start_step + int(FLAGS.profiler_nb_steps)
        self.cuda = device is not None and torch.device(device).type == 'cuda'
        self.path: Optional[str] = None  # the trace written last
        self._prof = None
        self._step = None  # the open step's annotation

    def before_step(self, step: int):
        if self.enabled and self._prof is None and step == self.start_step:
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
            if self.cuda:  # no earlier step's work runs inside the window
                torch.cuda.synchronize()
            self._prof = profile(activities=activities)
            self._prof.start()
            get_logger().info('profiler trace started (steps %d-%d) -> %s',
                              self.start_step, self.stop_step, self.log_dir)
        if self._prof is not None:
            self._step = torch.profiler.record_function(STEP_PREFIX + str(step))
            self._step.__enter__()

    def after_step(self, step: int):
        if self._prof is None:
            return
        self._step.__exit__(None, None, None)
        self._step = None
        if step + 1 >= self.stop_step:
            self._stop(step + 1)

    def _stop(self, end_step: int):
        prof, self._prof = self._prof, None
        if self._step is not None:
            self._step.__exit__(None, None, None)
            self._step = None
        if self.cuda:
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        self.path = os.path.join(self.log_dir, 'trace_steps_%d-%d.json'
                                 % (self.start_step, end_step))
        prof.export_chrome_trace(self.path)
        get_logger().info('profiler trace written to %s', self.path)

    def close(self, step: Optional[int] = None):
        """Stop a trace still open (the loop ended inside the window)."""
        if self._prof is not None:
            self._stop(step if step is not None else self.stop_step)
