"""Profiler hook of the train loop (counterpart of pocketflow_tpu/core/profiling.py).

With ``--enbl_profiler``, ``torch.profiler`` traces steps
[profiler_start_step, profiler_start_step + profiler_nb_steps) into
``<log_dir>/profile`` as a Chrome trace (``trace_steps_<a>-<b>.json``): the
host's ops and, when the model is on the card, its kernels, copies and
memsets.  Each traced step is a user annotation ``train_step_<i>``;
``tools/profile_step.py:trace_summary`` reads such a file back.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.core.metrics import get_logger

FLAGS.DEFINE_boolean('enbl_profiler', False, 'capture a jax.profiler trace')
FLAGS.DEFINE_integer('profiler_start_step', 10, 'first step of the trace window')
FLAGS.DEFINE_integer('profiler_nb_steps', 5, '# of steps to trace')

STEP_PREFIX = 'train_step_'  # the annotation of each traced step


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
