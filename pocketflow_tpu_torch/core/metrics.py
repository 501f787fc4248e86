"""Logging, summaries, and throughput metering (counterpart of
pocketflow_tpu/core/metrics.py, same log-line format)."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

_LOGGER = None


def get_logger() -> logging.Logger:
    global _LOGGER
    if _LOGGER is None:
        logger = logging.getLogger('pocketflow_tpu_torch')
        if not logger.handlers:
            handler = logging.StreamHandler()
            handler.setFormatter(logging.Formatter(
                '%(asctime)s %(levelname)s %(name)s: %(message)s'))
            logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
        _LOGGER = logger
    return _LOGGER


class SummaryWriter:
    """Scalar summary writer: TensorBoard if available, JSONL otherwise."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter as TBWriter
        except ImportError:
            self._jsonl = open(os.path.join(log_dir, 'scalars.jsonl'), 'a')
        else:
            self._tb = TBWriter(log_dir=log_dir)

    def add_scalar(self, tag: str, value: float, step: int):
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))
        else:
            self._jsonl.write(json.dumps(
                {'tag': tag, 'value': float(value), 'step': int(step)}) + '\n')
            self._jsonl.flush()

    def add_scalars(self, scalars: Dict[str, float], step: int):
        for tag, value in scalars.items():
            self.add_scalar(tag, value, step)

    def close(self):
        if self._tb is not None:
            self._tb.close()
        else:
            self._jsonl.close()


class SpeedMeter:
    """images/sec: batch_size * summ_step / elapsed [* nb_workers]."""

    def __init__(self, batch_size: int, nb_workers: int = 1):
        self.batch_size = batch_size
        self.nb_workers = nb_workers
        self._last = time.time()

    def tick(self, nb_iters: int) -> float:
        now = time.time()
        elapsed = max(now - self._last, 1e-9)
        self._last = now
        return self.batch_size * nb_iters * self.nb_workers / elapsed


class ProgressMonitor:
    """Per-summ_step console line: metrics and speed, as in the JAX package."""

    def __init__(self, writer: Optional[SummaryWriter], batch_size: int,
                 nb_workers: int = 1, prefix: str = 'train'):
        self.writer = writer
        self.meter = SpeedMeter(batch_size, nb_workers)
        self.prefix = prefix
        self.log = get_logger()

    def report(self, step: int, nb_iters: int, scalars: Dict[str, float]):
        speed = self.meter.tick(nb_iters)
        parts = ' | '.join('%s = %.4e' % (k, v) for k, v in scalars.items())
        self.log.info('iter #%d: %s | speed = %.2f pics / sec', step, parts, speed)
        if self.writer is not None:
            self.writer.add_scalars(
                {('%s/%s' % (self.prefix, k)): v for k, v in scalars.items()}, step)
            self.writer.add_scalar('%s/speed' % self.prefix, speed, step)
