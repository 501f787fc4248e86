"""Learning-rate schedules (counterpart of pocketflow_tpu/core/schedules.py).

Piecewise-constant and staircase-exponential decay, with the initial rate
scaled by ``batch_size / batch_size_norm`` and epoch boundaries stretched by
``nb_epochs_rat``.  A schedule maps the host-side step count to a Python float;
values are rounded to float32 as the JAX schedules hold them.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np

from pocketflow_tpu_torch.config import FLAGS

Schedule = Callable[[int], float]


def piecewise_constant(batch_size: int,
                       idxs_epoch: Sequence[float],
                       decay_rates: Sequence[float],
                       nb_smpls_train: int) -> Schedule:
    """`decay_rates` has len(idxs_epoch) + 1 entries; boundaries are epochs
    (scaled by nb_epochs_rat) converted to step indices."""
    idxs_epoch = [e * FLAGS.nb_epochs_rat for e in idxs_epoch]
    lrn_rate_init = FLAGS.lrn_rate_init * batch_size / FLAGS.batch_size_norm
    nb_batches_per_epoch = float(nb_smpls_train) / batch_size
    bnds = [int(nb_batches_per_epoch * e) for e in idxs_epoch]
    vals = [float(np.float32(lrn_rate_init * r)) for r in decay_rates]

    def schedule(step: int) -> float:
        # tf.train.piecewise_constant keeps the pre-decay value at a step
        # equal to a boundary, hence strict >
        return vals[sum(int(step) > bnd for bnd in bnds)]

    return schedule


def exponential_decay(batch_size: int,
                      epoch_step: float,
                      decay_rate: float,
                      nb_smpls_train: int) -> Schedule:
    """Staircase exponential decay."""
    epoch_step = epoch_step * FLAGS.nb_epochs_rat
    lrn_rate_init = np.float32(FLAGS.lrn_rate_init * batch_size / FLAGS.batch_size_norm)
    batch_step = max(1, int(nb_smpls_train * epoch_step / batch_size))

    def schedule(step: int) -> float:
        power = np.float32(math.floor(np.float32(step) / np.float32(batch_step)))
        return float(lrn_rate_init * np.power(np.float32(decay_rate), power))

    return schedule
