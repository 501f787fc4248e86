"""Global flag registry of the PyTorch port (counterpart of pocketflow_tpu/config.py).

The registry is a copy, not an import: ``pocketflow_tpu`` imports jax when it
loads, and this package must not.  Flag names and defaults equal the JAX
package's, so a CLI recipe written for one runs unchanged on the other
(``tests/test_torch_package.py`` holds the two registries together).  Only the
flags this package reads are defined here; each module defines its own, as in
the JAX package.

    from pocketflow_tpu_torch.config import FLAGS
    with FLAGS.scope(batch_size=32, learner='uniform'):
        ...
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import threading
from typing import Any, Dict, List, Optional


class _FlagSpec:
    __slots__ = ('name', 'default', 'ftype', 'help')

    def __init__(self, name: str, default: Any, ftype: type, help_str: str):
        self.name = name
        self.default = default
        self.ftype = ftype
        self.help = help_str


def _parse_bool(value: Any) -> bool:
    if isinstance(value, bool):
        return value
    sval = str(value).strip().lower()
    if sval in ('true', '1', 'yes', 'y', 't'):
        return True
    if sval in ('false', '0', 'no', 'n', 'f'):
        return False
    raise ValueError('cannot parse boolean flag value: %r' % (value,))


class FlagRegistry:
    """A flat flag namespace with registration, parsing, and scoped override."""

    def __init__(self):
        object.__setattr__(self, '_specs', {})
        object.__setattr__(self, '_values', {})
        object.__setattr__(self, '_lock', threading.RLock())

    # -- registration (mirrors tf.app.flags.DEFINE_*) -----------------------

    def _define(self, name: str, default: Any, ftype: type, help_str: str):
        with self._lock:
            if name in self._specs:
                # re-registration with an identical default is fine (module
                # reloads); conflicting defaults are an error
                if self._specs[name].default != default:
                    raise ValueError('flag %r re-defined with a different default' % name)
                return
            self._specs[name] = _FlagSpec(name, default, ftype, help_str)
            self._values[name] = default

    def DEFINE_string(self, name, default, help_str=''):
        self._define(name, default, str, help_str)

    def DEFINE_integer(self, name, default, help_str=''):
        self._define(name, default, int, help_str)

    def DEFINE_float(self, name, default, help_str=''):
        self._define(name, default, float, help_str)

    def DEFINE_boolean(self, name, default, help_str=''):
        self._define(name, default, bool, help_str)

    # -- access --------------------------------------------------------------

    def __getattr__(self, name: str) -> Any:
        values = object.__getattribute__(self, '_values')
        if name in values:
            return values[name]
        raise AttributeError('unknown flag: %r' % name)

    def __setattr__(self, name: str, value: Any):
        with self._lock:
            if name not in self._specs:
                raise AttributeError('cannot set unregistered flag: %r' % name)
            self._values[name] = self._coerce(name, value)

    def __contains__(self, name: str) -> bool:
        return name in self._values

    def get(self, name: str, default: Any = None) -> Any:
        return self._values.get(name, default)

    def defaults(self) -> Dict[str, Any]:
        """Every registered flag with its default value."""
        return {name: spec.default for name, spec in self._specs.items()}

    def _coerce(self, name: str, value: Any) -> Any:
        spec = self._specs[name]
        if value is None:
            return None
        if spec.ftype is bool:
            return _parse_bool(value)
        return spec.ftype(value)

    def as_dict(self) -> Dict[str, Any]:
        return dict(self._values)

    # -- overrides -------------------------------------------------------

    def override(self, **kwargs):
        """Permanently set several flags (tests, programmatic callers)."""
        for key, value in kwargs.items():
            setattr(self, key, value)

    @contextlib.contextmanager
    def scope(self, **kwargs):
        """Temporarily override flags inside a ``with`` block."""
        with self._lock:
            missing = [k for k in kwargs if k not in self._specs]
            if missing:
                raise AttributeError('unknown flags in scope(): %r' % missing)
            # coerce everything before mutating anything, so that a bad value
            # leaks none of the flags before it
            coerced = {k: self._coerce(k, v) for k, v in kwargs.items()}
            saved = {k: self._values[k] for k in kwargs}
            self._values.update(coerced)
        try:
            yield self
        finally:
            with self._lock:
                self._values.update(saved)

    # -- CLI -------------------------------------------------------------

    def parse_args(self, argv: Optional[List[str]] = None) -> List[str]:
        """Parse ``--flag=value`` / ``--flag value`` argv entries.

        Bare ``--bool_flag`` means True, ``--nobool_flag`` means False, and
        names match exactly (no prefix abbreviation).  Returns unrecognised
        leftovers.
        """
        if argv is None:
            argv = sys.argv[1:]
        rewritten = []
        for arg in argv:
            if arg.startswith('--no') and arg[4:] in self._specs \
                    and self._specs[arg[4:]].ftype is bool:
                rewritten.append('--%s=false' % arg[4:])
            else:
                rewritten.append(arg)
        argv = rewritten
        parser = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
        for spec in self._specs.values():
            if spec.ftype is bool:
                parser.add_argument('--' + spec.name, nargs='?', const='true',
                                    default=None, help=spec.help)
            else:
                parser.add_argument('--' + spec.name, default=None, help=spec.help)
        if any(a in ('--help', '-h') for a in argv):
            parser.print_help()
            raise SystemExit(0)
        namespace, leftovers = parser.parse_known_args(argv)
        for key, value in vars(namespace).items():
            if value is not None:
                setattr(self, key, value)
        return leftovers


FLAGS = FlagRegistry()

# core framework flags read by the port (names & defaults of pocketflow_tpu/config.py)
FLAGS.DEFINE_string('log_dir', './logs', 'logging directory')
FLAGS.DEFINE_string('learner', 'full-prec', 'learner name')
FLAGS.DEFINE_string('exec_mode', 'train', 'execution mode: train / eval')
FLAGS.DEFINE_integer('summ_step', 100, 'summarization step size')
FLAGS.DEFINE_integer('save_step', 10000, 'model saving step size')
FLAGS.DEFINE_string('save_path', './models/model.ckpt', "model's save path")
FLAGS.DEFINE_boolean('enbl_dst', False, 'enable the distillation loss for training')
FLAGS.DEFINE_boolean('enbl_warm_start', False, 'enable warm start for training')

FLAGS.DEFINE_float('lrn_rate_init', 1e-1, 'initial learning rate')
FLAGS.DEFINE_float('batch_size_norm', 128, 'normalization factor of batch size')
FLAGS.DEFINE_float('nb_epochs_rat', 1.0, 'ratio of total number of training epochs')
FLAGS.DEFINE_float('momentum', 0.9, 'momentum coefficient')
FLAGS.DEFINE_float('loss_w_dcy', 2e-4, 'weight decaying loss coefficient')

FLAGS.DEFINE_integer('prefetch_size', 8, 'batches prefetched ahead of device')

FLAGS.DEFINE_string('compute_dtype', 'bfloat16',
                    'activation compute dtype: bfloat16 | float32')
FLAGS.DEFINE_boolean('synthetic_data', False,
                     'use deterministic synthetic data when real files are absent')
FLAGS.DEFINE_integer('rand_seed', 0, 'global PRNG seed')
FLAGS.DEFINE_integer('bn_stats_subsample', 1,
                     'compute BN batch statistics from the leading 1/S of the '
                     'batch (ghost-BN; 1 = exact)')
