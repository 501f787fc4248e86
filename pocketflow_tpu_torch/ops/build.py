"""Build the package's CUDA sources into a shared library at first use.

The sources under ``pocketflow_tpu_torch/csrc/`` have a plain C interface and
are compiled with ``nvcc`` for ``sm_90a`` into ``build/pocketflow_tpu_torch/``
beside the package, then loaded with ``ctypes``.  The library's name carries a
hash of its source and flags, so an edited source is rebuilt and a stale
library is never loaded.  Nothing here runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'pocketflow_tpu_torch'
NVCC_FLAGS: List[str] = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
                         '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

# source file name -> (loaded library, compiler output, seconds the build took)
_LOADED: Dict[str, Tuple[ctypes.CDLL, str, float]] = {}


def _nvcc() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA toolkit')
    return path


def load(source: str) -> Tuple[ctypes.CDLL, str, float]:
    """Compile ``csrc/<source>`` if its library is missing, load it, and
    return (library, compiler output, build seconds; 0 when already built)."""
    if source in _LOADED:
        return _LOADED[source]
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes() + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / ('lib%s-%s.so' % (src.stem, digest))
    log, seconds = '', 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # one compile at a time (several test or worker processes may start together)
    with open(BUILD_DIR / '.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib_path.exists():
            tmp = lib_path.with_suffix('.so.tmp%d' % os.getpid())
            start = time.perf_counter()
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(src)],
                                  capture_output=True, text=True)
            seconds = time.perf_counter() - start
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError('nvcc failed on %s:\n%s' % (src, log))
            os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    _LOADED[source] = (lib, log, seconds)
    return _LOADED[source]
