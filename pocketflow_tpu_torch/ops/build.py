"""Build the package's CUDA sources into shared libraries at first use.

The sources under ``pocketflow_tpu_torch/csrc/`` have a plain C interface and
are compiled with ``nvcc`` for ``sm_90a`` into ``build/pocketflow_tpu_torch/``
beside the package, then loaded with ``ctypes``.  The library's name carries a
hash of its source and flags, so an edited source is rebuilt and a stale
library is never loaded.  ``load_all`` starts one ``nvcc`` per missing library
together, so several sources build in the time of the slowest.  Nothing here
runs when a module is imported.
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
from typing import Dict, List, Sequence, Tuple

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


def _lib_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / ('lib%s-%s.so' % (src.stem, digest))


def load_all(sources: Sequence[str]) -> Dict[str, Tuple[ctypes.CDLL, str, float]]:
    """Compile each ``csrc/<source>`` whose library is missing, all compiles
    started together, load them, and return {source: (library, compiler
    output, build seconds; 0 when already built)}."""
    todo = [source for source in dict.fromkeys(sources) if source not in _LOADED]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # one build at a time (several test or worker processes may start together)
        with open(BUILD_DIR / '.lock', 'w') as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            start = time.perf_counter()
            procs = {}
            for source in todo:
                lib_path = _lib_path(CSRC / source)
                if not lib_path.exists():
                    tmp = lib_path.with_suffix('.so.tmp%d' % os.getpid())
                    procs[source] = (tmp, lib_path, subprocess.Popen(
                        [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / source)],
                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            built = {source: (proc.communicate()[0], time.perf_counter() - start)
                     for source, (_, _, proc) in procs.items()}  # every compile ends here
            for source, (tmp, lib_path, proc) in procs.items():
                if proc.returncode != 0:
                    raise RuntimeError('nvcc failed on %s:\n%s' % (CSRC / source, built[source][0]))
                os.replace(tmp, lib_path)
        for source in todo:
            log, seconds = built.get(source, ('', 0.0))
            _LOADED[source] = (ctypes.CDLL(str(_lib_path(CSRC / source))), log, seconds)
    return {source: _LOADED[source] for source in sources}


def load(source: str) -> Tuple[ctypes.CDLL, str, float]:
    """``load_all`` of one source: (library, compiler output, build seconds)."""
    return load_all([source])[source]
