"""Build the port's CUDA sources into shared libraries and load them.

Each source under ``csrc/`` has a plain C interface. It is compiled by
``nvcc`` for ``sm_90a`` into ``build/lib<name>-<hash>.so`` beside this
file at its first use, and loaded with ``ctypes``. The hash covers the
source and the flags, so an edited source is rebuilt and a stale
library is never loaded. The build happens on the machine with the card
(nothing here imports or builds at package import). Different sources
build in parallel when loaded from several threads. The seconds of each
build go into the telemetry's ``cuda.compile_secs`` counter (goodput's
compile bucket).
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ['load', 'build_log', 'toolkit_root']

_CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent / 'build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_lock = threading.Lock()
_locks = {}        # name -> threading.Lock, held while that source builds
_loaded = {}       # name -> ctypes.CDLL


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    for root in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if root and os.path.exists(os.path.join(root, 'bin', 'nvcc')):
            return os.path.join(root, 'bin', 'nvcc')
    raise RuntimeError('nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): '
                       'the CUDA kernels are built on the machine with the '
                       'card')


def toolkit_root():
    """The CUDA toolkit's root directory: the parent of the ``bin/`` that
    holds the nvcc :func:`load` uses. Raises RuntimeError without one."""
    return os.path.dirname(os.path.dirname(os.path.realpath(_nvcc())))


def _library_path(name):
    """Where the library of ``csrc/<name>.cu`` lives for its current
    source and flags."""
    src = (_CSRC / (name + '.cu')).read_bytes()
    digest = hashlib.sha256(src + ' '.join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / ('lib%s-%s.so' % (name, digest[:16]))


def build_log(name):
    """The compiler's output (ptxas register and spill lines) of the
    library's build, or '' when it was built by another process."""
    log = _library_path(name).with_suffix('.log')
    return log.read_text() if log.exists() else ''


def _build(name, out):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name('%s.tmp%d' % (out.name, os.getpid()))
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(_CSRC / (name + '.cu'))]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError('nvcc failed (%d) for %s:\n%s\n%s'
                           % (res.returncode, name, res.stdout, res.stderr))
    out.with_suffix('.log').write_text(res.stdout + res.stderr)
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing


def load(name):
    """The loaded ``ctypes.CDLL`` of ``csrc/<name>.cu``, built first when
    no library for its current source exists."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _loaded.get(name)
        if lib is None:
            out = _library_path(name)
            if not out.exists():
                t0 = time.perf_counter()
                _build(name, out)
                from .. import telemetry
                telemetry.counter('cuda.compile_secs').inc(
                    time.perf_counter() - t0)
            lib = _loaded[name] = ctypes.CDLL(str(out))
        return lib
