"""The native runtime: the counterpart of ``mxnet_tpu/_native.py`` for its
dependency engine, its pooled host storage, its profiler and its RecordIO
stream.

``src/engine.cc`` (the read/write-set dependency engine, which also holds
the C API's error channel), ``src/storage.cc`` (the size-bucketed pool of
aligned host blocks: ``MXTStorageAlloc``, ``Free``, ``DirectFree``,
``ReleaseAll`` and ``Stats``), ``src/profiler.cc`` (the engine's op spans
as chrome trace events) and ``src/recordio.cc`` (the dmlc RecordIO
stream), shared with the JAX package and never edited here, are compiled
with ``g++`` into ``ops/build/libmxtt_native-<hash>.so`` at the first use,
and loaded with ``ctypes``. The hash covers the sources and the flags, so
an edited source is rebuilt and a stale library is never loaded; nothing
is built under ``src/`` or the JAX package.

:func:`backend` says which record reader is live: ``'native'``, or
``'python'`` when ``MXTPU_NO_NATIVE=1`` asks for the pure-Python reader or
the host has no ``g++``, as the JAX package falls back on a host without a
compiler. A build or load that fails where ``g++`` exists raises
:class:`NativeError` with the compiler's output: it does not fall back
without a word. :func:`loaded` gives the library only if a caller already
loaded it (the profiler asks, and builds nothing).
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from .config import flags

__all__ = ['get_lib', 'loaded', 'backend', 'check_call', 'NativeError',
           'SYNC_FN']

_PKG = Path(__file__).resolve().parent
_SRC = _PKG.parent / 'src'
BUILD_DIR = _PKG / 'ops' / 'build'
SOURCES = (_SRC / 'engine.cc', _SRC / 'storage.cc', _SRC / 'profiler.cc',
           _SRC / 'recordio.cc')
CXX_FLAGS = ('-std=c++17', '-O2', '-fPIC', '-Wall', '-shared',
             '-Wl,--no-undefined')

_lock = threading.Lock()
_lib = None
_tried = False


class NativeError(RuntimeError):
    pass


def library_path():
    """Where the library lives for the current sources and flags."""
    h = hashlib.sha256(' '.join(CXX_FLAGS).encode())
    for p in SOURCES + (_SRC / 'mxtpu.h',):
        h.update(p.read_bytes())
    return BUILD_DIR / ('libmxtt_native-%s.so' % h.hexdigest()[:16])


def _build(cxx, out):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name('%s.tmp%d' % (out.name, os.getpid()))
    cmd = [cxx, *CXX_FLAGS, '-I', str(_SRC), '-o', str(tmp)] + \
        [str(s) for s in SOURCES] + ['-pthread']
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise NativeError('g++ failed (%d) for the native runtime:\n%s\n%s'
                          % (res.returncode, res.stdout, res.stderr))
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing


# the engine's callback type: void fn(void *param)
SYNC_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p)


def _bind(lib):
    C = ctypes
    lib.MXTGetLastError.restype = C.c_char_p
    lib.MXTGetLastError.argtypes = []
    lib.MXTNowUS.restype = C.c_int64
    lib.MXTNowUS.argtypes = []
    protos = {
        'MXTEngineCreate': [C.c_int, C.POINTER(C.c_void_p)],
        'MXTEngineFree': [C.c_void_p],
        'MXTEngineNewVar': [C.c_void_p, C.POINTER(C.c_void_p)],
        'MXTEngineDeleteVar': [C.c_void_p, C.c_void_p],
        'MXTEnginePushSync': [C.c_void_p, C.c_void_p, C.c_void_p,
                              C.POINTER(C.c_void_p), C.c_int,
                              C.POINTER(C.c_void_p), C.c_int,
                              C.c_int, C.c_char_p],
        'MXTEngineWaitForVar': [C.c_void_p, C.c_void_p],
        'MXTEngineWaitForAll': [C.c_void_p],
        'MXTEnginePendingOps': [C.c_void_p, C.POINTER(C.c_int64)],
        'MXTStorageAlloc': [C.c_size_t, C.POINTER(C.c_void_p)],
        'MXTStorageFree': [C.c_void_p],
        'MXTStorageDirectFree': [C.c_void_p],
        'MXTStorageReleaseAll': [],
        'MXTStorageStats': [C.POINTER(C.c_int64)],
        'MXTProfilerSetState': [C.c_int],
        'MXTProfilerDump': [C.c_char_p],
        'MXTRecordIOWriterCreate': [C.c_char_p, C.POINTER(C.c_void_p)],
        'MXTRecordIOWriterWrite': [C.c_void_p, C.c_char_p, C.c_size_t],
        'MXTRecordIOWriterTell': [C.c_void_p, C.POINTER(C.c_size_t)],
        'MXTRecordIOWriterFree': [C.c_void_p],
        'MXTRecordIOReaderCreate': [C.c_char_p, C.POINTER(C.c_void_p)],
        'MXTRecordIOReaderNext': [C.c_void_p, C.POINTER(C.c_void_p),
                                  C.POINTER(C.c_size_t)],
        'MXTRecordIOReaderSeek': [C.c_void_p, C.c_size_t],
        'MXTRecordIOReaderTell': [C.c_void_p, C.POINTER(C.c_size_t)],
        'MXTRecordIOReaderFree': [C.c_void_p],
    }
    for name, argtypes in protos.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = C.c_int
    return lib


def get_lib():
    """The loaded CDLL, built first if needed; None where the Python
    reader is live (``MXTPU_NO_NATIVE=1``, or no ``g++``). The flag is
    read at every call (``flags.reload`` after changing it); the library
    is built and loaded once a process."""
    global _lib, _tried
    if flags.get('MXTPU_NO_NATIVE'):
        return None
    with _lock:
        if not _tried:
            cxx = shutil.which('g++')
            if cxx is not None:
                out = library_path()
                if not out.exists():
                    _build(cxx, out)
                _lib = _bind(ctypes.CDLL(str(out)))
            _tried = True
        return _lib


def loaded():
    """The library if it is already loaded, else None (builds nothing)."""
    return _lib


def backend():
    """``'native'`` or ``'python'``: the reader that MXRecordIO uses."""
    return 'python' if get_lib() is None else 'native'


def check_call(ret, lib):
    """Raise NativeError with ``lib``'s MXTGetLastError message (this
    thread's) on a nonzero return."""
    if ret != 0:
        raise NativeError(lib.MXTGetLastError().decode())
