"""Compile CUDA C at run time and launch it: the counterpart of the
reference's ``src/common/mxrtc.cc``, which compiled ``mx.rtc`` kernels
with NVRTC and launched them with ``cuLaunchKernel``.

A thin ``ctypes`` binding to ``libnvrtc`` and the CUDA driver library
``libcuda.so.1``:

- :func:`compile_kernel` turns a source string into a cubin for ``sm_90a``
  (``nvrtcCompileProgram``, then ``nvrtcGetCUBIN``), loads it into the
  device's primary context (``cuModuleLoadData``) and returns the kernel's
  function handle. Modules are cached per (source, options, device), so the
  same source compiles once per process and card; :data:`stats` counts the
  compiles and their time, and the telemetry's ``cuda.compile_secs``
  counter (goodput's compile bucket) takes the seconds.
- :func:`launch` launches a function handle on PyTorch's current stream of
  its device and counts the launch in ``launch.launches``.

NVRTC is the toolkit's: the one beside the nvcc that ``_build`` uses, whose
``include/`` has ``cuda_fp16.h`` and ``cuda_bf16.h`` (a torch wheel may carry
a libnvrtc of its own; it is not used). A missing toolkit or library, or a
failed compile, raises :class:`MXNetError`, the last with NVRTC's program
log; nothing falls back to nvcc or to the CPU. Nothing here loads a library
or touches the card at import.
"""
import ctypes
import functools
import glob
import hashlib
import os
import threading
import time

import torch

from ..base import MXNetError
from . import _build

__all__ = ['ARCH', 'compile_kernel', 'launch', 'info', 'stats']

ARCH = 'sm_90a'
_lock = threading.Lock()
_libs = {}         # 'nvrtc' / 'cuda' -> ctypes.CDLL
_functions = {}    # (digest, options, device index, name) -> CUfunction
stats = {'compiles': 0, 'compile_ms': 0.0}

_vp = ctypes.c_void_p
_pp = ctypes.POINTER(ctypes.c_char_p)


def _toolkit():
    try:
        return _build.toolkit_root()
    except RuntimeError:
        return None


def _load_nvrtc():
    root = _toolkit()
    if root is None:
        raise MXNetError('libnvrtc not found: no CUDA toolkit (nvcc on PATH, '
                         'under CUDA_HOME or /usr/local/cuda)')
    libs = []
    for sub in ('lib64', os.path.join('targets', 'x86_64-linux', 'lib')):
        libs += sorted(glob.glob(os.path.join(root, sub, 'libnvrtc.so*')))
    libs = [p for p in libs if 'builtins' not in os.path.basename(p)]
    if not libs:
        raise MXNetError('libnvrtc not found in the CUDA toolkit at %s' % root)
    lib_dir = os.path.dirname(libs[0])
    try:
        # its builtins first, from the same directory, so that NVRTC finds
        # them whatever the loader's search path holds
        for b in sorted(glob.glob(os.path.join(lib_dir, 'libnvrtc-builtins.so*')))[:1]:
            ctypes.CDLL(b, mode=ctypes.RTLD_GLOBAL)
        lib = ctypes.CDLL(libs[0])
    except OSError as e:
        raise MXNetError('libnvrtc of the CUDA toolkit at %s is not loadable: %s'
                         % (root, e))
    lib.nvrtcCreateProgram.argtypes = [ctypes.POINTER(_vp), ctypes.c_char_p,
                                       ctypes.c_char_p, ctypes.c_int, _pp, _pp]
    lib.nvrtcCompileProgram.argtypes = [_vp, ctypes.c_int, _pp]
    lib.nvrtcGetProgramLogSize.argtypes = [_vp, ctypes.POINTER(ctypes.c_size_t)]
    lib.nvrtcGetProgramLog.argtypes = [_vp, ctypes.c_char_p]
    lib.nvrtcGetCUBINSize.argtypes = [_vp, ctypes.POINTER(ctypes.c_size_t)]
    lib.nvrtcGetCUBIN.argtypes = [_vp, ctypes.c_char_p]
    lib.nvrtcDestroyProgram.argtypes = [ctypes.POINTER(_vp)]
    lib.nvrtcGetErrorString.argtypes = [ctypes.c_int]
    lib.nvrtcGetErrorString.restype = ctypes.c_char_p
    lib.nvrtcVersion.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    return lib


def _load_cuda():
    try:
        lib = ctypes.CDLL('libcuda.so.1')
    except OSError as e:
        raise MXNetError('the CUDA driver library libcuda.so.1 is not '
                         'loadable: %s' % e)
    u = ctypes.c_uint
    lib.cuInit.argtypes = [u]
    lib.cuCtxGetCurrent.argtypes = [ctypes.POINTER(_vp)]
    lib.cuCtxGetDevice.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.cuDeviceGet.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.cuDevicePrimaryCtxRetain.argtypes = [ctypes.POINTER(_vp), ctypes.c_int]
    lib.cuCtxSetCurrent.argtypes = [_vp]
    lib.cuModuleLoadData.argtypes = [ctypes.POINTER(_vp), ctypes.c_char_p]
    lib.cuModuleGetFunction.argtypes = [ctypes.POINTER(_vp), _vp, ctypes.c_char_p]
    lib.cuLaunchKernel.argtypes = [_vp, u, u, u, u, u, u, u, _vp,
                                   ctypes.POINTER(_vp), ctypes.POINTER(_vp)]
    lib.cuGetErrorString.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p)]
    return lib


def _lib(which):
    with _lock:
        if which not in _libs:
            _libs[which] = _load_nvrtc() if which == 'nvrtc' else _load_cuda()
        return _libs[which]


def _loaded_path(fragment):
    """The file the process mapped for a library whose name holds
    ``fragment`` (Linux), or None."""
    try:
        with open('/proc/self/maps') as f:
            for line in f:
                path = line.split()[-1]
                name = os.path.basename(path)
                if name.startswith(fragment) and 'builtins' not in name:
                    return path
    except OSError:
        pass
    return None


def info():
    """{'path': the libnvrtc file loaded, 'version': (major, minor),
    'include': the toolkit include directory or None, 'arch': ARCH}."""
    lib = _lib('nvrtc')
    major, minor = ctypes.c_int(), ctypes.c_int()
    lib.nvrtcVersion(ctypes.byref(major), ctypes.byref(minor))
    return {'path': _loaded_path('libnvrtc.so'), 'version': (major.value, minor.value),
            'include': _include_dir(), 'arch': ARCH}


def _include_dir():
    root = _toolkit()
    inc = root and os.path.join(root, 'include')
    return inc if inc and os.path.exists(os.path.join(inc, 'cuda_fp16.h')) else None


def _check_cu(err, what):
    if err:
        msg = ctypes.c_char_p()
        _lib('cuda').cuGetErrorString(err, ctypes.byref(msg))
        raise MXNetError('%s failed: %s (CUresult %d)'
                         % (what, (msg.value or b'unknown').decode(), err))


def _current_context(index):
    """Make the card's primary context current on this thread (the one
    PyTorch runs in) before any driver call."""
    torch.cuda.init()
    cu = _lib('cuda')
    _check_cu(cu.cuInit(0), 'cuInit')
    ctx, dev = _vp(), ctypes.c_int()
    _check_cu(cu.cuCtxGetCurrent(ctypes.byref(ctx)), 'cuCtxGetCurrent')
    if ctx.value:
        _check_cu(cu.cuCtxGetDevice(ctypes.byref(dev)), 'cuCtxGetDevice')
        if dev.value == index:
            return
    _check_cu(cu.cuDeviceGet(ctypes.byref(dev), index), 'cuDeviceGet')
    _check_cu(cu.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev.value),
              'cuDevicePrimaryCtxRetain')
    _check_cu(cu.cuCtxSetCurrent(ctx), 'cuCtxSetCurrent')


@functools.lru_cache(maxsize=None)
def _options():
    # looked up once: finding the toolkit searches PATH, which costs more
    # than a launch
    opts = ['--gpu-architecture=%s' % ARCH, '-std=c++17']
    inc = _include_dir()
    if inc:
        opts.append('-I%s' % inc)
    return tuple(opts)


def _cubin(source, name, options):
    lib = _lib('nvrtc')
    prog = _vp()

    def ok(res, what):
        if res:
            raise MXNetError('%s failed for %s: %s'
                             % (what, name, lib.nvrtcGetErrorString(res).decode()))

    ok(lib.nvrtcCreateProgram(ctypes.byref(prog), source.encode(),
                              (name + '.cu').encode(), 0, None, None),
       'nvrtcCreateProgram')
    try:
        opts = (ctypes.c_char_p * len(options))(*[o.encode() for o in options])
        res = lib.nvrtcCompileProgram(prog, len(options), opts)
        size = ctypes.c_size_t()
        lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
        log = ctypes.create_string_buffer(size.value)
        lib.nvrtcGetProgramLog(prog, log)
        if res:
            raise MXNetError('NVRTC failed to compile %s (%s):\n%s'
                             % (name, lib.nvrtcGetErrorString(res).decode(),
                                log.value.decode(errors='replace')))
        ok(lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)), 'nvrtcGetCUBINSize')
        cubin = ctypes.create_string_buffer(size.value)
        ok(lib.nvrtcGetCUBIN(prog, cubin), 'nvrtcGetCUBIN')
        return cubin
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


def compile_kernel(source, name, device):
    """The function handle of kernel ``name`` (an ``extern "C"``
    ``__global__`` function of ``source``) on the CUDA ``device``,
    compiled for :data:`ARCH` at its first request for this source and
    device. Raises MXNetError with NVRTC's log when the source does not
    compile."""
    device = torch.device(device)
    if device.type != 'cuda':
        raise ValueError('NVRTC kernels run on CUDA devices, not %s' % device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    options = _options()
    key = (hashlib.sha256(source.encode()).hexdigest(), options, index, name)
    with _lock:
        fn = _functions.get(key)
    if fn is not None:
        return fn
    t0 = time.perf_counter()
    cubin = _cubin(source, name, options)
    cu = _lib('cuda')
    with torch.cuda.device(index):
        _current_context(index)
        module, fn = _vp(), _vp()
        _check_cu(cu.cuModuleLoadData(ctypes.byref(module), cubin), 'cuModuleLoadData')
        _check_cu(cu.cuModuleGetFunction(ctypes.byref(fn), module, name.encode()),
                  'cuModuleGetFunction(%s)' % name)
    secs = time.perf_counter() - t0
    from .. import telemetry
    telemetry.counter('cuda.compile_secs').inc(secs)
    with _lock:
        stats['compiles'] += 1
        stats['compile_ms'] += secs * 1e3
        return _functions.setdefault(key, fn)


def launch(fn, device, grid, block, args):
    """Launch ``fn`` (from :func:`compile_kernel` for ``device``) with ``grid`` and
    ``block`` (3 ints each) on PyTorch's current stream of ``device``.
    ``args`` are ctypes values, one per kernel parameter. Raises MXNetError
    when the driver refuses the launch."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    params = (_vp * len(args))(*[ctypes.addressof(a) for a in args])
    with torch.cuda.device(index):
        _current_context(index)
        stream = torch.cuda.current_stream(index).cuda_stream
        err = _lib('cuda').cuLaunchKernel(fn, *grid, *block, 0,
                                          stream, params, None)
    _check_cu(err, 'cuLaunchKernel')
    launch.launches += 1


launch.launches = 0
