"""Runtime kernel compilation: the counterpart of ``mxnet_tpu/rtc.py``
(``mx.rtc``). The user writes a kernel body in a string; it is compiled at
run time and pushed over NDArrays.

Two modes, the counterparts of the JAX package's two:

- ``'torch'`` (for ``'jnp'``): Python statements that read the input
  names and assign each output name, with ``torch`` in their namespace,
  run eagerly on the inputs' tensors;
- ``'cuda'`` (for ``'pallas'``, kernel K7): a CUDA C kernel body, as in
  the reference's ``mx.rtc``. It is decorated into ::

      extern "C" __global__ void <name>(const T* __restrict__ <in>, ...,
                                        T* <out>, ...)

  with each argument's rank and dims as constants in the body
  (``const int <arg>_ndim``, ``const int <arg>_dims[]``, as the reference's
  ``mxrtc.cc`` wrote them) and its C type from its dtype (float, double,
  ``__half``, ``__nv_bfloat16``, int, long long, signed char, unsigned char,
  bool; ``cuda_fp16.h`` and ``cuda_bf16.h`` are included for the half
  types). NVRTC compiles it for sm_90a (:mod:`.ops.nvrtc`) once per distinct
  set of pushed input shapes and dtypes, and it launches on the inputs'
  card. It runs on CUDA tensors only: on CPU tensors it raises, and nothing
  runs in its place.

As in the JAX package, outputs are fresh buffers of the declared shapes and
dtypes, rebound into the pushed output NDArrays after the launch; a body
that reads an output before it writes it reads undefined values.

Security note: like the reference, this executes user-supplied source
in-process. It is a developer tool, not an untrusted-input boundary.
"""
import ctypes
import re
import textwrap

import numpy as np
import torch

from .ndarray.ndarray import NDArray
from .ops import nvrtc

__all__ = ['Rtc', 'C_TYPES', 'DEFAULT_BLOCK', 'launch_geometry']

C_TYPES = {torch.float32: 'float', torch.float64: 'double',
           torch.float16: '__half', torch.bfloat16: '__nv_bfloat16',
           torch.int32: 'int', torch.int64: 'long long',
           torch.int8: 'signed char', torch.uint8: 'unsigned char',
           torch.bool: 'bool'}
_HALF_HEADERS = '#include <cuda_fp16.h>\n#include <cuda_bf16.h>\n'
DEFAULT_BLOCK = 256
_IDENT = re.compile(r'[A-Za-z_][A-Za-z0-9_]*\Z')
_MAX_BLOCK = (1024, 1024, 64)
_MAX_GRID = (2 ** 31 - 1, 65535, 65535)


def _dims3(dims, what):
    dims = tuple(dims)
    if not 1 <= len(dims) <= 3 or not all(
            isinstance(d, (int, np.integer)) and d >= 1 for d in dims):
        raise ValueError('%s must be 1 to 3 positive ints, got %r' % (what, dims))
    return tuple(int(d) for d in dims) + (1,) * (3 - len(dims))


def launch_geometry(grid_dims, block_dims, n_elements):
    """(grid, block), 3 ints each. With both None: one thread per element
    of the first output in blocks of :data:`DEFAULT_BLOCK` (the port's
    counterpart of XLA and Pallas choosing the launch geometry). Raises
    ValueError for one without the other, or for a geometry the card does
    not take (more than 1024 threads a block, a dim past its limit)."""
    if grid_dims is None and block_dims is None:
        return ((max(1, -(-n_elements // DEFAULT_BLOCK)), 1, 1),
                (DEFAULT_BLOCK, 1, 1))
    if grid_dims is None or block_dims is None:
        raise ValueError('give both grid_dims and block_dims, or neither')
    grid, block = _dims3(grid_dims, 'grid_dims'), _dims3(block_dims, 'block_dims')
    if block[0] * block[1] * block[2] > 1024:
        raise ValueError('a block holds at most 1024 threads, got %s = %d'
                         % (block, block[0] * block[1] * block[2]))
    for dims, limit, what in ((block, _MAX_BLOCK, 'block_dims'),
                              (grid, _MAX_GRID, 'grid_dims')):
        if any(d > m for d, m in zip(dims, limit)):
            raise ValueError('%s %s exceed the limits %s' % (what, dims, limit))
    return grid, block


class Rtc:
    """Compile a kernel from source at run time and run it on NDArrays
    (reference rtc.py:24). ``inputs`` and ``outputs`` are lists of
    (name, NDArray): the names are the kernel's argument names, and the
    outputs' NDArrays declare their shapes and dtypes. ``kernel`` is the
    body's source; ``mode`` is ``'torch'`` or ``'cuda'`` (see the module's
    doc). ``launches`` counts this Rtc's kernel launches."""

    def __init__(self, name, inputs, outputs, kernel, mode='torch'):
        if mode in ('jnp', 'pallas'):
            raise ValueError("mode %r is the JAX package's; the port's "
                             "counterpart is %r" % (mode, {'jnp': 'torch',
                                                           'pallas': 'cuda'}[mode]))
        if mode not in ('torch', 'cuda'):
            raise ValueError("mode must be 'torch' or 'cuda'")
        self.name = name
        self._in_names = [i[0] for i in inputs]
        self._out_names = [o[0] for o in outputs]
        for n in [name] + self._in_names + self._out_names:
            if not isinstance(n, str) or not _IDENT.match(n):
                raise ValueError('%r is not a C identifier' % (n,))
        self._out_shapes = [tuple(o[1].shape) for o in outputs]
        self._out_dtypes = [o[1].handle.dtype for o in outputs]
        self._mode = mode
        self._source = textwrap.dedent(kernel)
        self.launches = 0
        # (input shapes, dtypes, device) -> compiled function: a push of
        # known shapes skips building and hashing the source, about a sixth
        # of a push's host time (nvrtc's own cache, keyed by the source,
        # serves a second Rtc of the same source)
        self._kernels = {}
        if mode == 'cuda':
            if not self._source.strip():
                raise ValueError('a cuda-mode kernel body is empty')
            for dt in self._out_dtypes:
                self._c_type(dt)
        else:
            self._fn = self._compile_torch()

    # -- torch mode -------------------------------------------------------
    def _compile_torch(self):
        # wrap the body into a function of the declared inputs that returns
        # the declared outputs
        body = textwrap.indent(self._source, '    ')
        fn_src = 'def %s(%s):\n%s\n    return (%s,)' % (
            self.name, ', '.join(self._in_names), body,
            ', '.join(self._out_names))
        env = {'torch': torch}
        exec(compile(fn_src, '<rtc:%s>' % self.name, 'exec'), env)
        return env[self.name]

    # -- cuda mode --------------------------------------------------------
    @staticmethod
    def _c_type(dtype):
        if dtype not in C_TYPES:
            raise TypeError('cuda-mode Rtc takes %s, not %s'
                            % (', '.join(str(d) for d in C_TYPES), dtype))
        return C_TYPES[dtype]

    def cuda_source(self, in_shapes, in_dtypes):
        """The CUDA C source that ``mode='cuda'`` compiles for inputs of
        these shapes and torch dtypes."""
        in_types = [self._c_type(d) for d in in_dtypes]
        out_types = [self._c_type(d) for d in self._out_dtypes]
        params = (['const %s* __restrict__ %s' % (t, n)
                   for t, n in zip(in_types, self._in_names)]
                  + ['%s* %s' % (t, n) for t, n in zip(out_types, self._out_names)])
        lines = []
        for n, shape in zip(self._in_names + self._out_names,
                            list(in_shapes) + self._out_shapes):
            lines.append('const int %s_ndim = %d;' % (n, len(shape)))
            dims = ', '.join(str(int(d)) for d in shape) or '1'
            lines.append('const int %s_dims[] = {%s};' % (n, dims))
        half = any(t in ('__half', '__nv_bfloat16') for t in in_types + out_types)
        return ('%sextern "C" __global__ void %s(%s) {\n%s\n%s\n}\n'
                % (_HALF_HEADERS if half else '', self.name, ', '.join(params),
                   '\n'.join(lines), self._source.rstrip('\n')))

    def _push_cuda(self, tensors, outputs, grid_dims, block_dims):
        n = int(np.prod(self._out_shapes[0])) if self._out_shapes else 0
        grid, block = launch_geometry(grid_dims, block_dims, n)
        devices = ({t.device for t in tensors if isinstance(t, torch.Tensor)}
                   or {outputs[0].handle.device})
        if len(devices) > 1:
            raise ValueError('inputs of %s are on several devices: %s'
                             % (self.name, sorted(map(str, devices))))
        device, = devices
        if device.type != 'cuda':
            raise ValueError("mode='cuda' runs on CUDA tensors; %s got "
                             'tensors on %s' % (self.name, device))
        tensors = [(t if isinstance(t, torch.Tensor)
                    else torch.as_tensor(t, device=device)).contiguous()
                   for t in tensors]
        bufs = [torch.empty(s, dtype=d, device=device)
                for s, d in zip(self._out_shapes, self._out_dtypes)]
        if grid_dims is not None or n > 0:
            key = (tuple(tuple(t.shape) for t in tensors),
                   tuple(t.dtype for t in tensors), device)
            fn = self._kernels.get(key)
            if fn is None:
                fn = self._kernels[key] = nvrtc.compile_kernel(
                    self.cuda_source(*key[:2]), self.name, device)
            args = [ctypes.c_void_p(t.data_ptr()) for t in tensors + bufs]
            nvrtc.launch(fn, device, grid, block, args)
            self.launches += 1
        return bufs

    def push(self, inputs, outputs, grid_dims=None, block_dims=None):
        """Run the kernel (reference rtc.py push). In ``'cuda'`` mode
        ``grid_dims``/``block_dims`` (1 to 3 ints each) set the launch
        geometry (see :func:`launch_geometry`); ``'torch'`` mode takes
        and ignores them, as the JAX package does."""
        if len(inputs) != len(self._in_names):
            raise ValueError('expected %d inputs' % len(self._in_names))
        if len(outputs) != len(self._out_names):
            raise ValueError('expected %d outputs' % len(self._out_names))
        tensors = [x.handle if isinstance(x, NDArray) else x for x in inputs]
        if self._mode == 'cuda':
            res = self._push_cuda(tensors, outputs, grid_dims, block_dims)
        else:
            device = next((t.device for t in tensors if isinstance(t, torch.Tensor)),
                          outputs[0].handle.device if outputs else None)
            res = self._fn(*[t if isinstance(t, torch.Tensor)
                             else torch.as_tensor(t, device=device)
                             for t in tensors])
        for out, r in zip(outputs, res):
            r = torch.as_tensor(r, device=out.handle.device)
            out._data = r.to(out.handle.dtype).reshape(out.shape)
        return outputs
