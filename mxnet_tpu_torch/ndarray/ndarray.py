"""NDArray over a ``torch.Tensor``: the counterpart of
``mxnet_tpu/ndarray/ndarray.py``.

An NDArray holds a tensor and the Context it lives in. As in the JAX
package, an op never writes into its inputs' tensors: it returns new ones,
and "mutation" (``out=``, ``copyto`` into an NDArray, ``mutate_inputs``)
rebinds ``_data``. PyTorch queues work on the card asynchronously, so the
caller returns before the device finishes, and ``wait_to_read`` waits for
the device.

Ported here: the properties, host transfer, copies and context moves,
``astype``, ``reshape`` (with MXNet's special codes), the constructors and
:func:`invoke`. Not yet: the autograd tape (``attach_grad``/``backward``
come with ``autograd.py``; :func:`invoke` runs ops under
``torch.no_grad``), the arithmetic, comparison and indexing dunders and the
method forms of ops (they go through registry ops that are not ported yet),
the RNG that ``needs_rng`` ops take, and sparse storage.
"""
import numpy as np
import torch

from ..base import MXNetError, dtype_of, normalize_attrs, np_dtype, torch_dtype
from ..context import Context, current_context
from ..ops import registry as _reg

__all__ = ['NDArray', 'array', 'zeros', 'ones', 'empty', 'full', 'invoke',
           'from_torch']


def _context_of(tensor):
    if tensor.device.type == 'cuda':
        return Context('gpu', tensor.device.index or 0)
    return Context('cpu', 0)


class NDArray:
    """Multi-dimensional, context-bound array (reference ndarray.py:150)."""

    __slots__ = ('_data', '_ctx', '__weakref__')

    def __init__(self, data, ctx=None):
        self._data = data
        self._ctx = ctx if ctx is not None else _context_of(data)

    # -- basic properties -------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """numpy dtype, bfloat16 as ``ml_dtypes.bfloat16`` (as the JAX
        package reports it)."""
        return dtype_of(self._data.dtype)

    @property
    def size(self):
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self):
        return self._ctx

    ctx = context

    @property
    def handle(self):
        """The backing torch.Tensor."""
        return self._data

    def __repr__(self):
        return '\n%s\n<NDArray %s @%s>' % (
            str(self.asnumpy()), 'x'.join(str(s) for s in self.shape), self._ctx)

    def __len__(self):
        if not self.shape:
            raise TypeError('len() of unsized object')
        return self.shape[0]

    # -- synchronization --------------------------------------------------
    def wait_to_read(self):
        """Wait until the device has finished the work queued on it
        (``torch.cuda.synchronize`` of its device; nothing on the CPU)."""
        if self._data.device.type == 'cuda':
            torch.cuda.synchronize(self._data.device)

    # -- host transfer ----------------------------------------------------
    def asnumpy(self):
        """A numpy copy the caller owns; bfloat16 comes back as float32, as
        in the JAX package."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        arr = t.cpu().numpy()
        return arr.copy() if t.device.type == 'cpu' else arr

    def asscalar(self):
        if self.size != 1:
            raise ValueError('The current array is not a scalar')
        return self.asnumpy().reshape(())[()]

    # -- copies / context movement ----------------------------------------
    def copy(self):
        return self.copyto(self._ctx)

    def copyto(self, other):
        """Copy into ``other`` (an NDArray, whose data is rebound) or onto a
        Context (a new NDArray)."""
        if isinstance(other, NDArray):
            other._data = self._data.to(other._ctx.torch_device(), copy=True)
            return other
        if isinstance(other, Context):
            return NDArray(self._data.to(other.torch_device(), copy=True), other)
        raise TypeError('copyto does not support type ' + str(type(other)))

    def as_in_context(self, context):
        if context == self._ctx:
            return self
        return self.copyto(context)

    def astype(self, dtype, copy=True):
        d = torch_dtype(dtype)
        if not copy and self._data.dtype == d:
            return self
        return NDArray(self._data.to(d, copy=True), self._ctx)

    def reshape(self, *shape, **kwargs):
        """Reshape, with MXNet's special codes: 0 copies a dim, -1 infers
        one, -2 copies the rest, -3 merges two, -4 splits one in two."""
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        shape = kwargs.get('shape', shape)
        out = _infer_reshape(list(self.shape), list(shape))
        return NDArray(self._data.reshape(out), self._ctx)


def _infer_reshape(src, target):
    """The output shape of MXNet's Reshape (the JAX package's
    ``shape_ops._infer_reshape``)."""
    out = []
    src_idx = 0
    i = 0
    while i < len(target):
        t = target[i]
        if t == 0:
            out.append(src[src_idx]); src_idx += 1
        elif t == -1:
            out.append(-1); src_idx += 1
        elif t == -2:
            out.extend(src[src_idx:]); src_idx = len(src)
        elif t == -3:
            out.append(src[src_idx] * src[src_idx + 1]); src_idx += 2
        elif t == -4:
            a, b = target[i + 1], target[i + 2]
            cur = src[src_idx]
            if a == -1:
                a = cur // b
            if b == -1:
                b = cur // a
            out.extend([a, b]); src_idx += 1; i += 2
        else:
            out.append(t); src_idx += 1
        i += 1
    if -1 in out:
        known = int(np.prod([d for d in out if d != -1])) or 1
        total = int(np.prod(src)) if src else 1
        out[out.index(-1)] = total // known
    return out


def invoke(op_name, inputs, attrs=None, out=None):
    """Execute a registered op imperatively on the inputs' tensors.

    The JAX package runs a cached jit closure and records a vjp on the
    autograd tape; here the op's function runs eagerly under
    ``torch.no_grad`` (the tape comes with ``autograd.py``). The outputs
    live in the first input's context."""
    op = _reg.get(op_name)
    attrs = dict(attrs or {})
    # ctx is an op kwarg in the reference: it directs the placement of ops
    # without inputs (none is ported) and never reaches the op's function
    attrs.pop('ctx', None)
    attrs = normalize_attrs(attrs)
    if op.train_aware:
        attrs['__is_train__'] = False     # no autograd recording yet
    if op.needs_rng:
        raise MXNetError('op %r draws random numbers; the port has no RNG '
                         'streams yet' % op_name)

    with torch.no_grad():
        outs = op.fn(attrs, *[i._data for i in inputs])
    outs_t = tuple(outs) if isinstance(outs, (tuple, list)) else (outs,)

    # write mutated aux outputs back into their input NDArrays
    for in_idx, out_idx in op.mutate_inputs.items():
        if out_idx < len(outs_t):
            inputs[in_idx]._data = outs_t[out_idx]

    ctx = inputs[0]._ctx
    results = [NDArray(outs_t[i], ctx)
               for i in range(op.n_visible_outputs(attrs))]
    if out is not None:
        outs_list = out if isinstance(out, (list, tuple)) else [out]
        for dst, src in zip(outs_list, results):
            # a shape-mismatched out buffer is rejected, as the reference
            # does at shape inference
            if dst.shape != src.shape:
                raise ValueError('out has shape %s but %s produced %s'
                                 % (dst.shape, op_name, src.shape))
            dst._data = src._data
        return out
    return results[0] if len(results) == 1 else results


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------

def from_torch(data, ctx=None):
    """Wrap a torch tensor (no copy); the context defaults to its device."""
    return NDArray(data, ctx)


def _place(tensor, ctx):
    ctx = ctx if ctx is not None else current_context()
    return NDArray(tensor.to(ctx.torch_device()), ctx)


def array(source_array, ctx=None, dtype=None):
    """Reference ndarray.py:1988 mx.nd.array. Python lists default to
    float32; numpy arrays and NDArrays keep their dtype, with 64-bit types
    narrowed to 32 bits as in the JAX package."""
    keep_dtype = isinstance(source_array, (np.ndarray, NDArray))
    if isinstance(source_array, NDArray):
        src = source_array.asnumpy()
    else:
        src = np.asarray(source_array)
    if dtype is None:
        if not keep_dtype:
            dtype = np.float32
        else:
            dtype = src.dtype
    d = np_dtype(dtype)
    if d == np.int64:
        d = np.dtype(np.int32)
    elif d == np.float64:
        d = np.dtype(np.float32)
    td = torch_dtype(d)
    if td == torch.bfloat16:
        # numpy holds no bfloat16 that torch reads: go through f32 and
        # round once (to nearest even, as jnp.asarray does)
        t = torch.from_numpy(np.ascontiguousarray(src, dtype=np.float32)).to(td)
    else:
        t = torch.from_numpy(np.array(src, dtype=d))
    return _place(t, ctx)


def empty(shape, ctx=None, dtype='float32'):
    return zeros(shape, ctx, dtype)


def zeros(shape, ctx=None, dtype='float32', **kwargs):
    return full(shape, 0, ctx, dtype)


def ones(shape, ctx=None, dtype='float32', **kwargs):
    return full(shape, 1, ctx, dtype)


def full(shape, val, ctx=None, dtype='float32', out=None):
    ctx = ctx if ctx is not None else current_context()
    if isinstance(shape, int):
        shape = (shape,)
    res = NDArray(torch.full(tuple(shape), val, dtype=torch_dtype(dtype),
                             device=ctx.torch_device()), ctx)
    if out is not None:
        out._data = res._data
        return out
    return res
