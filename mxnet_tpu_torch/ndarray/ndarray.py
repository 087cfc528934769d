"""NDArray over a ``torch.Tensor``: the counterpart of
``mxnet_tpu/ndarray/ndarray.py``.

An NDArray holds a tensor and the Context it lives in. As in the JAX
package, an op never writes into its inputs' tensors: it returns new ones,
and "mutation" (``out=``, ``copyto`` into an NDArray, ``mutate_inputs``)
rebinds ``_data``. PyTorch queues work on the card asynchronously, so the
caller returns before the device finishes, and ``wait_to_read`` waits for
the device.

Ported here: the properties, host transfer, copies and context moves,
``astype``, ``reshape`` (with MXNet's special codes), the arithmetic,
comparison and in-place dunders (through the registry's elemwise ops),
indexing (negative steps included), the reduce, unary and shape-op method
forms, the constructors, ``arange``, ``concatenate``, ``stack``,
``moveaxis``, ``waitall`` and :func:`invoke`.

``reshape`` and ``moveaxis`` may return torch views of the same storage.
Nothing writes into a tensor in place, so no NDArray sees another's
write: ``__setitem__`` copies the tensor, writes the copy and rebinds
``_data``, and ``__getitem__`` returns a copy, as jnp's indexing does.
Integer index arrays follow jnp: a negative index counts from the end, an
index still out of range is clamped on a read and its write is dropped
(never passed to torch, where it would fault on the card).

Autograd (:mod:`..autograd`): while recording, :func:`invoke` runs a
differentiable op with grad enabled, so torch's graph is the tape; outside
it ops run under ``torch.no_grad``. ``attach_grad`` marks an array as a
variable, whose tensor ``_data`` keeps as a leaf that requires grad
whatever it is rebound to (an optimizer's ``out=`` write, ``x[:] = ...``),
as the JAX package keeps its leaf on the NDArray, not on the value. The
direct tensor methods (``astype``, ``reshape``, indexing, ``copyto``) record
only while recording, too. A ``needs_rng`` op gets its device's generator
(:func:`..random.generator`).

Sparse storage (:mod:`.sparse`): ``stype`` is 'default' here,
``tostype`` casts to a sparse container, and a dense (op) sparse
arithmetic lowers the sparse operand to dense.
"""
import numpy as np
import torch

from .. import autograd as _ag
from .. import random as _random
from ..base import dtype_of, normalize_attrs, np_dtype, torch_dtype
from ..context import Context, current_context
from ..ops import registry as _reg
from ..ops.shape_ops import flip_steps, infer_reshape

__all__ = ['NDArray', 'array', 'zeros', 'ones', 'empty', 'full', 'arange',
           'invoke', 'waitall', 'concatenate', 'stack', 'moveaxis',
           'from_torch']

_NUMERIC = (float, int, np.generic)


def waitall():
    """Wait until every card has finished the work queued on it
    (reference MXNDArrayWaitAll): ``torch.cuda.synchronize`` on each
    device; nothing without CUDA, where ops run synchronously."""
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def _context_of(tensor):
    if tensor.device.type == 'cuda':
        return Context('gpu', tensor.device.index or 0)
    return Context('cpu', 0)


class NDArray:
    """Multi-dimensional, context-bound array (reference ndarray.py:150)."""

    __slots__ = ('_t', '_ctx', '_grad', '_grad_req', '_fresh_grad', '_hist',
                 '__weakref__')

    def __init__(self, data, ctx=None):
        self._grad = None
        self._grad_req = None       # set by autograd.mark_variables
        self._fresh_grad = True
        self._hist = None           # the recorded op behind it, if any
        self._t = data
        self._ctx = ctx if ctx is not None else _context_of(data)

    @property
    def _data(self):
        """The backing tensor."""
        return self._t

    @_data.setter
    def _data(self, tensor):
        # a marked variable stays a leaf of the graph, whatever its value
        # is rebound to
        if self._grad_req is not None:
            tensor = _ag.make_leaf(self, tensor)
        self._t = tensor

    # pickled as the JAX package pickles an NDArray (the optimizer states'
    # files): the value as numpy, bfloat16 as float32 with a flag, and the
    # context; it is placed back on that context when it is loaded
    def __getstate__(self):
        t = self._t.detach()
        bf16 = t.dtype == torch.bfloat16
        return {'data': (t.float() if bf16 else t).cpu().numpy(),
                'ctx': self._ctx, 'bf16': bf16}

    def __setstate__(self, state):
        t = torch.from_numpy(np.array(state['data']))
        if state.get('bf16'):
            t = t.to(torch.bfloat16)
        ctx = state['ctx']
        self.__init__(t.to(ctx.torch_device()), ctx)

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
    def stype(self):
        return 'default'

    @property
    def handle(self):
        """The backing torch.Tensor."""
        return self._data

    @property
    def grad(self):
        """The gradient buffer ``attach_grad`` made, or None."""
        return self._grad

    # -- autograd ---------------------------------------------------------
    def attach_grad(self, grad_req='write', stype=None):
        """Mark this array as a variable with a zero gradient buffer."""
        grad = NDArray(torch.zeros_like(self._data.detach()), self._ctx)
        _ag.mark_variables([self], [grad], grad_req)
        self._fresh_grad = True

    def detach(self):
        """The same value, outside any recorded graph."""
        return NDArray(self._data.detach(), self._ctx)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        _ag.backward([self], [out_grad] if out_grad is not None else None,
                     retain_graph, train_mode)

    def __repr__(self):
        return '\n%s\n<NDArray %s @%s>' % (
            str(self.asnumpy()), 'x'.join(str(s) for s in self.shape), self._ctx)

    def __len__(self):
        if not self.shape:
            raise TypeError('len() of unsized object')
        return self.shape[0]

    def __bool__(self):
        if self.size != 1:
            raise ValueError('The truth value of an NDArray with multiple '
                             'elements is ambiguous.')
        return bool(self.asscalar())

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
        Context (a new NDArray). The copy is recorded while recording."""
        with _recording_grad():
            if isinstance(other, NDArray):
                other._data = self._data.to(other._ctx.torch_device(),
                                            copy=True)
                return other
            if isinstance(other, Context):
                return NDArray(self._data.to(other.torch_device(), copy=True),
                               other)
        raise TypeError('copyto does not support type ' + str(type(other)))

    def as_in_context(self, context):
        if context == self._ctx:
            return self
        return self.copyto(context)

    def astype(self, dtype, copy=True):
        d = torch_dtype(dtype)
        if not copy and self._data.dtype == d:
            return self
        with _recording_grad():
            return NDArray(self._data.to(d, copy=True), self._ctx)

    def tostype(self, stype):
        """This array as ``stype`` storage ('default' is the array
        itself; 'row_sparse' and 'csr' build sparse containers)."""
        if stype == 'default':
            return self
        from .sparse import cast_storage
        return cast_storage(self, stype)

    def reshape(self, *shape, **kwargs):
        """Reshape, with MXNet's special codes: 0 copies a dim, -1 infers
        one, -2 copies the rest, -3 merges two, -4 splits one in two."""
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        shape = kwargs.get('shape', shape)
        out = infer_reshape(list(self.shape), list(shape))
        with _recording_grad():
            return NDArray(self._data.reshape(out), self._ctx)

    def broadcast_to(self, shape):
        return invoke('broadcast_to', [self], {'shape': tuple(shape)})

    def broadcast_axes(self, axis=(), size=()):
        return invoke('broadcast_axes', [self],
                      {'axis': (axis,) if isinstance(axis, int) else tuple(axis),
                       'size': (size,) if isinstance(size, int) else tuple(size)})

    # -- method forms of the shape ops ------------------------------------
    def reshape_like(self, other):
        return invoke('reshape_like', [self, other], {})

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return invoke('transpose', [self], {'axes': axes} if axes else {})

    @property
    def T(self):
        return self.transpose()

    def flatten(self):
        return invoke('Flatten', [self], {})

    def expand_dims(self, axis):
        return invoke('expand_dims', [self], {'axis': axis})

    def squeeze(self, axis=None):
        return invoke('squeeze', [self], {'axis': axis})

    def swapaxes(self, dim1, dim2):
        return invoke('SwapAxis', [self], {'dim1': dim1, 'dim2': dim2})

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return invoke('SliceChannel', [self],
                      {'num_outputs': num_outputs, 'axis': axis,
                       'squeeze_axis': squeeze_axis})

    def slice(self, begin, end, step=None):
        return invoke('slice', [self], {'begin': tuple(begin), 'end': tuple(end),
                                        'step': tuple(step) if step else None})

    def slice_axis(self, axis, begin, end):
        return invoke('slice_axis', [self],
                      {'axis': axis, 'begin': begin, 'end': end})

    def take(self, indices, axis=0, mode='clip'):
        return invoke('take', [self, indices], {'axis': axis, 'mode': mode})

    def one_hot(self, depth, on_value=1.0, off_value=0.0, dtype='float32'):
        return invoke('one_hot', [self], {'depth': depth, 'on_value': on_value,
                                          'off_value': off_value, 'dtype': dtype})

    def pick(self, index, axis=-1, keepdims=False):
        return invoke('pick', [self, index], {'axis': axis, 'keepdims': keepdims})

    def clip(self, a_min, a_max):
        return invoke('clip', [self], {'a_min': a_min, 'a_max': a_max})

    def tile(self, reps):
        return invoke('tile', [self], {'reps': tuple(reps)})

    def repeat(self, repeats, axis=None):
        return invoke('repeat', [self], {'repeats': repeats, 'axis': axis})

    def flip(self, axis):
        return invoke('reverse', [self],
                      {'axis': (axis,) if isinstance(axis, int) else tuple(axis)})

    def pad(self, mode, pad_width, constant_value=0):
        return invoke('Pad', [self], {'mode': mode, 'pad_width': tuple(pad_width),
                                      'constant_value': constant_value})

    def sort(self, axis=-1, is_ascend=True):
        return invoke('sort', [self], {'axis': axis, 'is_ascend': is_ascend})

    def argsort(self, axis=-1, is_ascend=True, dtype='float32'):
        return invoke('argsort', [self], {'axis': axis, 'is_ascend': is_ascend,
                                          'dtype': dtype})

    def topk(self, axis=-1, k=1, ret_typ='indices', is_ascend=False):
        return invoke('topk', [self], {'axis': axis, 'k': k, 'ret_typ': ret_typ,
                                       'is_ascend': is_ascend})

    def dot(self, other, transpose_a=False, transpose_b=False):
        return invoke('dot', [self, other], {'transpose_a': transpose_a,
                                             'transpose_b': transpose_b})

    # -- indexing ---------------------------------------------------------
    def __setitem__(self, key, value):
        """A functional update, as in the JAX package: the write goes into
        a new tensor that replaces ``_data``. It is not recorded: the array
        leaves its recorded graph (a marked variable stays a leaf)."""
        if key is not None:
            _check_key(key)
        data = self._data.detach()
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value))
        # cast to x's dtype first, as jnp.asarray(value, dtype) does
        value = value.detach().to(device=data.device, dtype=data.dtype)
        with torch.no_grad():
            self._data = _write(data, slice(None) if key is None else key,
                                value)
        self._hist = None

    def __getitem__(self, key):
        _check_key(key)
        if _ag.is_recording() and self._data.requires_grad:
            # recorded, so that gradients flow through indexing
            return invoke('_slice_like_getitem', [self],
                          {'key': _freeze_key(key)})
        with torch.no_grad():
            return NDArray(_read(self._data, key), self._ctx)

    # -- operator overloads (dispatch to registered ops, reference
    #    ndarray.py __add__ etc -> broadcast_add/_plus_scalar) -------------
    def __add__(self, other):
        return _binary(self, other, 'broadcast_add', '_plus_scalar')

    def __radd__(self, other):
        return self.__add__(other)

    def __iadd__(self, other):
        return self._rebind(self.__add__(other))

    def _rebind(self, out):
        self._data = out._data
        self._hist = out._hist
        return self

    def __sub__(self, other):
        return _binary(self, other, 'broadcast_sub', '_minus_scalar')

    def __rsub__(self, other):
        return _scalar(self, other, '_rminus_scalar')

    def __isub__(self, other):
        return self._rebind(self.__sub__(other))

    def __mul__(self, other):
        return _binary(self, other, 'broadcast_mul', '_mul_scalar')

    def __rmul__(self, other):
        return self.__mul__(other)

    def __imul__(self, other):
        return self._rebind(self.__mul__(other))

    def __truediv__(self, other):
        return _binary(self, other, 'broadcast_div', '_div_scalar')

    def __rtruediv__(self, other):
        return _scalar(self, other, '_rdiv_scalar')

    def __itruediv__(self, other):
        return self._rebind(self.__truediv__(other))

    def __mod__(self, other):
        return _binary(self, other, 'broadcast_mod', '_mod_scalar')

    def __rmod__(self, other):
        return _scalar(self, other, '_rmod_scalar')

    def __pow__(self, other):
        return _binary(self, other, 'broadcast_power', '_power_scalar')

    def __rpow__(self, other):
        return _scalar(self, other, '_rpower_scalar')

    def __neg__(self):
        return invoke('negative', [self], {})

    def __abs__(self):
        return invoke('abs', [self], {})

    def __eq__(self, other):
        return _binary(self, other, 'broadcast_equal', '_equal_scalar')

    def __ne__(self, other):
        return _binary(self, other, 'broadcast_not_equal', '_not_equal_scalar')

    def __gt__(self, other):
        return _binary(self, other, 'broadcast_greater', '_greater_scalar')

    def __ge__(self, other):
        return _binary(self, other, 'broadcast_greater_equal',
                       '_greater_equal_scalar')

    def __lt__(self, other):
        return _binary(self, other, 'broadcast_lesser', '_lesser_scalar')

    def __le__(self, other):
        return _binary(self, other, 'broadcast_lesser_equal',
                       '_lesser_equal_scalar')

    def __hash__(self):
        return id(self)


def _binary(lhs, rhs, op_broadcast, op_scalar):
    if isinstance(rhs, NDArray):
        return invoke(op_broadcast, [lhs, rhs], {})
    if isinstance(rhs, _NUMERIC):
        return invoke(op_scalar, [lhs], {'scalar': float(rhs)})
    from .sparse import BaseSparseNDArray
    if isinstance(rhs, BaseSparseNDArray):
        # dense (op) sparse gives dense, as the reference's elemwise
        # dense/sparse fallbacks do
        return invoke(op_broadcast, [lhs, rhs.tostype('default')], {})
    raise TypeError('type %s not supported' % str(type(rhs)))


def _scalar(lhs, rhs, op_scalar):
    return invoke(op_scalar, [lhs], {'scalar': float(rhs)})


def _reduce_method(name):
    def method(self, axis=None, keepdims=False, **kwargs):
        attrs = {'axis': axis if axis is None or isinstance(axis, int)
                 else tuple(axis), 'keepdims': keepdims}
        attrs.update(kwargs)
        return invoke(name, [self], attrs)
    method.__name__ = name
    return method


def _unary_method(name):
    def method(self, **kwargs):
        return invoke(name, [self], kwargs)
    method.__name__ = name
    return method


for _n in ['sum', 'nansum', 'prod', 'nanprod', 'mean', 'max', 'min', 'norm',
           'argmax', 'argmin']:
    setattr(NDArray, _n, _reduce_method(_n))
# the JAX package's list
for _n in ['abs', 'sign', 'round', 'rint', 'fix', 'floor', 'ceil', 'trunc',
           'sin', 'cos', 'tan', 'arcsin', 'arccos', 'arctan', 'degrees',
           'radians', 'sinh', 'cosh', 'tanh', 'arcsinh', 'arccosh', 'arctanh',
           'exp', 'expm1', 'log', 'log10', 'log2', 'log1p', 'sqrt', 'rsqrt',
           'cbrt', 'square', 'reciprocal', 'relu', 'sigmoid', 'softmax',
           'log_softmax', 'zeros_like', 'ones_like']:
    setattr(NDArray, _n, _unary_method(_n))


# ---------------------------------------------------------------------------
# indexing with jnp's rules for integer index arrays
# ---------------------------------------------------------------------------

def _check_key(key):
    """TypeError for the keys jnp refuses: a list (not a tuple) as the whole
    key, and a float index, array or scalar, anywhere in it."""
    if isinstance(key, list):
        raise TypeError('Using a non-tuple sequence for multidimensional '
                        'indexing is not allowed; use `arr[array(seq)]` '
                        'instead of `arr[seq]`')
    for k in _key_items(key):
        if isinstance(k, NDArray):
            k = k._data
        if isinstance(k, torch.Tensor):
            floating, name = k.is_floating_point(), str(k.dtype)[6:]
        elif isinstance(k, (np.ndarray, float, np.floating)):
            dt = np.asarray(k).dtype
            floating, name = np.issubdtype(dt, np.floating), str(dt)
        else:
            continue
        if floating:
            raise TypeError('Indexer must have integer or boolean type, got '
                            'indexer with type %s' % name)


def _key_items(key):
    return key if isinstance(key, tuple) else (key,)


def _as_index(k, device):
    """An index item as torch takes it: NDArrays, numpy arrays and lists
    become tensors on ``device`` (integer ones int64; a float one was
    refused by :func:`_check_key`)."""
    if isinstance(k, NDArray):
        k = k._data
    elif isinstance(k, (np.ndarray, list)):
        k = torch.as_tensor(np.asarray(k))
    if isinstance(k, torch.Tensor):
        k = k.to(device)
        if k.dtype != torch.bool:
            k = k.long()
    return k


def _array_axes(key, ndim, device):
    """(key items as torch takes them, {position in key: the axis an
    integer index array indexes}, {position in key: the axis a slice with
    a negative step walks})."""
    items = [_as_index(k, device) for k in _key_items(key)]
    used = sum(k.dim() if isinstance(k, torch.Tensor) and k.dtype == torch.bool
               else 0 if k is None or k is Ellipsis else 1 for k in items)
    axes, flips, dim = {}, {}, 0
    for i, k in enumerate(items):
        if k is Ellipsis:
            dim += ndim - used
        elif k is None:
            continue
        elif isinstance(k, torch.Tensor) and k.dtype == torch.bool:
            dim += k.dim()
        else:
            if isinstance(k, torch.Tensor):
                axes[i] = dim
            elif isinstance(k, slice) and k.step is not None and k.step < 0:
                flips[i] = dim
            dim += 1
    return items, axes, flips


def _wrap(idx, n):
    return torch.where(idx < 0, idx + n, idx)


def _read(data, key):
    """``data[key]`` as a new tensor: integer index arrays wrap negative
    indices once and clamp the rest into range, as jnp's gather does."""
    items, axes, flips = _array_axes(key, data.dim(), data.device)
    for i, ax in axes.items():
        n = data.shape[ax]
        items[i] = _wrap(items[i], n).clamp(0, max(n - 1, 0))
    out = flip_steps(data, items, flips)[tuple(items)]
    if out.untyped_storage().data_ptr() == data.untyped_storage().data_ptr():
        out = out.clone()          # a view from basic indexing: copy it
    return out


def _write(data, key, value):
    """A copy of ``data`` with ``value`` written at ``key``. Integer index
    arrays wrap negative indices once; a write to an index still out of
    range is dropped, as jnp's ``.at[].set`` drops it: such indices go to a
    scratch slot appended to their axis, which is cut off afterwards."""
    items, axes, flips = _array_axes(key, data.dim(), data.device)
    new = flip_steps(data, items, flips)
    padded = []
    for i, ax in axes.items():
        n = data.shape[ax]
        idx = _wrap(items[i], n)
        bad = (idx < 0) | (idx >= n)
        if bool(bad.any()):
            idx = torch.where(bad, torch.full_like(idx, n), idx)
            pad = list(new.shape)
            pad[ax] = 1
            new = torch.cat([new, new.new_zeros(pad)], ax)
            padded.append((ax, n))
        items[i] = idx
    if new is data:
        new = data.clone(memory_format=torch.contiguous_format)
    new[tuple(items)] = value
    for ax, n in padded:
        new = new.narrow(ax, 0, n)
    if flips:
        new = new.flip(tuple(flips.values()))
    return new.contiguous()


@_reg.register('_slice_like_getitem')
def _slice_like_getitem(attrs, x):
    return _read(x, _thaw_key(attrs['key']))


def _freeze_key(key):
    """Make an indexing key hashable for the attr dict."""
    if isinstance(key, tuple):
        return tuple(_freeze_key(k) for k in key)
    if isinstance(key, slice):
        return ('__slice__', key.start, key.stop, key.step)
    if isinstance(key, NDArray):
        key = key._data
    if isinstance(key, (torch.Tensor, np.ndarray)):
        arr = key.cpu().numpy() if isinstance(key, torch.Tensor) else key
        return ('__array__', tuple(arr.ravel().tolist()), tuple(arr.shape))
    return key


def _thaw_key(key):
    if isinstance(key, tuple):
        if len(key) == 4 and key[0] == '__slice__':
            return slice(key[1], key[2], key[3])
        if len(key) == 3 and key[0] == '__array__':
            return np.array(key[1]).reshape(key[2]).astype(np.int64)
        return tuple(_thaw_key(k) for k in key)
    return key


def _recording_grad():
    """torch's grad mode for a direct tensor method: on while recording."""
    return torch.set_grad_enabled(_ag.is_recording())


def invoke(op_name, inputs, attrs=None, out=None):
    """Execute a registered op imperatively on the inputs' tensors.

    The JAX package runs a cached jit closure and, while recording, a
    ``jax.vjp`` that it puts on its tape. Here the op's function runs
    eagerly: with grad enabled while recording a differentiable op on an
    input that requires grad (torch's graph is the tape), else under
    ``torch.no_grad``. A ``needs_rng`` op gets its device's generator as
    its last argument. The outputs live in the first input's context;
    those of an op without inputs in the ``ctx`` attr's, or the current
    one."""
    op = _reg.get(op_name)
    attrs = dict(attrs or {})
    # ctx is an op kwarg in the reference: it directs the placement of ops
    # without inputs and never reaches the op's function
    req_ctx = attrs.pop('ctx', None)
    attrs = normalize_attrs(attrs)
    if op.train_aware:
        attrs['__is_train__'] = _ag.is_training()
    if inputs:
        ctx = inputs[0]._ctx
    else:
        ctx = req_ctx or current_context()
    args = [i._data for i in inputs]
    if op.needs_rng:
        args.append(_random.generator(
            args[0].device if args else ctx.torch_device()))

    recording = (_ag.is_recording() and op.differentiable
                 and any(t.requires_grad for t in args[:len(inputs)]))
    # a host op (the codecs, the Python-callback ops) runs through the
    # bridge: its outputs on its input's device, its callbacks in that
    # context, its recorded backward the op's own
    with torch.set_grad_enabled(recording):
        if op.host:
            outs = _reg.host_bridge(op, attrs)(*args)
        else:
            outs = op.fn(attrs, *args)
    outs_t = tuple(outs) if isinstance(outs, (tuple, list)) else (outs,)

    # write mutated aux outputs back into their input NDArrays; aux states
    # carry no gradient
    for in_idx, out_idx in op.mutate_inputs.items():
        if out_idx < len(outs_t):
            inputs[in_idx]._data = outs_t[out_idx].detach()

    if not inputs:      # a source op (_zeros, _arange) builds on the host
        outs_t = tuple(o.to(ctx.torch_device()) for o in outs_t)
    n_vis = op.n_visible_outputs(attrs)
    results = [NDArray(outs_t[i], ctx) for i in range(n_vis)]
    if recording:
        rec = _ag._Record(op_name, dict(attrs),
                          [_ag.history_of(i) for i in inputs], n_vis)
        for i, r in enumerate(results):
            r._hist = (rec, i)
    if out is not None:
        outs_list = out if isinstance(out, (list, tuple)) else [out]
        for dst, src in zip(outs_list, results):
            # a shape-mismatched out buffer is rejected, as the reference
            # does at shape inference
            if dst.shape != src.shape:
                raise ValueError('out has shape %s but %s produced %s'
                                 % (dst.shape, op_name, src.shape))
            dst._data = src._data
            dst._hist = src._hist
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


def narrowed(dtype):
    """``dtype`` as an NDArray stores it: 64-bit types narrowed to 32 bits,
    as in the JAX package (x64 off)."""
    d = np_dtype(dtype)
    if d == np.int64:
        return np.dtype(np.int32)
    if d == np.float64:
        return np.dtype(np.float32)
    return d


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
    d = narrowed(dtype)
    td = torch_dtype(d)
    if td == torch.bfloat16:
        # numpy holds no bfloat16 that torch reads: go through f32 and
        # round once (to nearest even, as jnp.asarray does)
        t = torch.from_numpy(np.ascontiguousarray(src, dtype=np.float32)).to(td)
    else:
        t = torch.from_numpy(np.array(src, dtype=d))
    return _place(t, ctx)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype='float32'):
    """Reference ndarray.py arange: numpy's arange in ``dtype`` (as jnp
    computes it for concrete arguments), each value ``repeat`` times."""
    d = np_dtype(dtype)
    arr = np.arange(start, stop, step, dtype=np.float32 if
                    torch_dtype(d) == torch.bfloat16 else d)
    if repeat > 1:
        arr = np.repeat(arr, repeat)
    return array(arr, ctx, d)


def concatenate(arrays, axis=0, always_copy=True):
    """``arrays`` joined along ``axis`` (the Concat op)."""
    return invoke('Concat', list(arrays), {'dim': axis, 'num_args': len(arrays)})


def stack(*arrays, **kwargs):
    """``arrays`` (or one list of them) stacked on a new ``axis``. The
    ``nd`` namespace's ``stack`` is the generated op, as in the JAX
    package."""
    axis = kwargs.get('axis', 0)
    arrs = (list(arrays[0]) if len(arrays) == 1
            and isinstance(arrays[0], (list, tuple)) else list(arrays))
    return invoke('stack', arrs, {'axis': axis, 'num_args': len(arrs)})


def moveaxis(tensor, source, destination):
    with _recording_grad():
        return NDArray(torch.movedim(tensor._data, source, destination),
                       tensor._ctx)


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
