"""Custom operators defined in Python: the counterpart of
``mxnet_tpu/operator.py`` (MXNet's python/mxnet/operator.py).

:class:`CustomOp` and :class:`CustomOpProp`, registered by name with
:func:`register`, are the ``Custom`` op: ``nd.Custom(..., op_type=name)``
runs one eagerly (recorded under ``autograd.record()`` as one node whose
backward is the op's ``backward``), ``sym.Custom`` puts one in a graph,
which the executor runs through ``registry.host_bridge``. A CustomOp gets
NDArrays in its node's context (on the card by default) and the outputs it
writes are made there, so a forward written over ``nd.softmax`` runs the
softmax kernel. One operator instance serves a node for the life of its
runner, as MXNet binds one operator to an executor.

The legacy forms :class:`PythonOp`, :class:`NumpyOp` (host numpy buffers,
the ``_Native`` op) and :class:`NDArrayOp` (NDArrays, the ``_NDArray`` op)
build their symbols through ``sym._internal``; their ops live in
``ops/legacy_ops.py``.
"""
from .ndarray.ndarray import NDArray, zeros
from .ops import registry as _reg

__all__ = ['CustomOp', 'CustomOpProp', 'register',
           'get_all_registered_operators', 'PythonOp', 'NumpyOp',
           'NDArrayOp']

_CUSTOM_OPS = {}

_CUSTOM_RESERVED = ('op_type', 'num_args', '__is_train__', 'name',
                    '__op_instance__')


class CustomOp:
    """Base class for custom Python operators."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError()

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError()

    def assign(self, dst, req, src):
        if req == 'null':
            return
        if req in ('write', 'inplace'):
            dst[:] = src
        elif req == 'add':
            dst[:] = dst + src


class CustomOpProp:
    """Declares a custom op's inputs, outputs, shapes and types, and makes
    its operator."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        """Default: every output shaped like input 0, no aux states (a
        prop with aux states overrides this)."""
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), \
            [in_type[0]] * len(self.list_auxiliary_states())

    def list_outputs(self):
        return ['output']

    def list_arguments(self):
        return ['data']

    def list_auxiliary_states(self):
        return []

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError()


def register(reg_name):
    """Register a CustomOpProp class as ``op_type=reg_name``."""
    def do_register(prop_cls):
        _CUSTOM_OPS[reg_name] = prop_cls
        return prop_cls
    return do_register


def get_all_registered_operators():
    return list(_CUSTOM_OPS)


def _split_aux(prop, arrays):
    """Aux states come after the arguments; split them off when the caller
    passed them all (the caller owns them and sees their updates)."""
    n_aux = len(prop.list_auxiliary_states())
    n_args = len(prop.list_arguments())
    if n_aux and len(arrays) == n_args + n_aux:
        return list(arrays[:n_args]), list(arrays[n_args:])
    return list(arrays), None


def _infer_and_alloc(prop, inputs, aux_nd):
    """Shape and type inference, and fresh aux buffers where the caller
    passed none. Returns (out_shapes, out_types, aux, in_types, shapes)."""
    shapes = [list(a.shape) for a in inputs]
    _, out_shapes, aux_shapes = prop.infer_shape(shapes)
    in_types = [a.dtype for a in inputs]
    _, out_types, aux_types = prop.infer_type(in_types)
    if aux_nd is None:
        aux_nd = [zeros(tuple(s), dtype=t)
                  for s, t in zip(aux_shapes or [], aux_types or [])]
    return out_shapes, out_types, aux_nd, in_types, shapes


def _outputs(out_nd):
    if len(out_nd) == 1:
        return out_nd[0]._data
    return tuple(o._data for o in out_nd)


def invoke_custom(op, inputs, out_shapes, out_dtypes=None, aux=None):
    """Run a CustomOp eagerly on NDArrays. While recording, with an input
    in a recorded graph, it is one node of the graph whose backward calls
    ``op.backward``. ``is_train`` is the training flag, not the recording
    flag."""
    from . import autograd as _ag
    if out_dtypes is None:
        out_dtypes = ['float32'] * len(out_shapes)
    aux = [] if aux is None else aux
    is_train = _ag.is_training()
    ctx = inputs[0].context if inputs else None
    n_out = len(out_shapes)

    def fwd(*tensors):
        ins = [NDArray(t) for t in tensors]
        out_nd = [zeros(tuple(s), dtype=t)
                  for s, t in zip(out_shapes, out_dtypes)]
        op.forward(is_train=is_train, req=['write'] * n_out, in_data=ins,
                   out_data=out_nd, aux=aux)
        return _outputs(out_nd)

    def bwd(gouts, ins, outs):
        ins = [NDArray(t) for t in ins]
        in_grads = [zeros(i.shape, dtype=i.dtype) for i in ins]
        op.backward(req=['write'] * len(ins),
                    out_grad=[NDArray(g) for g in gouts], in_data=ins,
                    out_data=[NDArray(o) for o in outs], in_grad=in_grads,
                    aux=aux)
        return [g._data for g in in_grads]

    tensors = [i._data for i in inputs]
    recording = _ag.is_recording() and any(t.requires_grad for t in tensors)
    if recording:
        outs = _reg.bridge_apply(fwd, bwd, tensors)
    else:
        outs = _reg.bridge_apply(fwd, None, [t.detach() for t in tensors])
    outs = (outs,) if n_out == 1 else tuple(outs)
    res = [NDArray(o, ctx) for o in outs]
    return res[0] if n_out == 1 else res


def custom_eager(*args, **kwargs):
    """``nd.Custom``: the prop made from the keywords, the operator run
    eagerly. Trailing positional NDArrays beyond the prop's arguments are
    its aux states, updated in place."""
    op_type = kwargs.pop('op_type')
    kwargs.pop('name', None)
    arrays = [a for a in args if isinstance(a, NDArray)]
    prop = _CUSTOM_OPS[op_type](**kwargs)
    inputs, aux_nd = _split_aux(prop, arrays)
    with _reg.host_scope([a._data for a in inputs]):
        out_shapes, out_types, aux_nd, in_types, shapes = \
            _infer_and_alloc(prop, inputs, aux_nd)
    op = prop.create_operator(None, [tuple(s) for s in shapes], in_types)
    return invoke_custom(op, inputs, out_shapes, out_dtypes=out_types,
                         aux=aux_nd)


def _make_prop(attrs):
    prop_kwargs = {k: v for k, v in attrs.items()
                   if k not in _CUSTOM_RESERVED}
    return _CUSTOM_OPS[attrs['op_type']](**prop_kwargs)


def _custom_shape(attrs, in_shapes):
    """shape_fn: the prop's infer_shape over the argument shapes (aux
    inputs split off). The output types are None, input 0's (the
    CustomOpProp.infer_type default)."""
    prop = _make_prop(attrs)
    shapes, _ = _split_aux(prop, list(in_shapes))
    _, out_shapes, _ = prop.infer_shape([list(s) for s in shapes])
    return [tuple(s) for s in out_shapes], [None] * len(out_shapes)


def _node_operator(attrs, prop, shapes, in_types):
    """One CustomOp instance a graph node: the bridge passes the node's
    attrs dict to forward and backward, and the instance is kept on it."""
    op = attrs.get('__op_instance__')
    if op is None:
        op = prop.create_operator(None, [tuple(s) for s in shapes], in_types)
        attrs['__op_instance__'] = op
    return op


@_reg.register('Custom', variadic=True, key_var_num_args='num_args',
               host=True, shape_fn=_custom_shape, train_aware=True)
def _custom_fn(attrs, *tensors):
    """A Custom node's forward: the user's operator on NDArrays of its
    inputs, its outputs made in the current context (the node's, under
    the bridge)."""
    prop = _make_prop(attrs)
    inputs, aux_nd = _split_aux(prop, [NDArray(t) for t in tensors])
    out_shapes, out_types, aux_nd, in_types, shapes = \
        _infer_and_alloc(prop, inputs, aux_nd)
    out_nd = [zeros(tuple(s), dtype=t)
              for s, t in zip(out_shapes, out_types)]
    op = _node_operator(attrs, prop, shapes, in_types)
    op.forward(is_train=attrs.get('__is_train__', False),
               req=['write'] * len(out_nd), in_data=inputs, out_data=out_nd,
               aux=aux_nd)
    return _outputs(out_nd)


def _custom_backward(attrs, gouts, ins, outs):
    """A Custom node's backward: the user's operator's backward; aux
    inputs take zero gradients."""
    prop = _make_prop(attrs)
    inputs, aux_nd = _split_aux(prop, [NDArray(t) for t in ins])
    in_grad = [zeros(tuple(a.shape), dtype=a.dtype) for a in inputs]
    op = _node_operator(attrs, prop, [tuple(a.shape) for a in inputs],
                        [a.dtype for a in inputs])
    op.backward(req=['write'] * len(in_grad),
                out_grad=[NDArray(g) for g in gouts], in_data=inputs,
                out_data=[NDArray(o) for o in outs], in_grad=in_grad,
                aux=aux_nd or [])
    return [g._data for g in in_grad] + [None] * (len(ins) - len(in_grad))


_reg.get('Custom').legacy_backward = _custom_backward


# -- the legacy Python operators (MXNet's operator.py PythonOp, NumpyOp,
#    NDArrayOp): get_symbol builds a `_Native` / `_NDArray` symbol whose
#    `info` attr names the live instance --------------------------------------

class PythonOp:
    """Base class of the legacy Python operators."""

    _op_name = '_Native'

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def __call__(self, *args, **kwargs):
        return self.get_symbol(*args, **kwargs)

    def get_symbol(self, *args, **kwargs):
        from .ops.legacy_ops import register_legacy_callback
        from .symbol import _internal
        # the callback table holds the only, permanent, reference
        kwargs['info'] = register_legacy_callback(self)
        return getattr(_internal, self._op_name)(*args, **kwargs)

    def forward(self, in_data, out_data):
        out_data[0][:] = in_data[0]

    def backward(self, out_grad, in_data, out_data, in_grad):
        in_grad[0][:] = 1.0

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]]

    def list_outputs(self):
        return ['output']

    def list_arguments(self):
        return ['data']

    def need_top_grad(self):
        return self.need_top_grad_


class NumpyOp(PythonOp):
    """A legacy operator on host numpy buffers."""
    _op_name = '_Native'


class NDArrayOp(PythonOp):
    """A legacy operator on NDArrays."""
    _op_name = '_NDArray'

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps
