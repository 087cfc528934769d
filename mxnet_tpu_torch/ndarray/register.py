"""Generation of the nd.* operator namespace from the registry: the
counterpart of ``mxnet_tpu/ndarray/register.py``, without its sparse
routes (sparse storage is not ported).
"""
from ..context import Context as _Ctx
from ..ops import registry as _reg
from .ndarray import NDArray, invoke

__all__ = ['make_nd_function', 'install_ops']


def make_nd_function(op_name):
    """A function ``fn(*args, out=None, name=None, **kwargs)`` for op
    ``op_name``: NDArray arguments fill the op's ``input_names`` in order
    (or by keyword), scalar positional arguments its ``param_defaults`` in
    order, and the remaining keywords are its attrs. A variadic op takes
    every positional NDArray and gets their count in its
    ``key_var_num_args`` attr."""
    op = _reg.get(op_name)

    def fn(*args, **kwargs):
        out = kwargs.pop('out', None)
        kwargs.pop('name', None)
        pos_inputs = [a for a in args if isinstance(a, NDArray)]
        # scalar positional args map onto declared params in order; a
        # positional None is an omitted optional input, and a positional
        # Context is the ctx kwarg
        pos_attrs = []
        for a in args:
            if isinstance(a, (NDArray, type(None))):
                continue
            if isinstance(a, _Ctx):
                kwargs.setdefault('ctx', a)
            else:
                pos_attrs.append(a)
        if pos_attrs:
            for pname in op.param_defaults:
                if not pos_attrs:
                    break
                if pname not in kwargs:
                    kwargs[pname] = pos_attrs.pop(0)
        if op.variadic:
            if op.key_var_num_args and op.key_var_num_args not in kwargs:
                kwargs[op.key_var_num_args] = len(pos_inputs)
            return invoke(op_name, pos_inputs, kwargs, out)
        named = {}
        for k in list(kwargs):
            if k in op.input_names and isinstance(kwargs[k], NDArray):
                named[k] = kwargs.pop(k)
        inputs = []
        pos_iter = iter(pos_inputs)
        for name in op.input_names:
            if name in named:
                inputs.append(named[name])
            else:
                nxt = next(pos_iter, None)
                if nxt is None:
                    break
                inputs.append(nxt)
        return invoke(op_name, inputs, kwargs, out)

    fn.__name__ = op_name
    fn.__doc__ = op.doc
    return fn


def install_ops(namespace):
    """Install one generated function per registered op into ``namespace``."""
    for name in _reg.list_ops():
        namespace[name] = make_nd_function(name)
    return namespace
