"""Generation of the sym.* operator namespace from the registry: the
counterpart of ``mxnet_tpu/symbol/register.py``, composers where
``nd.<op>`` has imperative calls."""
from ..ops import registry as _reg
from .symbol import Symbol, _invoke_sym

__all__ = ['make_sym_function', 'install_ops']


def make_sym_function(op_name):
    op = _reg.get(op_name)

    def fn(*args, **kwargs):
        inputs = [a for a in args if isinstance(a, Symbol)]
        # positional scalars map onto declared params in order, as in
        # make_nd_function
        pos_attrs = [a for a in args
                     if not isinstance(a, Symbol) and a is not None]
        if pos_attrs:
            for pname in op.param_defaults:
                if not pos_attrs:
                    break
                if pname not in kwargs:
                    kwargs[pname] = pos_attrs.pop(0)
        return _invoke_sym(op_name, inputs, kwargs)

    fn.__name__ = op_name
    fn.__doc__ = op.doc
    return fn


def install_ops(namespace):
    for name in _reg.list_ops():
        if name.startswith('_slice_like'):
            continue
        namespace[name] = make_sym_function(name)
    return namespace
