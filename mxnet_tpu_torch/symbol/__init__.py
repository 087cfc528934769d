"""mx.sym: the symbolic namespace, the counterpart of
``mxnet_tpu/symbol/__init__.py``: Symbol, Variable, Group, load_json, one
composer per registered op (``sym.Convolution``, ``sym.BatchNorm``, ...),
generated from the registry as ``nd.<op>`` is, ``zeros``/``ones``/
``arange``/``full``, ``maximum``/``minimum``/``hypot``, ``sym.random``,
``sym.contrib``, ``sym.linalg``, ``sym.sparse`` and ``sym._internal``.
"""
from .symbol import Symbol, Variable, var, Group, load, load_json, create
from . import register as _register

_register.install_ops(globals())


def zeros(shape, dtype='float32', **kwargs):
    return _register.make_sym_function('_zeros')(
        shape=tuple(shape) if not isinstance(shape, int) else (shape,),
        dtype=dtype, **kwargs)


def ones(shape, dtype='float32', **kwargs):
    return _register.make_sym_function('_ones')(
        shape=tuple(shape) if not isinstance(shape, int) else (shape,),
        dtype=dtype, **kwargs)


def arange(start, stop=None, step=1.0, repeat=1, dtype='float32', **kwargs):
    return _register.make_sym_function('_arange')(
        start=start, stop=stop, step=step, repeat=repeat, dtype=dtype,
        **kwargs)


def full(shape, val, dtype='float32', **kwargs):
    """A Symbol filled with ``val``."""
    z = zeros(shape, dtype=dtype, **kwargs)
    return _register.make_sym_function('_plus_scalar')(z, scalar=float(val))


def _sym_or_scalar_binary(lhs, rhs, sym_op, lscalar_op, rscalar_op):
    if isinstance(lhs, Symbol) and isinstance(rhs, Symbol):
        return _register.make_sym_function(sym_op)(lhs, rhs)
    if isinstance(lhs, Symbol):
        return _register.make_sym_function(rscalar_op)(lhs, scalar=float(rhs))
    if isinstance(rhs, Symbol):
        return _register.make_sym_function(lscalar_op)(rhs, scalar=float(lhs))
    raise TypeError('at least one argument must be a Symbol')


def maximum(lhs, rhs):
    return _sym_or_scalar_binary(lhs, rhs, '_maximum',
                                 '_maximum_scalar', '_maximum_scalar')


def minimum(lhs, rhs):
    return _sym_or_scalar_binary(lhs, rhs, '_minimum',
                                 '_minimum_scalar', '_minimum_scalar')


def hypot(lhs, rhs):
    """sqrt(lhs^2 + rhs^2) elementwise."""
    return _sym_or_scalar_binary(lhs, rhs, '_hypot',
                                 '_hypot_scalar', '_hypot_scalar')


from . import random    # noqa: E402,F401  (mx.sym.random.*)
from . import contrib   # noqa: E402,F401  (mx.sym.contrib.*)
from . import linalg    # noqa: E402,F401  (mx.sym.linalg.*)
from . import sparse    # noqa: E402,F401  (mx.sym.sparse.*)
from . import _internal  # noqa: E402,F401  (mx.sym._internal.*)
from . import op        # noqa: E402,F401  (generated-op module path)


def __getattr__(name):
    """Late binding for ops registered after import."""
    from ..ops import registry as _late_reg
    if _late_reg.exists(name):
        fn = _register.make_sym_function(name)
        globals()[name] = fn
        return fn
    raise AttributeError('module %r has no attribute %r' % (__name__, name))
