"""nd — the imperative tensor namespace: the counterpart of
``mxnet_tpu/ndarray/__init__.py``.

NDArray and its constructors, ``waitall``, ``concatenate``, ``moveaxis``,
``maximum`` and ``minimum``, ``save`` and ``load`` (:mod:`.utils`), and
one generated function per registered op (``nd.LayerNorm``,
``nd.softmax``, ``nd.broadcast_add``, ``nd.sum``, ``nd.add_n``,
``nd.stack``, ``nd.sgd_mom_update``, ``nd.Convolution``, ...), called
as in the JAX package, ``nd.random``, ``nd.contrib``, ``nd.linalg``,
``nd._internal``, ``nd.Custom`` (:mod:`..operator`), and sparse storage:
``nd.sparse``, ``nd.csr_matrix``, ``nd.row_sparse_array`` and the eager
``nd.cast_storage`` and ``nd.sparse_retain`` (:mod:`.sparse`).
"""
from .ndarray import (NDArray, array, zeros, ones, empty, full, arange,
                      invoke, waitall, concatenate, stack, moveaxis, from_torch)
from . import register as _register
from .utils import save, load
from . import op  # noqa: F401  (generated-op module path)
from . import random  # noqa: F401  (nd.random samplers)
from . import contrib  # noqa: F401  (nd.contrib: the _contrib_* ops)
from . import linalg  # noqa: F401  (nd.linalg: the linalg_* ops)
from . import _internal  # noqa: F401  (nd._internal: the _* ops)
from . import sparse  # noqa: F401  (nd.sparse: csr and row_sparse)
from .sparse import csr_matrix, row_sparse_array

_register.install_ops(globals())


def cast_storage(data, stype='default'):
    """The container conversion, eagerly (the registry's ``cast_storage``
    is the graph's identity)."""
    return sparse.cast_storage(data, stype)


def sparse_retain(data, indices):
    """row_sparse in, row_sparse out; a dense input goes through the
    registry op (rows outside ``indices`` become zero)."""
    if isinstance(data, sparse.BaseSparseNDArray):
        return sparse.retain(data, indices)
    return invoke('_sparse_retain', [data, indices], {})


def maximum(lhs, rhs):
    """The elementwise maximum of an NDArray and an NDArray or a number."""
    if isinstance(rhs, NDArray):
        return invoke('broadcast_maximum', [lhs, rhs], {})
    return invoke('_maximum_scalar', [lhs], {'scalar': float(rhs)})


def minimum(lhs, rhs):
    """The elementwise minimum of an NDArray and an NDArray or a number."""
    if isinstance(rhs, NDArray):
        return invoke('broadcast_minimum', [lhs, rhs], {})
    return invoke('_minimum_scalar', [lhs], {'scalar': float(rhs)})


def Custom(*args, **kwargs):
    """A custom Python operator run eagerly (``op_type`` names its
    registered CustomOpProp); the registry's ``Custom`` is its graph
    form."""
    from ..operator import custom_eager
    return custom_eager(*args, **kwargs)


def __getattr__(name):
    """Late binding for ops registered after import."""
    from ..ops import registry as _late_reg
    if _late_reg.exists(name):
        fn = _register.make_nd_function(name)
        globals()[name] = fn
        return fn
    raise AttributeError('module %r has no attribute %r' % (__name__, name))
