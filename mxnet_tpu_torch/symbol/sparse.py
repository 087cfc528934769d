"""sym.sparse: the symbolic sparse names, the counterpart of
``mxnet_tpu/symbol/sparse.py``. In a graph the storage types are
annotations over dense tensors (:mod:`..ops.sparse_ops`)."""
from . import register as _register

__all__ = ['cast_storage', 'retain', 'dot', 'square_sum', 'zeros_like']

cast_storage = _register.make_sym_function('cast_storage')
retain = _register.make_sym_function('_sparse_retain')
dot = _register.make_sym_function('dot')
square_sum = _register.make_sym_function('_square_sum')
zeros_like = _register.make_sym_function('zeros_like')
