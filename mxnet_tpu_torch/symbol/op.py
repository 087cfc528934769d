"""sym.op: the generated symbolic-operator module path (the counterpart
of ``mxnet_tpu/symbol/op.py``). Any registered op resolves lazily."""
from ..ops.registry import lazy_op_module
from .register import make_sym_function

__getattr__, __dir__ = lazy_op_module(globals(), make_sym_function)
