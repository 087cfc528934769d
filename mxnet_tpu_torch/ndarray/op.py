"""nd.op — the generated-operator module path (the counterpart of
``mxnet_tpu/ndarray/op.py``). Any registered op resolves lazily."""
from ..ops.registry import lazy_op_module
from .register import make_nd_function

__getattr__, __dir__ = lazy_op_module(globals(), make_nd_function)
