"""nd._internal: the underscore-named ops, generated on first use, as in
``mxnet_tpu/ndarray/_internal.py``."""
from ..ops.registry import lazy_op_module
from .register import make_nd_function

__getattr__, __dir__ = lazy_op_module(globals(), make_nd_function,
                                      underscore_only=True)
