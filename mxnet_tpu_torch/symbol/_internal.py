"""sym._internal: the underscore-named op composers, generated on first
use, as in ``mxnet_tpu/symbol/_internal.py``."""
from ..ops.registry import lazy_op_module
from .register import make_sym_function

__getattr__, __dir__ = lazy_op_module(globals(), make_sym_function,
                                      underscore_only=True)
