"""sym.contrib: every registered ``_contrib_*`` operator without its
prefix (``sym.contrib.CTCLoss``), the counterpart of
``mxnet_tpu/symbol/contrib.py``."""
from ..ops import registry as _reg
from .register import make_sym_function as _make

for _name in _reg.list_ops():
    if _name.startswith('_contrib_'):
        globals()[_name[len('_contrib_'):]] = _make(_name)
del _name
