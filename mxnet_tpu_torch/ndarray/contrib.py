"""nd.contrib: every registered ``_contrib_*`` operator without its
prefix (``nd.contrib.CTCLoss``), the counterpart of
``mxnet_tpu/ndarray/contrib.py``."""
from ..ops import registry as _reg
from .register import make_nd_function as _make

for _name in _reg.list_ops():
    if _name.startswith('_contrib_'):
        globals()[_name[len('_contrib_'):]] = _make(_name)
del _name
