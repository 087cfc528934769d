"""nd.linalg: the ``linalg_*`` ops under their short names, as in
``mxnet_tpu/ndarray/linalg.py``."""
from . import register as _register

__all__ = ['gemm', 'gemm2', 'potrf', 'potri', 'trmm', 'trsm', 'syrk',
           'gelqf', 'sumlogdiag']

for _name in __all__:
    globals()[_name] = _register.make_nd_function('linalg_' + _name)
del _name
