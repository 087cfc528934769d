"""Shared plumbing of the port: the error type, dtype tables and attr
normalisation. The counterpart of ``mxnet_tpu/base.py``, holding only what
the operator registry and NDArray use, the reference's
``string_types``, ``numeric_types`` and ``build_param_doc``, and
``NotSupportedForSparseNDArray``.

Dtypes are named as the JAX package names them: ``np_dtype`` gives a numpy
dtype (bfloat16 as ``ml_dtypes.bfloat16``), and ``torch_dtype`` the torch
dtype a tensor of it is stored in. The JAX package's ``MXTPU_F16_AS_BF16``
(float16 requests resolved to bfloat16, for the TPU) is not ported: the card
has float16.
"""
import ml_dtypes
import numpy as np
import torch

__all__ = ['MXNetError', 'NotSupportedForSparseNDArray', 'np_dtype',
           'torch_dtype', 'dtype_of', 'normalize_attrs', 'string_types',
           'numeric_types', 'build_param_doc']

string_types = (str,)
numeric_types = (float, int, np.generic)


class MXNetError(Exception):
    """Error raised by the framework (reference: base.py MXNetError)."""


class NotSupportedForSparseNDArray(MXNetError):
    """An op that is not available for sparse storage types."""

    def __init__(self, function, alias, *args):
        super().__init__()
        self.function = function.__name__
        self.alias = alias
        self.args = [str(type(a)) for a in args]

    def __str__(self):
        msg = 'Function %s' % self.function
        if self.alias:
            msg += ' (namely operator "%s")' % self.alias
        if self.args:
            msg += ' with arguments (%s)' % ', '.join(self.args)
        return msg + ' is not supported for SparseNDArray and only ' \
                     'available in NDArray.'


_TORCH_OF = {
    np.dtype('float32'): torch.float32,
    np.dtype('float64'): torch.float64,
    np.dtype('float16'): torch.float16,
    np.dtype(ml_dtypes.bfloat16): torch.bfloat16,
    np.dtype('uint8'): torch.uint8,
    np.dtype('int8'): torch.int8,
    np.dtype('int32'): torch.int32,
    np.dtype('int64'): torch.int64,
    np.dtype('bool'): torch.bool,
}
_NP_OF = {t: d for d, t in _TORCH_OF.items()}


def np_dtype(dtype):
    """Any dtype spec (a name such as 'bfloat16', a numpy dtype or type, a
    torch dtype, None for float32) as a numpy dtype."""
    if dtype is None:
        return np.dtype('float32')
    if isinstance(dtype, torch.dtype):
        return dtype_of(dtype)
    if isinstance(dtype, str) and dtype == 'bfloat16':
        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(dtype)


def torch_dtype(dtype):
    """The torch dtype of a dtype spec (see :func:`np_dtype`)."""
    d = np_dtype(dtype)
    if d not in _TORCH_OF:
        raise TypeError('dtype %s has no torch counterpart in the port' % d)
    return _TORCH_OF[d]


def dtype_of(tdtype):
    """The numpy dtype of a torch dtype."""
    if tdtype not in _NP_OF:
        raise TypeError('torch dtype %s has no numpy counterpart in the port'
                        % tdtype)
    return _NP_OF[tdtype]


def normalize_attrs(attrs):
    """Make an attr dict hashable & canonical (lists/shapes -> tuples)."""
    out = {}
    for k, v in attrs.items():
        if isinstance(v, (list, tuple)):
            out[k] = tuple(normalize_value(x) for x in v)
        else:
            out[k] = normalize_value(v)
    return out


def normalize_value(v):
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, (list, tuple)):
        return tuple(normalize_value(x) for x in v)
    return v


def build_param_doc(arg_names, arg_types, arg_descs, remove_dup=True):
    """An operator's 'Parameters' docstring block (the reference's
    base.py)."""
    param_keys = set()
    param_str = []
    for key, type_info, desc in zip(arg_names, arg_types, arg_descs):
        if key in param_keys and remove_dup:
            continue
        if key == 'num_args':
            continue
        param_keys.add(key)
        ret = '%s : %s' % (key, type_info)
        if len(desc) != 0:
            ret += '\n    ' + desc
        param_str.append(ret)
    return 'Parameters\n----------\n%s\n' % str.join('\n', param_str)
