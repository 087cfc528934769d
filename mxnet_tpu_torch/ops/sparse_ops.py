"""The registry (graph) forms of the sparse ops: the counterpart of
``mxnet_tpu/ops/sparse_ops.py``.

Inside a graph every operand is a dense tensor; the sparse containers
live at the NDArray layer (:mod:`..ndarray.sparse`). ``cast_storage`` is a
storage annotation (the identity), ``_sparse_retain`` (alias
``sparse_retain``) zeroes every row not listed in ``indices``, the dense
image of the sparse result, and ``_square_sum`` is the sum of squares
along ``axis``.
"""
import torch

from .registry import register, register_alias


@register('cast_storage', param_defaults={'stype': 'default'})
def _cast_storage(attrs, x):
    """The identity: the eager ``nd.cast_storage`` converts containers."""
    return x


@register('_sparse_retain', input_names=['data', 'indices'])
def _sparse_retain_op(attrs, data, indices):
    """out[i] = data[i] if i is in ``indices`` else 0. A negative index
    counts from the end; one still out of range is dropped. Differentiable: the gradient is the same row mask
    applied to the output's gradient."""
    n = data.shape[0]
    idx = indices.long()
    idx = torch.where(idx < 0, idx + n, idx)     # a negative index wraps once
    idx = idx[(idx >= 0) & (idx < n)]
    keep = torch.zeros((data.shape[0],), dtype=torch.bool, device=data.device)
    keep[idx] = True
    return torch.where(keep.reshape((-1,) + (1,) * (data.dim() - 1)),
                       data, torch.zeros_like(data))


register_alias('sparse_retain', '_sparse_retain')


@register('_square_sum', param_defaults={'axis': None, 'keepdims': False})
def _square_sum_op(attrs, x):
    """The sum of x**2 along ``axis`` (all axes by default)."""
    ax = attrs.get('axis', None)
    if isinstance(ax, (tuple, list)):
        ax = tuple(int(a) for a in ax)
        ax = ax if ax else None
    elif ax is not None:
        ax = int(ax)
    keep = bool(attrs.get('keepdims', False))
    sq = torch.square(x)
    if ax is None:
        out = sq.sum()
        return out.reshape((1,) * x.dim()) if keep else out
    return sq.sum(dim=ax, keepdim=keep)
