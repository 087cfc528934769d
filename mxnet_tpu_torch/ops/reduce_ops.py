"""Reduction and broadcast-axis ops: the counterpart of
``mxnet_tpu/ops/reduce_ops.py``, registered under the same names.

Plain torch ops, with the results jnp gives with 64-bit types off:

- a full reduction returns shape ``(1,)``, not a 0-d tensor;
- integer ``sum``/``prod``/``nansum``/``nanprod`` stay in x's dtype (torch
  widens them to int64), and an integer ``mean`` is float32 (torch raises);
- ``argmax``/``argmin``/``argmax_channel`` return float32 indices;
- ``axis=()`` (everything excluded) reduces nothing, where torch's
  ``dim=()`` would reduce every axis.
"""
import torch

from .registry import register, register_alias


def _axis(attrs):
    ax = attrs.get('axis', None)
    if ax is None or ax == ():
        return None
    if isinstance(ax, (list, tuple)):
        return tuple(ax) if len(ax) else None
    return int(ax)


def _scalar1(out):
    """Full reductions yield a (1,) array, not 0-d
    (broadcast_reduce_op.h:148 Shape1(1)); scripts index reduce(x)[0]."""
    return out.reshape(1) if out.dim() == 0 else out


def _int_kept(f):
    """``f`` with an integer result in x's dtype, as jnp keeps int32."""
    def g(x, dim, keepdim):
        out = f(x, dim, keepdim)
        return out if x.is_floating_point() else out.to(x.dtype)
    return g


def _mean(x, dim, keepdim):
    if x.is_floating_point():
        # f32 inside for the half types, as jnp.mean upcasts them
        return torch.mean(x.float(), dim, keepdim).to(x.dtype)
    return torch.mean(x.float(), dim, keepdim)


def _prod(x, dim, keepdim):
    # torch.prod takes one dim: reduce the axes one by one, last first
    if isinstance(dim, int):
        return torch.prod(x, dim, keepdim)
    for d in sorted((d % x.dim() for d in dim), reverse=True):
        x = torch.prod(x, d, keepdim)
    return x


def _nan_to_one(x):
    if x.is_floating_point():
        return x.masked_fill(torch.isnan(x), 1)
    return x


def _nansum(x, dim, keepdim):
    # a sum with NaNs as 0, as jnp.nansum has it (torch.nansum accumulates
    # bf16 in bf16 on the CPU)
    if x.is_floating_point():
        x = x.masked_fill(torch.isnan(x), 0)
    return torch.sum(x, dim, keepdim)


_REDUCERS = {
    'sum': _int_kept(torch.sum),
    'mean': _mean,
    'prod': _int_kept(_prod),
    'nansum': _int_kept(_nansum),
    'nanprod': _int_kept(lambda x, d, k: _prod(_nan_to_one(x), d, k)),
    'max': torch.amax,
    'min': torch.amin,
}


def _reduce(f, x, ax, keepdims):
    """``f(x, dims, keepdim)`` over ``ax`` (None: every axis; (): none)."""
    if ax == ():
        return f(x.unsqueeze(0), 0, False)
    if ax is None:
        ax = tuple(range(x.dim()))
        if not ax:                     # a 0-d x: reduce a unit axis
            return f(x.unsqueeze(0), 0, False)
    return f(x, ax, keepdims)


def _r(name, aliases=()):
    f = _REDUCERS[name]

    @register(name, param_defaults={'axis': None, 'keepdims': False,
                                    'exclude': False})
    def op(attrs, x, _f=f):
        ax = _axis(attrs)
        if attrs.get('exclude', False) and ax is not None:
            axes = (ax,) if isinstance(ax, int) else ax
            ax = tuple(i for i in range(x.dim()) if i not in
                       tuple(a % x.dim() for a in axes))
        return _scalar1(_reduce(_f, x, ax, bool(attrs.get('keepdims', False))))
    for a in aliases:
        register_alias(a, name)
    return op


_r('sum', aliases=('sum_axis',))
_r('mean')
_r('prod')
_r('nansum')
_r('nanprod')
_r('max', aliases=('max_axis',))
_r('min', aliases=('min_axis',))


@register('norm', param_defaults={'axis': None, 'keepdims': False, 'ord': 2})
def _norm(attrs, x):
    ax = _axis(attrs)
    keep = bool(attrs.get('keepdims', False))
    sum_ = _REDUCERS['sum']
    if attrs.get('ord', 2) == 1:
        out = _reduce(sum_, torch.abs(x), ax, keep)
    else:
        out = _reduce(sum_, torch.square(x), ax, keep)
        out = torch.sqrt(out if out.is_floating_point() else out.float())
    return _scalar1(out)


def _arg(name, f):
    @register(name, param_defaults={'axis': None, 'keepdims': False})
    def op(attrs, x, _f=f):
        ax = attrs.get('axis', None)
        keep = attrs.get('keepdims', False)
        if ax is None:
            res = _f(x.reshape(-1), 0)
            if keep:
                res = res.reshape((1,) * x.dim())
            # ReduceAxisShapeImpl: global argmax/argmin is Shape1(1)
            return _scalar1(res.to(torch.float32))
        res = _f(x, int(ax), keep)
        return _scalar1(res.to(torch.float32))
    return op


_arg('argmax', torch.argmax)
_arg('argmin', torch.argmin)


@register('argmax_channel')
def _argmax_channel(attrs, x):
    return torch.argmax(x, 1).to(torch.float32)


@register('broadcast_axis', param_defaults={'axis': (), 'size': ()})
def _broadcast_axis(attrs, x):
    axes = attrs.get('axis', ())
    sizes = attrs.get('size', ())
    if isinstance(axes, int):
        axes, sizes = (axes,), (sizes,)
    shape = list(x.shape)
    for a, s in zip(axes, sizes):
        shape[a] = s
    return x.expand(tuple(shape))


register_alias('broadcast_axes', 'broadcast_axis')


@register('broadcast_to', param_defaults={'shape': ()})
def _broadcast_to(attrs, x):
    tgt = list(attrs['shape'])
    for i, s in enumerate(tgt):
        if s == 0:
            tgt[i] = x.shape[i]
    return x.expand(tuple(tgt))


@register('broadcast_like', input_names=['lhs', 'rhs'])
def _broadcast_like(attrs, lhs, rhs):
    return lhs.expand(rhs.shape)
