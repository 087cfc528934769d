"""Shape-manipulation, indexing, init and control-flow ops: the counterpart
of ``mxnet_tpu/ops/shape_ops.py``, registered under the same names, aliases,
input names and parameter defaults.

The JAX package leaves these to XLA; here they are plain torch ops with
jnp's rules where torch's differ:

- a slice may step backwards (torch takes no negative step: the axis is
  reversed and the step made positive, :func:`flip_steps`);
- a gather (``take`` in ``clip`` mode, ``Embedding``, ``batch_take``,
  ``gather_nd``) never faults: ``take`` and ``Embedding`` clamp an index
  into [0, n), the others wrap a negative index once and then clamp, as
  jnp's indexing does; ``pick`` fills an index still out of range with NaN
  (the least integer for an integer x), as ``jnp.take_along_axis`` does;
  ``scatter_nd`` drops such an index, as ``.at[].add`` does;
- ``Pad``'s ``edge`` and ``reflect`` modes take any rank (numpy's modes,
  built from index arrays), where torch's pad takes 3-5-D input only;
- the ops without inputs (``_zeros``, ``_ones``, ``_arange``) build on the
  CPU and ``invoke`` places the result in the requested context.
"""
import numpy as np
import torch
import torch.nn.functional as F

from ..base import np_dtype, torch_dtype
from .registry import register, register_alias

__all__ = ['infer_reshape', 'flip_steps', 'along_axis']


def infer_reshape(src, target):
    """The output shape of MXNet's Reshape, with its special codes: 0 copies
    a dim, -1 infers one, -2 copies the rest, -3 merges two, -4 splits one
    in two (matrix_op-inl.h InferReshapeShape)."""
    out = []
    src_idx = 0
    i = 0
    while i < len(target):
        t = target[i]
        if t == 0:
            out.append(src[src_idx]); src_idx += 1
        elif t == -1:
            out.append(-1); src_idx += 1
        elif t == -2:
            out.extend(src[src_idx:]); src_idx = len(src)
        elif t == -3:
            out.append(src[src_idx] * src[src_idx + 1]); src_idx += 2
        elif t == -4:
            a, b = target[i + 1], target[i + 2]
            cur = src[src_idx]
            if a == -1:
                a = cur // b
            if b == -1:
                b = cur // a
            out.extend([a, b]); src_idx += 1; i += 2
        else:
            out.append(t); src_idx += 1
        i += 1
    if -1 in out:
        known = int(np.prod([d for d in out if d != -1])) or 1
        total = int(np.prod(src)) if src else 1
        out[out.index(-1)] = total // known
    return out


def flip_steps(data, items, axes):
    """Torch takes no negative step: each slice ``items[i]`` with one (over
    axis ``axes[i]``) becomes a positive one over its axis reversed, which
    picks the same elements in the same order. Rewrites ``items`` and
    returns ``data`` with those axes reversed (a copy), or as it is."""
    for i, ax in axes.items():
        n = data.shape[ax]
        r = range(n)[items[i]]
        items[i] = slice(n - 1 - r[0], n - r[-1], -r.step) if r else slice(0, 0)
    return data.flip(tuple(axes.values())) if axes else data


def _index_int(indices):
    """Indices as jnp's ``astype(int32)`` makes them (a float truncated
    toward zero), in the int64 torch indexes with."""
    return indices.to(torch.int32).long()


def along_axis(data, index, axis):
    """``(data, index)`` as ``jnp.take_along_axis(data, expand_dims(index,
    axis), axis)`` takes them: ``index`` (one axis fewer than ``data``) gets
    ``axis`` back at size 1, and the two broadcast against each other over
    every other axis (a (1,) index serves every row). ValueError where jnp
    raises: a rank that does not match, shapes that do not broadcast."""
    if index.dim() + 1 != data.dim():
        raise ValueError('indices and arr must have the same number of '
                         'dimensions; %d vs. %d' % (index.dim() + 1, data.dim()))
    idx = index.unsqueeze(axis)
    dshape = list(data.shape)
    dshape[axis] = 1
    try:
        shape = list(torch.broadcast_shapes(tuple(dshape), tuple(idx.shape)))
    except RuntimeError:
        raise ValueError('Incompatible shapes for broadcasting: shapes=[%s, '
                         '%s]' % (tuple(idx.shape), tuple(dshape))) from None
    idx = idx.expand(shape)
    shape[axis] = data.shape[axis]
    return data.expand(shape), idx


def _clamped(idx, n):
    """jnp's gather rule: a negative index counts from the end once, and one
    still out of range is clamped into [0, n)."""
    return torch.where(idx < 0, idx + n, idx).clamp(0, max(n - 1, 0))


def _dtype(attrs):
    """The torch dtype of an op's ``dtype`` attr (float32 by default)."""
    return torch_dtype(attrs.get('dtype', 'float32'))


@register('Reshape', param_defaults={'shape': (), 'reverse': False,
                                     'target_shape': (), 'keep_highest': False})
def _reshape(attrs, x):
    """MXNet's Reshape with its special codes, ``reverse`` (the codes match
    the trailing dims first), and the legacy ``target_shape`` /
    ``keep_highest`` (0 is the one inferred dim; keep_highest pins dim 0
    to the input's)."""
    target = list(attrs.get('shape') or ())
    legacy = list(attrs.get('target_shape') or ())
    if not target and legacy:
        out = list(legacy)
        keep = attrs.get('keep_highest', False)
        if keep:
            out[0] = x.shape[0]
        inferred = [i for i in range(1 if keep else 0, len(out)) if out[i] == 0]
        if len(inferred) == 1:
            out[inferred[0]] = -1
        return x.reshape(tuple(out))
    if attrs.get('reverse', False):
        out = infer_reshape(list(x.shape)[::-1], target[::-1])[::-1]
    else:
        out = infer_reshape(list(x.shape), target)
    return x.reshape(tuple(out))


register_alias('reshape', 'Reshape')


@register('reshape_like', input_names=['lhs', 'rhs'])
def _reshape_like(attrs, lhs, rhs):
    return lhs.reshape(rhs.shape)


@register('Flatten')
def _flatten(attrs, x):
    return x.reshape(x.shape[0], -1)


register_alias('flatten', 'Flatten')


@register('transpose', param_defaults={'axes': ()})
def _transpose(attrs, x):
    axes = attrs.get('axes', ())
    return x.permute(tuple(axes) if axes else tuple(range(x.dim() - 1, -1, -1)))


@register('expand_dims', param_defaults={'axis': 0})
def _expand_dims(attrs, x):
    return x.unsqueeze(int(attrs['axis']))


@register('squeeze', param_defaults={'axis': None})
def _squeeze(attrs, x):
    ax = attrs.get('axis', None)
    if ax is None:
        return x.squeeze()
    ax = (ax,) if isinstance(ax, int) else tuple(ax)
    for a in ax:
        if x.shape[a] != 1:
            raise ValueError('cannot squeeze axis %d of shape %s'
                             % (a, tuple(x.shape)))
    return x.squeeze(ax)


@register('SwapAxis', param_defaults={'dim1': 0, 'dim2': 0})
def _swapaxis(attrs, x):
    return x.transpose(int(attrs['dim1']), int(attrs['dim2']))


register_alias('swapaxes', 'SwapAxis')


def _slice_items(attrs, ndim):
    """(slices over the leading axes, {position: axis} of the ones that step
    backwards)."""
    begin, end = attrs['begin'], attrs['end']
    step = attrs.get('step', None) or (None,) * len(begin)
    items = [slice(b, e, s) for b, e, s in zip(begin, end, step)]
    items += [slice(None)] * (ndim - len(items))
    return items, {i: i for i, s in enumerate(items)
                   if s.step is not None and s.step < 0}


@register('slice', param_defaults={'begin': (), 'end': (), 'step': None})
def _slice(attrs, x):
    items, back = _slice_items(attrs, x.dim())
    return flip_steps(x, items, back)[tuple(items)]


register_alias('crop', 'slice')


def _assign(attrs, x, value):
    """A copy of ``x`` with ``value`` (cast to x's dtype) written at the
    slice of ``attrs``."""
    items, back = _slice_items(attrs, x.dim())
    new = flip_steps(x, items, back)
    if new is x:
        new = x.clone()
    new[tuple(items)] = value.to(x.dtype)
    return new.flip(tuple(back.values())) if back else new


@register('_slice_assign', input_names=['lhs', 'rhs'],
          param_defaults={'begin': (), 'end': (), 'step': None})
def _slice_assign(attrs, lhs, rhs):
    """The functional form of ``lhs[begin:end:step] = rhs``."""
    return _assign(attrs, lhs, rhs)


register_alias('_crop_assign', '_slice_assign')


@register('_slice_assign_scalar',
          param_defaults={'scalar': 0.0, 'begin': (), 'end': (), 'step': None})
def _slice_assign_scalar(attrs, x):
    """``x[begin:end:step] = scalar``."""
    return _assign(attrs, x, torch.tensor(attrs['scalar'], dtype=x.dtype))


register_alias('_crop_assign_scalar', '_slice_assign_scalar')


@register('slice_axis', param_defaults={'axis': 0, 'begin': 0, 'end': None})
def _slice_axis(attrs, x):
    ax = int(attrs['axis']) % x.dim()
    idx = [slice(None)] * x.dim()
    idx[ax] = slice(attrs['begin'], attrs['end'])
    return x[tuple(idx)]


@register('slice_like', input_names=['data', 'shape_like'],
          param_defaults={'axes': ()})
def _slice_like(attrs, x, like):
    axes = attrs.get('axes', ()) or tuple(range(x.dim()))
    idx = [slice(None)] * x.dim()
    for a in axes:
        idx[a] = slice(0, like.shape[a])
    return x[tuple(idx)]


@register('clip', param_defaults={'a_min': 0.0, 'a_max': 0.0})
def _clip(attrs, x):
    # jnp.clip: min(max(x, a_min), a_max); NaN stays NaN; an integer x
    # clipped to float bounds is f32, as torch.clamp gives it
    return torch.clamp(x, attrs['a_min'], attrs['a_max'])


@register('repeat', param_defaults={'repeats': 1, 'axis': None})
def _repeat(attrs, x):
    return torch.repeat_interleave(x, int(attrs['repeats']),
                                   dim=attrs.get('axis', None))


@register('tile', param_defaults={'reps': ()})
def _tile(attrs, x):
    return torch.tile(x, tuple(attrs['reps']))


@register('reverse', param_defaults={'axis': ()})
def _reverse(attrs, x):
    ax = attrs['axis']
    return torch.flip(x, (ax,) if isinstance(ax, int) else tuple(ax))


register_alias('flip', 'reverse')


@register('Concat', variadic=True, key_var_num_args='num_args',
          param_defaults={'dim': 1, 'num_args': 0})
def _concat(attrs, *xs):
    return torch.cat(xs, dim=int(attrs.get('dim', 1)))


register_alias('concat', 'Concat')


@register('stack', variadic=True, key_var_num_args='num_args',
          param_defaults={'axis': 0, 'num_args': 0})
def _stack(attrs, *xs):
    return torch.stack(xs, dim=int(attrs.get('axis', 0)))


def _num_slice_outputs(attrs):
    return int(attrs.get('num_outputs', 1))


@register('SliceChannel', num_outputs=_num_slice_outputs,
          param_defaults={'num_outputs': 1, 'axis': 1, 'squeeze_axis': False})
def _slice_channel(attrs, x):
    """``num_outputs`` equal parts along ``axis`` (which must divide, as
    jnp.split requires), each without that axis under ``squeeze_axis``."""
    n = int(attrs['num_outputs'])
    ax = int(attrs.get('axis', 1))
    if x.shape[ax] % n:
        raise ValueError('SliceChannel: axis %d of shape %s does not split '
                         'into %d equal parts' % (ax, tuple(x.shape), n))
    parts = torch.split(x, x.shape[ax] // n, dim=ax)
    if attrs.get('squeeze_axis', False):
        parts = [p.squeeze(ax) for p in parts]
    return tuple(parts)


register_alias('split', 'SliceChannel')


@register('where', input_names=['condition', 'x', 'y'])
def _where(attrs, cond, x, y):
    if cond.dim() < x.dim() and cond.dim() == 1:
        cond = cond.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(cond != 0, x, y)


def _take_rows(a, idx, ax):
    """``a`` indexed by the int64 ``idx`` (in range) along ``ax``, the
    index's shape in the axis' place."""
    ax = ax % a.dim()
    out = torch.index_select(a, ax, idx.reshape(-1))
    return out.reshape(a.shape[:ax] + idx.shape + a.shape[ax + 1:])


@register('take', input_names=['a', 'indices'],
          param_defaults={'axis': 0, 'mode': 'clip'})
def _take(attrs, a, indices):
    """``wrap`` takes an index modulo the axis' length; otherwise it is
    clamped into [0, n) (a negative index to 0), as jnp.take's clip mode
    does."""
    ax = int(attrs.get('axis', 0))
    n = a.shape[ax]
    idx = _index_int(indices)
    if attrs.get('mode', 'clip') == 'wrap':
        idx = torch.remainder(idx, n)
    return _take_rows(a, idx.clamp(0, max(n - 1, 0)), ax)


@register('batch_take', input_names=['a', 'indices'])
def _batch_take(attrs, a, indices):
    idx = _clamped(_index_int(indices).reshape(-1), a.shape[1])
    return a[torch.arange(a.shape[0], device=a.device), idx]


@register('Embedding', input_names=['data', 'weight'],
          param_defaults={'input_dim': 0, 'output_dim': 0, 'dtype': 'float32'})
def _embedding(attrs, data, weight):
    """A lookup of rows of ``weight``, each index clamped into [0, V)."""
    idx = _index_int(data).clamp(0, max(weight.shape[0] - 1, 0))
    return _take_rows(weight, idx, 0)


@register('one_hot', param_defaults={'depth': 0, 'on_value': 1.0,
                                     'off_value': 0.0, 'dtype': 'float32'})
def _one_hot(attrs, indices):
    """jax.nn.one_hot (an index outside [0, depth) gives a row of zeros) in
    ``dtype``, then ``* (on - off) + off`` in that dtype (an integer dtype
    comes out f32, as jnp promotes it with a Python float)."""
    depth = int(attrs['depth'])
    idx = _index_int(indices)
    hot = idx[..., None] == torch.arange(depth, device=idx.device)
    on, off = attrs.get('on_value', 1.0), attrs.get('off_value', 0.0)
    return hot.to(_dtype(attrs)) * (on - off) + off


def _fill_value(dtype):
    """What jnp.take_along_axis gives for an index out of range."""
    if dtype.is_floating_point:
        return float('nan')
    return torch.iinfo(dtype).min if dtype != torch.bool else True


@register('pick', input_names=['data', 'index'],
          param_defaults={'axis': -1, 'keepdims': False})
def _pick(attrs, data, index):
    ax = int(attrs.get('axis', -1)) % data.dim()
    n = data.shape[ax]
    data, idx = along_axis(data, _index_int(index), ax)
    idx = torch.where(idx < 0, idx + n, idx)
    inside = (idx >= 0) & (idx < n)
    picked = torch.gather(data, ax, idx.clamp(0, max(n - 1, 0)))
    picked = picked.masked_fill(~inside, _fill_value(data.dtype))
    return picked if attrs.get('keepdims', False) else picked.squeeze(ax)


@register('gather_nd', input_names=['data', 'indices'])
def _gather_nd(attrs, data, indices):
    idx = _index_int(indices)
    return data[tuple(_clamped(idx[i], data.shape[i])
                      for i in range(idx.shape[0]))]


@register('scatter_nd', input_names=['data', 'indices'],
          param_defaults={'shape': ()})
def _scatter_nd(attrs, data, indices):
    """Zeros of ``shape`` with ``data`` added at ``indices``; an index out
    of range (after a negative one counts from the end) is dropped."""
    shape = tuple(attrs['shape'])
    idx = _index_int(indices)
    m = idx.shape[0]
    idx = idx.reshape(m, -1)
    n = torch.tensor(shape[:m], device=idx.device)[:, None]
    idx = torch.where(idx < 0, idx + n, idx)
    keep = ((idx >= 0) & (idx < n)).all(0)
    vals = data.reshape((idx.shape[1],) + tuple(data.shape[indices.dim() - 1:]))
    out = torch.zeros(shape, dtype=data.dtype, device=data.device)
    return out.index_put_(tuple(idx[:, keep]), vals[keep], accumulate=True)


def _pad_index(n, before, after, mode, device):
    """The source index of each position of an axis of length ``n`` padded
    by ``before`` and ``after``: numpy's ``edge`` repeats the end element,
    ``reflect`` mirrors about it (periodically, for pads longer than the
    axis)."""
    i = torch.arange(-before, n + after, device=device)
    if mode == 'edge' or n == 1:
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    j = torch.remainder(i, period)
    return torch.where(j >= n, period - j, j)


@register('Pad', param_defaults={'mode': 'constant', 'pad_width': (),
                                 'constant_value': 0.0})
def _pad(attrs, x):
    """Pad each axis by (pad_width[2i], pad_width[2i+1])."""
    pw = attrs['pad_width']
    pairs = [(pw[2 * i], pw[2 * i + 1]) for i in range(len(pw) // 2)]
    mode = attrs.get('mode', 'constant')
    if mode == 'constant':
        flat = [p for pair in reversed(pairs) for p in pair]
        return F.pad(x, flat, value=attrs.get('constant_value', 0.0))
    for ax, (before, after) in enumerate(pairs):
        if before or after:
            x = torch.index_select(x, ax, _pad_index(
                x.shape[ax], before, after, mode, x.device))
    return x


register_alias('pad', 'Pad')


@register('_zeros', param_defaults={'shape': (), 'dtype': 'float32'},
          input_names=[])
def _zeros_op(attrs):
    return torch.zeros(tuple(attrs['shape']), dtype=_dtype(attrs))


@register('_ones', param_defaults={'shape': (), 'dtype': 'float32'},
          input_names=[])
def _ones_op(attrs):
    return torch.ones(tuple(attrs['shape']), dtype=_dtype(attrs))


@register('_arange', param_defaults={'start': 0, 'stop': None, 'step': 1.0,
                                     'repeat': 1, 'dtype': 'float32'},
          input_names=[])
def _arange_op(attrs):
    """numpy's arange in ``dtype`` (as jnp computes it for concrete
    arguments; bfloat16 through f32), each value ``repeat`` times."""
    d = _dtype(attrs)
    arr = np.arange(attrs.get('start', 0), attrs.get('stop'),
                    attrs.get('step', 1.0), dtype=np.float32
                    if d == torch.bfloat16 else np_dtype(attrs.get('dtype')))
    r = int(attrs.get('repeat', 1))
    return torch.from_numpy(np.repeat(arr, r) if r > 1 else arr).to(d)


@register('UpSampling', variadic=True, key_var_num_args='num_args',
          param_defaults={'scale': 1, 'sample_type': 'nearest',
                          'num_args': 1, 'num_filter': 0})
def _upsampling(attrs, *xs):
    """Nearest upsampling of NCHW inputs by ``scale``; several inputs are
    concatenated on the channels."""
    scale = int(attrs['scale'])
    outs = [x.repeat_interleave(scale, 2).repeat_interleave(scale, 3)
            for x in xs]
    return outs[0] if len(outs) == 1 else torch.cat(outs, 1)


@register('Crop', variadic=True, key_var_num_args='num_args',
          param_defaults={'offset': (0, 0), 'h_w': (0, 0),
                          'center_crop': False, 'num_args': 1})
def _crop(attrs, *xs):
    """NCHW spatial crop to ``h_w`` (or to the second input's size) at
    ``offset`` or at the centre."""
    x = xs[0]
    if len(xs) == 2:
        h, w = xs[1].shape[2], xs[1].shape[3]
    else:
        h, w = attrs['h_w']
    if attrs.get('center_crop', False):
        oh = (x.shape[2] - h) // 2
        ow = (x.shape[3] - w) // 2
    else:
        oh, ow = attrs.get('offset', (0, 0))
    return x[:, :, oh:oh + h, ow:ow + w]


@register('space_to_depth', param_defaults={'block_size': 1})
def _space_to_depth(attrs, x):
    b = int(attrs['block_size'])
    n, c, h, w = x.shape
    y = x.reshape(n, c, h // b, b, w // b, b)
    return y.permute(0, 3, 5, 1, 2, 4).reshape(n, c * b * b, h // b, w // b)


@register('depth_to_space', param_defaults={'block_size': 1})
def _depth_to_space(attrs, x):
    b = int(attrs['block_size'])
    n, c, h, w = x.shape
    y = x.reshape(n, b, b, c // (b * b), h, w)
    return y.permute(0, 3, 4, 1, 5, 2).reshape(n, c // (b * b), h * b, w * b)


@register('_state_zeros', param_defaults={'shape': (), 'dtype': 'float32',
                                          'batch_axis': 0},
          input_names=['data'])
def _state_zeros_op(attrs, data):
    """RNN begin-state zeros of ``shape``, a 0 in it taken from ``data``'s
    batch axis."""
    b = data.shape[int(attrs.get('batch_axis', 0))]
    out = tuple(b if int(d) == 0 else int(d) for d in attrs['shape'])
    return torch.zeros(out, dtype=_dtype(attrs), device=data.device)
