"""Neural-network layer ops: the counterpart of ``mxnet_tpu/ops/nn.py``,
registered under the same names, input names and parameter defaults.

The ops whose JAX versions dispatch to Pallas kernels — LayerNorm, softmax
and softmax_cross_entropy — keep both of the JAX op's branches, which
differ in their numbers: the kernel branch (the CUDA row kernels of
:mod:`.cuda_kernels`; their plain versions for CPU tensors) and the plain
branch. :func:`use_fused` chooses between them as the JAX package's
``use_fused()`` does, with the card in the TPU's place.

The ResNet op set (FullyConnected, Convolution, Deconvolution, Pooling,
Activation, LeakyReLU, BatchNorm, Dropout, SoftmaxOutput), MakeLoss and
log_softmax are left to XLA in the JAX package, and here to torch's
library calls (cuDNN and cuBLAS on the card), with the JAX ops' numbers:

- FullyConnected rounds the product to the data's type before the bias;
- Convolution is one ``F.conv1d/2d/3d`` call. The JAX package's TPU
  lowerings (channels-last compute, ``MXTPU_CONV_STEM_S2D``,
  ``MXTPU_CONV_BWD_PATCHES``) compute the same function and have no
  counterpart;
- Pooling pads explicitly (``pooling_convention='full'`` pads the high
  side, and average pooling divides by ``prod(kernel)``, counting the
  padding), where ``ceil_mode`` would divide the last windows by less and
  drop a window that starts in the padding;
- BatchNorm computes its statistics as the JAX op does (one pass of
  shifted moments, or two passes under ``MXTPU_BN_ONEPASS=0``), with the
  biased variance and ``momentum * old + (1 - momentum) * batch``, so it is
  not ``F.batch_norm``; the new statistics carry no gradient. It
  normalises in f32 and rounds once, where the JAX op rounds the batch
  mean and ``1 / sqrt(var + eps)`` to bf16 first: that loses the centred
  value where a channel's spread is small next to its mean, as where it
  normalises over a few values;
- SoftmaxOutput's backward is the reference's (softmax - one-hot, scaled
  and masked by its attrs), whatever the head gradient; MakeLoss's is its
  ``grad_scale`` (over the batch or the valid count), likewise, and so are
  those of the regression heads and SVMOutput.

The rest of the JAX module's names are plain torch too: InstanceNorm,
L2Normalization, LRN, SoftmaxActivation (a plain softmax in the JAX package
as well), the regression heads, SVMOutput and the Sequence ops.

A Python number beside a tensor is rounded to the tensor's dtype first, as
jnp's weak-typed scalars are (:func:`_k`).
"""
import math

import torch
import torch.nn.functional as F

from ..config import flags
from . import cuda_kernels as ck
from .registry import get as get_op, register, register_alias
from .shape_ops import along_axis

__all__ = ['use_fused']


def use_fused(x):
    """True when the registry ops take their kernel branch for ``x``: always
    for a CUDA tensor; for a CPU tensor only when ``MXTPU_FORCE_PALLAS`` is
    set (the kernel wrappers then run their plain versions)."""
    if x.device.type == 'cuda':
        return True
    if x.device.type != 'cpu':      # meta tensors of shape inference
        return False
    flags.reload('MXTPU_FORCE_PALLAS')  # tests toggle it per case
    return flags.get('MXTPU_FORCE_PALLAS')


@register('LayerNorm', input_names=['data', 'gamma', 'beta'],
          param_defaults={'axis': -1, 'eps': 1e-5})
def _layer_norm(attrs, x, gamma, beta):
    ax = int(attrs.get('axis', -1)) % x.ndim
    eps = attrs.get('eps', 1e-5)
    if ax == x.ndim - 1 and use_fused(x):
        return ck.fused_layernorm(x, gamma, beta, eps)
    x32 = x.float()
    mean = x32.mean(ax, keepdim=True)
    var = (x32 - mean).square().mean(ax, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    bshape = tuple(x.shape[ax] if i == ax else 1 for i in range(x.ndim))
    # y is rounded to x's dtype before gamma and beta, which then promote
    # (bf16 x with f32 gamma gives f32), as in the JAX op
    return y.to(x.dtype) * gamma.reshape(bshape) + beta.reshape(bshape)


@register('softmax', param_defaults={'axis': -1, 'temperature': None})
def _softmax(attrs, x):
    t = attrs.get('temperature', None)
    if t:
        x = x / t
    if not x.is_floating_point():
        x = x.float()       # jax.nn.softmax of an integer x is f32
    ax = int(attrs.get('axis', -1)) % x.ndim
    if ax == x.ndim - 1 and use_fused(x):
        return ck.fused_softmax(x)
    return torch.softmax(x, dim=ax)


@register('log_softmax', param_defaults={'axis': -1, 'temperature': None})
def _log_softmax(attrs, x):
    t = attrs.get('temperature', None)
    if t:
        x = x / t
    if not x.is_floating_point():
        x = x.float()
    return torch.log_softmax(x, dim=int(attrs.get('axis', -1)))


@register('softmax_cross_entropy', input_names=['data', 'label'])
def _softmax_cross_entropy(attrs, data, label):
    # the labels broadcast against the rows as jnp.take_along_axis
    # broadcasts them (a (1,) label serves every row), ValueError where
    # they do not
    data, lab = along_axis(data, label.to(torch.int32), data.dim() - 1)
    if use_fused(data):
        # per-row logsumexp - gold in one kernel: no softmax in memory
        return ck.softmax_xent(data, lab[:, 0].contiguous()).sum().to(
            data.dtype)
    logp = torch.log_softmax(data, dim=-1)
    # jnp.take_along_axis: a negative label counts from the end, and one
    # still outside [0, V) picks NaN
    V = data.shape[-1]
    idx = torch.where(lab < 0, lab + V, lab)
    inside = (idx >= 0) & (idx < V)
    picked = torch.gather(logp, -1, idx.clamp(0, V - 1).long())[:, 0]
    return -picked.masked_fill(~inside[:, 0], float('nan')).sum()


def _k(v, like):
    """The Python number ``v`` as jnp takes it beside ``like``: a 0-d
    tensor of like's dtype."""
    return torch.tensor(v, dtype=like.dtype)


# ---------------------------------------------------------------------------
# FullyConnected
# ---------------------------------------------------------------------------

def _bias_arg_names(default_no_bias):
    def names(attrs):
        if attrs.get('no_bias', default_no_bias):
            return ['data', 'weight']
        return ['data', 'weight', 'bias']
    return names


_fc_arg_names = _bias_arg_names(False)


@register('FullyConnected', input_names=['data', 'weight', 'bias'],
          param_defaults={'num_hidden': 0, 'no_bias': False, 'flatten': True},
          arg_names_fn=_fc_arg_names)
def _fully_connected(attrs, data, weight, bias=None):
    x = data.reshape(data.shape[0], -1) if attrs.get('flatten', True) \
        else data
    # the product in x's type (f32 accumulation), then the bias
    y = torch.matmul(x, weight.t())
    if bias is not None and not attrs.get('no_bias', False):
        y = y + bias
    return y


# ---------------------------------------------------------------------------
# Convolution and Deconvolution
# ---------------------------------------------------------------------------

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _conv_geometry(attrs):
    kernel = tuple(attrs['kernel'])
    nd = len(kernel)
    return (kernel, tuple(attrs.get('stride') or (1,) * nd),
            tuple(attrs.get('dilate') or (1,) * nd),
            tuple(attrs.get('pad') or (0,) * nd), int(attrs.get('num_group', 1)))


def _add_channel_bias(out, bias):
    return out + bias.reshape((1, -1) + (1,) * (out.ndim - 2))


@register('Convolution', input_names=['data', 'weight', 'bias'],
          param_defaults={'kernel': (), 'stride': (), 'dilate': (), 'pad': (),
                          'num_filter': 0, 'num_group': 1, 'no_bias': False,
                          'workspace': 1024, 'cudnn_tune': None,
                          'cudnn_off': False, 'layout': None},
          arg_names_fn=_bias_arg_names(False))
def _convolution(attrs, data, weight, bias=None):
    kernel, stride, dilate, pad, groups = _conv_geometry(attrs)
    out = _CONV[len(kernel)](data, weight, None, stride, pad, dilate, groups)
    if bias is not None and not attrs.get('no_bias', False):
        out = _add_channel_bias(out, bias)
    return out


@register('Deconvolution', input_names=['data', 'weight', 'bias'],
          param_defaults={'kernel': (), 'stride': (), 'dilate': (), 'pad': (),
                          'adj': (), 'target_shape': (), 'num_filter': 0,
                          'num_group': 1, 'no_bias': True, 'workspace': 512},
          arg_names_fn=_bias_arg_names(True))
def _deconvolution(attrs, data, weight, bias=None):
    """The transposed convolution (the input gradient of Convolution); the
    weight is (in_channels, out_channels / groups, *kernel), torch's
    layout too. ``target_shape`` is taken as the JAX op takes it: not at
    all."""
    kernel, stride, dilate, pad, groups = _conv_geometry(attrs)
    adj = tuple(attrs.get('adj') or (0,) * len(kernel))
    out = _DECONV[len(kernel)](data, weight, None, stride, pad, adj, groups,
                               dilate)
    if bias is not None and not attrs.get('no_bias', True):
        out = _add_channel_bias(out, bias)
    return out


# ---------------------------------------------------------------------------
# Pooling
# ---------------------------------------------------------------------------

_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


@register('Pooling',
          param_defaults={'kernel': (), 'pool_type': 'max', 'stride': (),
                          'pad': (), 'global_pool': False,
                          'pooling_convention': 'valid', 'cudnn_off': False})
def _pooling(attrs, data):
    nd = data.ndim - 2
    if attrs.get('global_pool', False):
        kernel = tuple(data.shape[2:])
        stride, pad = (1,) * nd, (0,) * nd
    else:
        kernel = tuple(attrs['kernel'])
        stride = tuple(attrs.get('stride') or (1,) * nd)
        pad = tuple(attrs.get('pad') or (0,) * nd)
    ptype = attrs.get('pool_type', 'max')
    full = attrs.get('pooling_convention', 'valid') == 'full'
    widths = []                 # F.pad's order: the last axis first
    for i in reversed(range(nd)):
        hi = pad[i]
        if full:
            # ceil mode: pad the high side so the last window fits
            rem = (data.shape[2 + i] + 2 * pad[i] - kernel[i]) % stride[i]
            if rem:
                hi = pad[i] + stride[i] - rem
        widths += [pad[i], hi]
    if ptype == 'max':
        fill = (-math.inf if data.is_floating_point()
                else torch.iinfo(data.dtype).min)
        x = F.pad(data, widths, value=fill) if any(widths) else data
        return _MAX_POOL[nd](x, kernel, stride)
    if ptype in ('avg', 'sum'):
        x = F.pad(data, widths) if any(widths) else data
        if nd == 1:     # avg_pool1d takes no divisor: pool over (1, k)
            x, kernel, stride = x[:, :, None], (1,) + kernel, (1,) + stride
        div = 1 if ptype == 'sum' else math.prod(kernel)
        pool = F.avg_pool2d if len(kernel) == 2 else F.avg_pool3d
        out = pool(x, kernel, stride, divisor_override=div)
        return out[:, :, 0] if nd == 1 else out
    raise ValueError('unknown pool_type ' + ptype)


register_alias('Pooling_v1', 'Pooling')


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

@register('Activation', param_defaults={'act_type': 'relu'})
def _activation(attrs, x):
    act = attrs.get('act_type', 'relu')
    if act == 'relu':
        return torch.relu(x)
    if act == 'sigmoid':
        return torch.sigmoid(x)
    if act == 'tanh':
        return torch.tanh(x)
    if act == 'softrelu':
        # jax.nn.softplus: log(1 + exp(x)) without F.softplus's threshold
        return torch.logaddexp(x, torch.zeros((), dtype=x.dtype))
    if act == 'softsign':
        return x / (1 + torch.abs(x))
    raise ValueError('unknown act_type ' + act)


def _lrelu_arg_names(attrs):
    return ['data', 'gamma'] if attrs.get('act_type') == 'prelu' else ['data']


def _channels(v, x):
    return v.reshape((1, -1) + (1,) * (x.ndim - 2)) if x.ndim > 1 else v


@register('LeakyReLU', input_names=['data', 'gamma'],
          param_defaults={'act_type': 'leaky', 'slope': 0.25,
                          'lower_bound': 0.125, 'upper_bound': 0.334},
          needs_rng=True, train_aware=True, arg_names_fn=_lrelu_arg_names)
def _leaky_relu(attrs, x, *rest):
    """leaky, elu, prelu (a slope a channel) and rrelu (slopes drawn a
    channel while training, their mean otherwise)."""
    act = attrs.get('act_type', 'leaky')
    gen = rest[-1]
    if act == 'leaky':
        return torch.where(x > 0, x, _k(attrs.get('slope', 0.25), x) * x)
    if act == 'elu':
        s = _k(attrs.get('slope', 0.25), x)
        return torch.where(x > 0, x, s * torch.expm1(x))
    if act == 'prelu':
        return torch.where(x > 0, x, _channels(rest[0], x) * x)
    if act == 'rrelu':
        lo, hi = attrs.get('lower_bound', 0.125), attrs.get('upper_bound', 0.334)
        if attrs.get('__is_train__', False):
            n = x.shape[1] if x.ndim > 1 else 1
            slope = torch.empty(n, dtype=x.dtype, device=x.device)
            if gen is not None:
                slope.uniform_(lo, hi, generator=gen)
            s = _channels(slope, x)
        else:
            s = _k((lo + hi) / 2.0, x)
        return torch.where(x > 0, x, s * x)
    raise ValueError('unknown act_type ' + act)


# ---------------------------------------------------------------------------
# BatchNorm: returns (y, new moving_mean, new moving_var); invoke and the
# executor write the last two back into the moving statistics
# ---------------------------------------------------------------------------

@register('BatchNorm',
          input_names=['data', 'gamma', 'beta', 'moving_mean', 'moving_var'],
          param_defaults={'eps': 1e-3, 'momentum': 0.9, 'fix_gamma': True,
                          'use_global_stats': False, 'output_mean_var': False,
                          'axis': 1, 'cudnn_off': False},
          aux_inputs=('moving_mean', 'moving_var'),
          mutate_inputs={3: 1, 4: 2}, num_visible_outputs=1,
          num_outputs=3, train_aware=True)
def _batch_norm(attrs, data, gamma, beta, moving_mean, moving_var):
    eps = attrs.get('eps', 1e-3)
    momentum = attrs.get('momentum', 0.9)
    axis = int(attrs.get('axis', 1)) % data.ndim
    use_global = (attrs.get('use_global_stats', False)
                  or not attrs.get('__is_train__', False))
    reduce_axes = tuple(i for i in range(data.ndim) if i != axis)
    bshape = tuple(data.shape[axis] if i == axis else 1
                   for i in range(data.ndim))
    g = torch.ones_like(gamma) if attrs.get('fix_gamma', True) else gamma
    x32 = data.float()
    if use_global:
        mean, var = moving_mean, moving_var
        new_mm, new_mv = moving_mean, moving_var
    else:
        if flags.get('MXTPU_BN_ONEPASS'):
            # shifted moments: the sums of (x - pivot) and its square in
            # one read of x, the pivot (each channel's first element)
            # centring them near the mean; the variance clamped at 0
            n = x32.numel() // x32.shape[axis]
            pivot = x32[tuple(slice(None) if i == axis else 0
                              for i in range(x32.ndim))].detach()
            xc = x32 - pivot.reshape(bshape)
            m0 = xc.sum(reduce_axes) / n
            mean = pivot + m0
            var = torch.clamp_min((xc * xc).sum(reduce_axes) / n - m0 * m0,
                                  0.0)
        else:           # MXTPU_BN_ONEPASS=0: mean, then centred squares
            mean = x32.mean(reduce_axes)
            var = x32.var(reduce_axes, unbiased=False)
        with torch.no_grad():
            new_mm = (_k(momentum, moving_mean) * moving_mean
                      + _k(1 - momentum, moving_mean) * mean.to(moving_mean.dtype))
            new_mv = (_k(momentum, moving_var) * moving_var
                      + _k(1 - momentum, moving_var) * var.to(moving_var.dtype))
    # normalised in f32 and rounded once to the result's type (that of
    # data, gamma and beta together, as the JAX op promotes them); the
    # backward then sums its terms in f32 too
    out_dtype = torch.promote_types(
        data.dtype, torch.promote_types(gamma.dtype, beta.dtype))
    scale = g.float() * torch.rsqrt(var.float() + eps)
    y = (x32 - mean.float().reshape(bshape)) * scale.reshape(bshape) \
        + beta.float().reshape(bshape)
    return y.to(out_dtype), new_mm.detach(), new_mv.detach()


register_alias('BatchNorm_v1', 'BatchNorm')


# ---------------------------------------------------------------------------
# Dropout
# ---------------------------------------------------------------------------

@register('Dropout', param_defaults={'p': 0.5, 'mode': 'training'},
          needs_rng=True, train_aware=True)
def _dropout(attrs, x, gen):
    p = attrs.get('p', 0.5)
    training = attrs.get('__is_train__', False) or attrs.get('mode') == 'always'
    if not training or p <= 0 or gen is None:
        return x
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / _k(keep, x), torch.zeros_like(x))


# ---------------------------------------------------------------------------
# SoftmaxOutput: softmax forward, the reference's own backward
# ---------------------------------------------------------------------------

def _one_hot(label, k, axis, dtype):
    """jax.nn.one_hot: a label outside [0, k) gives a zero row."""
    ax = axis % (label.ndim + 1)
    view = [1] * (label.ndim + 1)
    view[ax] = k
    cols = torch.arange(k, device=label.device).reshape(view)
    return (label.unsqueeze(ax) == cols).to(dtype)


class _SoftmaxOutputFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, attrs):
        axis = 1 if attrs.get('multi_output', False) else -1
        out = torch.softmax(data, dim=axis)
        ctx.save_for_backward(out, label)
        ctx.attrs = attrs
        return out

    @staticmethod
    def backward(ctx, g):
        # softmax - one-hot, masked and scaled; the head gradient is not
        # read, as in the reference
        out, label = ctx.saved_tensors
        attrs = ctx.attrs
        multi = attrs.get('multi_output', False)
        axis = 1 if multi else -1
        lab = label.to(torch.int32)
        onehot = _one_hot(lab, out.shape[axis], axis, out.dtype)
        smooth = attrs.get('smooth_alpha', 0.0)
        if smooth:
            k = out.shape[axis]
            onehot = onehot * (1 - smooth) + smooth / (k - 1) * (1 - onehot)
        grad = out - onehot
        ignore = attrs.get('ignore_label', -1.0)
        use_ignore = attrs.get('use_ignore', False)
        if use_ignore:
            mask = (label != ignore).to(out.dtype)
            grad = grad * mask.unsqueeze(axis if axis >= 0 else out.ndim - 1)
        scale = attrs.get('grad_scale', 1.0)
        norm = attrs.get('normalization', 'null')
        if norm == 'batch':
            scale = scale / out.shape[0]
        elif norm == 'valid':
            if use_ignore:
                scale = scale / torch.clamp_min((label != ignore).sum(), 1)
            else:
                scale = scale / label.numel()
        return grad * scale, None, None


@register('SoftmaxOutput', input_names=['data', 'label'],
          param_defaults={'grad_scale': 1.0, 'ignore_label': -1.0,
                          'multi_output': False, 'use_ignore': False,
                          'preserve_shape': False, 'normalization': 'null',
                          'out_grad': False, 'smooth_alpha': 0.0})
def _softmax_output(attrs, data, label):
    """softmax over the class axis (1 with ``multi_output``, else the
    last), whose gradient is the reference's: (softmax - one_hot(label))
    with ``smooth_alpha``, masked where label == ``ignore_label`` under
    ``use_ignore``, times ``grad_scale`` over the batch or the valid count
    by ``normalization``."""
    return _SoftmaxOutputFunction.apply(data, label, dict(attrs))


register_alias('Softmax', 'SoftmaxOutput')


# ---------------------------------------------------------------------------
# MakeLoss: the identity forward, a constant gradient
# ---------------------------------------------------------------------------

class _MakeLossFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        # grad_scale (over the batch or the valid count) everywhere; the
        # head gradient is not read, as in the reference
        scale = ctx.scale
        if isinstance(scale, torch.Tensor):
            return scale.to(g.dtype).expand(g.shape).clone(), None
        return torch.full_like(g, scale), None


@register('MakeLoss', param_defaults={'grad_scale': 1.0,
                                      'normalization': 'null',
                                      'valid_thresh': 0.0})
def _make_loss(attrs, x):
    """``x`` as a loss: the forward is the identity and the gradient is
    ``grad_scale``, divided by the batch size (``normalization='batch'``)
    or by the count of values above ``valid_thresh`` ('valid')."""
    scale = attrs.get('grad_scale', 1.0)
    if attrs.get('normalization') == 'batch':
        scale = scale / x.shape[0]
    elif attrs.get('normalization') == 'valid':
        scale = scale / torch.clamp_min(
            (x > attrs.get('valid_thresh', 0.0)).sum(), 1)
    return _MakeLossFunction.apply(x, scale)


register_alias('make_loss', 'MakeLoss')


# ---------------------------------------------------------------------------
# InstanceNorm, L2Normalization, LRN, SoftmaxActivation
# ---------------------------------------------------------------------------

@register('InstanceNorm', input_names=['data', 'gamma', 'beta'],
          param_defaults={'eps': 1e-3})
def _instance_norm(attrs, x, gamma, beta):
    """Normalises each sample's channel over its spatial axes (the biased
    variance), in x's dtype."""
    axes = tuple(range(2, x.dim()))
    mean = x.mean(axes, keepdim=True)
    var = x.var(axes, unbiased=False, keepdim=True)
    bshape = (1, -1) + (1,) * (x.dim() - 2)
    return ((x - mean) * torch.rsqrt(var + attrs.get('eps', 1e-3))
            * gamma.reshape(bshape) + beta.reshape(bshape))


@register('L2Normalization', param_defaults={'eps': 1e-10,
                                             'mode': 'instance'})
def _l2_normalization(attrs, x):
    """x over the root of its sum of squares (plus eps): over each sample
    ('instance'), each position across channels ('channel') or each
    channel over space ('spatial')."""
    mode = attrs.get('mode', 'instance')
    axes = ((1,) if mode == 'channel' else tuple(range(1, x.dim()))
            if mode == 'instance' else tuple(range(2, x.dim())))
    return x / torch.sqrt(x.square().sum(axes, keepdim=True)
                          + attrs.get('eps', 1e-10))


@register('LRN', param_defaults={'alpha': 1e-4, 'beta': 0.75, 'knorm': 2.0,
                                 'nsize': 5})
def _lrn(attrs, x):
    """Local response normalisation across channels: x * (knorm + alpha /
    nsize * the sum of squares over nsize channels) ** -beta."""
    alpha, beta = attrs.get('alpha', 1e-4), attrs.get('beta', 0.75)
    knorm, nsize = attrs.get('knorm', 2.0), int(attrs.get('nsize', 5))
    half = nsize // 2
    sq = F.pad(x.square().movedim(1, -1), (half, half)).movedim(-1, 1)
    ssum = sq.unfold(1, nsize, 1).sum(-1)
    return x * torch.pow(knorm + alpha / nsize * ssum, -beta)


@register('SoftmaxActivation', param_defaults={'mode': 'instance'})
def _softmax_activation(attrs, x):
    """softmax over the channels ('channel') or over all of each sample's
    values ('instance'), by torch: the JAX op is a plain softmax too."""
    if attrs.get('mode', 'instance') == 'channel':
        return torch.softmax(x, dim=1)
    return torch.softmax(x.reshape(x.shape[0], -1), dim=-1).reshape(x.shape)


# ---------------------------------------------------------------------------
# The regression heads and SVMOutput: a forward, and the reference's own
# backward whatever the head gradient
# ---------------------------------------------------------------------------

class _RegressionFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, fwd, bwd, grad_scale):
        out = fwd(data)
        ctx.save_for_backward(out, label)
        ctx.bwd, ctx.scale = bwd, grad_scale / data.shape[0]
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        grad = ctx.bwd(out, label) * ctx.scale
        return grad.to(out.dtype), None, None, None, None


def _make_regression(name, fwd, bwd):
    @register(name, input_names=['data', 'label'],
              param_defaults={'grad_scale': 1.0})
    def head(attrs, data, label):
        return _RegressionFunction.apply(data, label.reshape(data.shape),
                                         fwd, bwd,
                                         attrs.get('grad_scale', 1.0))
    head.__doc__ = ('%s: the forward, and the gradient (its rule on the '
                    'output and the label) x grad_scale / batch.' % name)
    return head


_make_regression('LinearRegressionOutput', torch.clone,
                 lambda o, lab: o - lab)
_make_regression('LogisticRegressionOutput', torch.sigmoid,
                 lambda o, lab: o - lab)
_make_regression('MAERegressionOutput', torch.clone,
                 lambda o, lab: torch.sign(o - lab))


class _SVMFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, margin, reg, linear):
        ctx.save_for_backward(data, label)
        ctx.cfg = margin, reg, linear
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        # the hinge's gradient on the wrong classes where the margin is
        # violated, minus their sum on the true class
        data, label = ctx.saved_tensors
        margin, reg, linear = ctx.cfg
        lab = label.to(torch.int32)
        onehot = _one_hot(lab, data.shape[1], -1, data.dtype)
        correct = get_op('pick').fn({'axis': 1, 'keepdims': True}, data, lab)
        slack = margin - (correct - data)
        zero = torch.zeros((), dtype=data.dtype)
        gdata = torch.where(slack > 0, _k(reg, data) if linear
                            else _k(2 * reg, data) * slack, zero)
        gdata = gdata * (1 - onehot)
        gdata = gdata - gdata.sum(1, keepdim=True) * onehot
        return gdata, None, None, None, None


@register('SVMOutput', input_names=['data', 'label'],
          param_defaults={'margin': 1.0, 'regularization_coefficient': 1.0,
                          'use_linear': False})
def _svm_output(attrs, data, label):
    """The scores (the identity), with the multi-class hinge loss's
    gradient: squared (or linear with ``use_linear``), of ``margin``,
    times ``regularization_coefficient``."""
    return _SVMFunction.apply(data, label, attrs.get('margin', 1.0),
                              attrs.get('regularization_coefficient', 1.0),
                              attrs.get('use_linear', False))


# ---------------------------------------------------------------------------
# Sequence ops: time-major data (T, N, ...), the lengths a sample
# ---------------------------------------------------------------------------

_SEQ = dict(input_names=['data', 'sequence_length'],
            optional_inputs={'sequence_length': 'use_sequence_length'})


def _lengths(attrs, seq_len):
    if not attrs.get('use_sequence_length', False) or seq_len is None:
        return None
    return seq_len.to(torch.int32).long()


@register('SequenceLast', param_defaults={'use_sequence_length': False,
                                          'axis': 0}, **_SEQ)
def _sequence_last(attrs, data, seq_len=None):
    """Each sample's last step (its length's, clamped into range as jnp's
    gather clamps)."""
    sl = _lengths(attrs, seq_len)
    if sl is None:
        return data[-1]
    T = data.shape[0]
    idx = torch.where(sl - 1 < 0, sl - 1 + T, sl - 1).clamp(0, T - 1)
    return data[idx, torch.arange(data.shape[1], device=data.device)]


@register('SequenceMask', param_defaults={'use_sequence_length': False,
                                          'value': 0.0, 'axis': 0}, **_SEQ)
def _sequence_mask(attrs, data, seq_len=None):
    """``value`` at each sample's steps past its length."""
    sl = _lengths(attrs, seq_len)
    if sl is None:
        return data
    mask = (torch.arange(data.shape[0], device=data.device)[:, None]
            < sl[None, :])
    mask = mask.reshape(mask.shape + (1,) * (data.dim() - 2))
    return torch.where(mask, data, _k(attrs.get('value', 0.0), data))


@register('SequenceReverse', param_defaults={'use_sequence_length': False,
                                             'axis': 0}, **_SEQ)
def _sequence_reverse(attrs, data, seq_len=None):
    """Each sample's first ``length`` steps reversed, the rest kept."""
    sl = _lengths(attrs, seq_len)
    if sl is None:
        return data.flip(0)
    t = torch.arange(data.shape[0], device=data.device)[:, None]
    src = torch.where(t < sl[None, :], sl[None, :] - 1 - t, t)
    return data[src, torch.arange(data.shape[1], device=data.device)[None, :]]
