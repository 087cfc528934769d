"""Fused optimizer update ops: the counterpart of
``mxnet_tpu/ops/optimizer_ops.py`` (sgd_update, sgd_mom_update,
mp_sgd_update, mp_sgd_mom_update, nag_mom_update, adam_update,
rmsprop_update, rmspropalex_update, ftrl_update), registered under the same
names, input names, parameter defaults and ``mutate_inputs``.

Each returns the updated tensors and ``invoke`` writes the states back into
their NDArrays, so ``nd.sgd_mom_update(w, g, mom, out=w)`` rebinds ``mom``
as the JAX package does. The JAX package leaves these to XLA; here they are
plain torch ops. A Python number in an update is a weak-typed scalar in
jnp, rounded to the array's dtype before the arithmetic (0.9 is 0.8984375
beside a bf16 array); :func:`_k` makes it the same 0-d tensor here. The
fused fit window passes its per-step lr and wd as f32 0-d tensors on the
weight's device instead, the strong f32 scalars of the JAX window's traced
lr and wd, and :func:`_k` keeps their type.
"""
import torch

from .registry import register

__all__ = []


def _k(v, like):
    """The Python number ``v`` as jnp takes it beside ``like``: a scalar of
    like's dtype (a 0-d host tensor, which torch takes beside a CUDA
    tensor without a copy to the card). A tensor ``v`` is a strong scalar
    (jnp promotes a bf16 array beside an f32 0-d array to f32, where torch
    keeps bf16 beside a 0-d tensor): it comes back with like's number of
    dimensions, all of size 1, so that torch promotes beside it too."""
    if isinstance(v, torch.Tensor):
        return v.reshape((1,) * like.dim())
    return torch.tensor(v, dtype=like.dtype)


def _rescale_clip(grad, attrs):
    """grad * rescale_grad, clipped to [-c, c] only when clip_gradient c > 0."""
    g = grad * _k(attrs.get('rescale_grad', 1.0), grad)
    c = attrs.get('clip_gradient', -1.0)
    if c is not None and c > 0:
        g = torch.clamp(g, _k(-c, g), _k(c, g))
    return g


_SGD = {'lr': 0.01, 'wd': 0.0, 'rescale_grad': 1.0, 'clip_gradient': -1.0}


@register('sgd_update', input_names=['weight', 'grad'], param_defaults=_SGD,
          mutate_inputs={0: 0})
def _sgd_update(attrs, weight, grad):
    g = _rescale_clip(grad, attrs)
    return weight - _k(attrs['lr'], weight) * (
        g + _k(attrs.get('wd', 0.0), weight) * weight)


@register('sgd_mom_update', input_names=['weight', 'grad', 'mom'],
          param_defaults={'lr': 0.01, 'momentum': 0.0, 'wd': 0.0,
                          'rescale_grad': 1.0, 'clip_gradient': -1.0},
          mutate_inputs={0: 0, 2: 1}, num_visible_outputs=1, num_outputs=2)
def _sgd_mom_update(attrs, weight, grad, mom):
    g = _rescale_clip(grad, attrs)
    new_mom = _k(attrs.get('momentum', 0.0), mom) * mom - \
        _k(attrs['lr'], weight) * (g + _k(attrs.get('wd', 0.0), weight) * weight)
    return weight + new_mom, new_mom


@register('mp_sgd_update', input_names=['weight', 'grad', 'weight32'],
          param_defaults=dict(_SGD), mutate_inputs={0: 0, 2: 1},
          num_visible_outputs=1, num_outputs=2)
def _mp_sgd_update(attrs, weight, grad, weight32):
    """SGD on the f32 master ``weight32`` of a half-precision ``weight``:
    the grad is cast to f32 first; returns (weight32 in weight's dtype,
    weight32)."""
    g = _rescale_clip(grad.float(), attrs)
    w32 = weight32 - _k(attrs['lr'], weight32) * (
        g + _k(attrs.get('wd', 0.0), weight32) * weight32)
    return w32.to(weight.dtype), w32


@register('mp_sgd_mom_update',
          input_names=['weight', 'grad', 'mom', 'weight32'],
          param_defaults={'lr': 0.01, 'momentum': 0.0, 'wd': 0.0,
                          'rescale_grad': 1.0, 'clip_gradient': -1.0},
          mutate_inputs={0: 0, 2: 1, 3: 2}, num_visible_outputs=1,
          num_outputs=3)
def _mp_sgd_mom_update(attrs, weight, grad, mom, weight32):
    """SGD with momentum on the f32 master ``weight32``: returns (weight32
    in weight's dtype, the new momentum, weight32)."""
    g = _rescale_clip(grad.float(), attrs)
    new_mom = _k(attrs.get('momentum', 0.0), mom) * mom - \
        _k(attrs['lr'], weight32) * (
            g + _k(attrs.get('wd', 0.0), weight32) * weight32)
    w32 = weight32 + new_mom
    return w32.to(weight.dtype), new_mom, w32


@register('nag_mom_update', input_names=['weight', 'grad', 'mom'],
          param_defaults={'lr': 0.01, 'momentum': 0.0, 'wd': 0.0,
                          'rescale_grad': 1.0, 'clip_gradient': -1.0},
          mutate_inputs={0: 0, 2: 1}, num_visible_outputs=1, num_outputs=2)
def _nag_mom_update(attrs, weight, grad, mom):
    """Nesterov momentum: the lookahead g + momentum * new_mom steps the
    weight."""
    g = _rescale_clip(grad, attrs) + _k(attrs.get('wd', 0.0), weight) * weight
    m = attrs.get('momentum', 0.0)
    new_mom = _k(m, mom) * mom + g
    # m beside new_mom takes new_mom's type, which an f32 lr or wd makes f32
    return weight - _k(attrs['lr'], weight) * (g + _k(m, new_mom) * new_mom), \
        new_mom


@register('adam_update', input_names=['weight', 'grad', 'mean', 'var'],
          param_defaults={'lr': 0.001, 'beta1': 0.9, 'beta2': 0.999,
                          'epsilon': 1e-8, 'wd': 0.0, 'rescale_grad': 1.0,
                          'clip_gradient': -1.0},
          mutate_inputs={0: 0, 2: 1, 3: 2}, num_visible_outputs=1,
          num_outputs=3)
def _adam_update(attrs, weight, grad, mean, var):
    g = _rescale_clip(grad, attrs) + _k(attrs.get('wd', 0.0), weight) * weight
    b1, b2 = attrs.get('beta1', 0.9), attrs.get('beta2', 0.999)
    m = _k(b1, mean) * mean + _k(1 - b1, g) * g
    v = _k(b2, var) * var + _k(1 - b2, g) * torch.square(g)
    w = weight - _k(attrs['lr'], weight) * m / (
        torch.sqrt(v) + _k(attrs.get('epsilon', 1e-8), v))
    return w, m, v


def _clip_weights(w, attrs):
    cw = attrs.get('clip_weights', -1.0)
    if cw and cw > 0:
        w = torch.clamp(w, _k(-cw, w), _k(cw, w))
    return w


@register('rmsprop_update', input_names=['weight', 'grad', 'n'],
          param_defaults={'lr': 0.001, 'gamma1': 0.95, 'epsilon': 1e-8,
                          'wd': 0.0, 'rescale_grad': 1.0,
                          'clip_gradient': -1.0, 'clip_weights': -1.0},
          mutate_inputs={0: 0, 2: 1}, num_visible_outputs=1, num_outputs=2)
def _rmsprop_update(attrs, weight, grad, n):
    g = _rescale_clip(grad, attrs) + _k(attrs.get('wd', 0.0), weight) * weight
    g1 = attrs.get('gamma1', 0.95)
    new_n = _k(1 - g1, g) * torch.square(g) + _k(g1, n) * n
    w = weight - _k(attrs['lr'], weight) * g / torch.sqrt(
        new_n + _k(attrs.get('epsilon', 1e-8), new_n))
    return _clip_weights(w, attrs), new_n


@register('rmspropalex_update',
          input_names=['weight', 'grad', 'n', 'g', 'delta'],
          param_defaults={'lr': 0.001, 'gamma1': 0.95, 'gamma2': 0.9,
                          'epsilon': 1e-8, 'wd': 0.0, 'rescale_grad': 1.0,
                          'clip_gradient': -1.0, 'clip_weights': -1.0},
          mutate_inputs={0: 0, 2: 1, 3: 2, 4: 3}, num_visible_outputs=1,
          num_outputs=4)
def _rmspropalex_update(attrs, weight, grad, n, g_state, delta):
    """Centered RMSProp (Graves 2013): n and g are running means of g**2
    and g, delta the step."""
    grd = _rescale_clip(grad, attrs) + _k(attrs.get('wd', 0.0), weight) * weight
    g1, g2 = attrs.get('gamma1', 0.95), attrs.get('gamma2', 0.9)
    new_n = _k(1 - g1, grd) * torch.square(grd) + _k(g1, n) * n
    new_g = _k(1 - g1, grd) * grd + _k(g1, g_state) * g_state
    new_delta = _k(g2, delta) * delta - _k(attrs['lr'], grd) * grd / torch.sqrt(
        new_n - torch.square(new_g) + _k(attrs.get('epsilon', 1e-8), new_n))
    return _clip_weights(weight + new_delta, attrs), new_n, new_g, new_delta


@register('ftrl_update', input_names=['weight', 'grad', 'z', 'n'],
          param_defaults={'lr': 0.1, 'lamda1': 0.01, 'beta': 1.0, 'wd': 0.0,
                          'rescale_grad': 1.0, 'clip_gradient': -1.0},
          mutate_inputs={0: 0, 2: 1, 3: 2}, num_visible_outputs=1,
          num_outputs=3)
def _ftrl_update(attrs, weight, grad, z, n):
    """FTRL-proximal: z accumulates the grad less the proximal term, n the
    squared grads; the weight is 0 where |z| <= lamda1."""
    g = _rescale_clip(grad, attrs)
    lr, l1 = attrs['lr'], attrs.get('lamda1', 0.01)
    beta, wd = attrs.get('beta', 1.0), attrs.get('wd', 0.0)
    new_z = z + g - (torch.sqrt(n + torch.square(g)) - torch.sqrt(n)) \
        / _k(lr, n) * weight
    new_n = n + torch.square(g)
    w = (torch.sign(new_z) * _k(l1, new_z) - new_z) / \
        ((_k(beta, new_n) + torch.sqrt(new_n)) / _k(lr, new_n)
         + _k(wd, new_n)) * (torch.abs(new_z) > l1)
    return w, new_z, new_n
