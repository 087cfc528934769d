"""Random sampling ops: the counterpart of ``mxnet_tpu/ops/random_ops.py``
(the ``_random_*`` samplers with scalar parameters, ``_sample_*`` with
per-element parameters, ``_sample_multinomial`` and ``_shuffle``),
registered under the same names, aliases, inputs and parameter defaults.

Each takes the device's ``torch.Generator`` as its last argument and draws
on the generator's device with torch's samplers (Philox on the card). The
draws follow the JAX ops' formulas (a negative binomial is a Poisson of a
gamma, ...), so each sampler has the same distribution as its JAX
counterpart, not the same numbers. With no generator (shape inference) the
ops return empty tensors of the right shape on ``meta``.
"""
import torch

from ..base import torch_dtype
from .registry import register, register_alias

__all__ = []

_META = torch.device('meta')


def _shape(attrs):
    s = attrs.get('shape', ())
    if isinstance(s, int):
        return (s,)
    # an omitted shape draws ONE sample as a (1,) array, not 0-d
    return tuple(s) if s else (1,)


def _dt(attrs, default='float32'):
    d = attrs.get('dtype', default)
    if d in (None, 'None'):
        d = default
    return torch_dtype(d)


def _device(gen):
    return gen.device if gen is not None else _META


def _uniform01(gen, shape, device, dtype=torch.float32):
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    return torch.rand(shape, generator=gen, device=device, dtype=dtype)


def _normal01(gen, shape, device, dtype=torch.float32):
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    return torch.randn(shape, generator=gen, device=device, dtype=dtype)


def _exponential01(gen, shape, device):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return t if gen is None else t.exponential_(1.0, generator=gen)


def _gamma(gen, alpha):
    """Gamma(alpha, 1) draws of alpha's shape (f32)."""
    alpha = alpha.float()
    if gen is None:
        return torch.empty_like(alpha)
    return torch._standard_gamma(alpha, generator=gen)


def _poisson(gen, lam):
    lam = lam.float()
    if gen is None:
        return torch.empty_like(lam)
    return torch.poisson(lam, generator=gen)


@register('_random_uniform', input_names=[], needs_rng=True,
          differentiable=False,
          param_defaults={'low': 0.0, 'high': 1.0, 'shape': (),
                          'dtype': 'float32'})
def _uniform(attrs, gen):
    dev = _device(gen)
    lo, hi = attrs.get('low', 0.0), attrs.get('high', 1.0)
    out = torch.empty(_shape(attrs), dtype=_dt(attrs), device=dev)
    return out if gen is None else out.uniform_(lo, hi, generator=gen)


register_alias('uniform', '_random_uniform')
register_alias('random_uniform', '_random_uniform')


@register('_random_normal', input_names=[], needs_rng=True,
          differentiable=False,
          param_defaults={'loc': 0.0, 'scale': 1.0, 'shape': (),
                          'dtype': 'float32'})
def _normal(attrs, gen):
    dt = _dt(attrs)
    z = _normal01(gen, _shape(attrs), _device(gen), dt)
    return (torch.tensor(attrs.get('loc', 0.0), dtype=dt)
            + torch.tensor(attrs.get('scale', 1.0), dtype=dt) * z)


register_alias('normal', '_random_normal')
register_alias('random_normal', '_random_normal')


@register('_random_gamma', input_names=[], needs_rng=True,
          differentiable=False,
          param_defaults={'alpha': 1.0, 'beta': 1.0, 'shape': (),
                          'dtype': 'float32'})
def _gamma_op(attrs, gen):
    alpha = torch.full(_shape(attrs), float(attrs.get('alpha', 1.0)),
                       device=_device(gen))
    return (_gamma(gen, alpha) * attrs.get('beta', 1.0)).to(_dt(attrs))


register_alias('random_gamma', '_random_gamma')


@register('_random_exponential', input_names=[], needs_rng=True,
          differentiable=False,
          param_defaults={'lam': 1.0, 'shape': (), 'dtype': 'float32'})
def _exponential(attrs, gen):
    e = _exponential01(gen, _shape(attrs), _device(gen))
    return (e / attrs.get('lam', 1.0)).to(_dt(attrs))


register_alias('random_exponential', '_random_exponential')


@register('_random_poisson', input_names=[], needs_rng=True,
          differentiable=False,
          param_defaults={'lam': 1.0, 'shape': (), 'dtype': 'float32'})
def _poisson_op(attrs, gen):
    lam = torch.full(_shape(attrs), float(attrs.get('lam', 1.0)),
                     device=_device(gen))
    return _poisson(gen, lam).to(_dt(attrs))


register_alias('random_poisson', '_random_poisson')


@register('_random_negative_binomial', input_names=[], needs_rng=True,
          differentiable=False,
          param_defaults={'k': 1, 'p': 1.0, 'shape': (), 'dtype': 'float32'})
def _negbinomial(attrs, gen):
    # NB(k, p) = Poisson(Gamma(k, (1 - p) / p))
    k, p = attrs.get('k', 1), attrs.get('p', 1.0)
    alpha = torch.full(_shape(attrs), float(k), device=_device(gen))
    lam = _gamma(gen, alpha) * ((1 - p) / max(p, 1e-6))
    return _poisson(gen, lam).to(_dt(attrs))


register_alias('random_negative_binomial', '_random_negative_binomial')


@register('_random_generalized_negative_binomial', input_names=[],
          needs_rng=True, differentiable=False,
          param_defaults={'mu': 1.0, 'alpha': 1.0, 'shape': (),
                          'dtype': 'float32'})
def _gen_negbinomial(attrs, gen):
    mu, alpha = attrs.get('mu', 1.0), attrs.get('alpha', 1.0)
    shape_k = torch.full(_shape(attrs), 1.0 / max(alpha, 1e-6),
                         device=_device(gen))
    lam = _gamma(gen, shape_k) * (mu * alpha)
    return _poisson(gen, lam).to(_dt(attrs))


register_alias('random_generalized_negative_binomial',
               '_random_generalized_negative_binomial')


@register('_sample_multinomial', input_names=['data'], needs_rng=True,
          differentiable=False,
          param_defaults={'shape': (), 'get_prob': False, 'dtype': 'int32'})
def _sample_multinomial(attrs, data, gen):
    """A categorical draw per row of the (unnormalised) probabilities in
    ``data``'s last axis, ``shape`` draws a row (one when it is empty);
    probabilities below 1e-20 count as 1e-20, as the JAX op's log does."""
    n = attrs.get('shape', ()) or ()
    if isinstance(n, int):
        n = (n,)
    count = 1
    for d in n:
        count *= int(d)
    out_shape = tuple(data.shape[:-1]) + tuple(n)
    dt = _dt({'dtype': attrs.get('dtype', 'int32')})
    if gen is None:
        return torch.empty(out_shape, dtype=dt, device=data.device)
    probs = data.float().clamp_min(1e-20).reshape(-1, data.shape[-1])
    draws = torch.multinomial(probs, count, replacement=True, generator=gen)
    return draws.reshape(out_shape).to(dt)


register_alias('sample_multinomial', '_sample_multinomial')


@register('_shuffle', needs_rng=True, differentiable=False)
def _shuffle(attrs, data, gen):
    if gen is None:
        return torch.empty_like(data)
    perm = torch.randperm(data.shape[0], generator=gen, device=data.device)
    return data[perm]


register_alias('shuffle', '_shuffle')


def _elemwise_sample(name, sampler, in_names):
    """sample_uniform and the rest: one draw (or ``shape`` draws) per
    element of the parameter arrays."""
    @register(name, input_names=in_names, needs_rng=True, differentiable=False,
              param_defaults={'shape': (), 'dtype': 'float32'})
    def op(attrs, *args):
        gen, params = args[-1], args[:-1]
        # an omitted shape means no extra trailing dims here
        s = attrs.get('shape', ())
        extra = ((s,) if isinstance(s, int) else tuple(s)) if s else ()
        out_shape = tuple(params[0].shape) + extra
        bparams = [p.float().reshape(tuple(p.shape) + (1,) * len(extra))
                   for p in params]
        return sampler(gen, bparams, out_shape,
                       params[0].device).to(_dt(attrs))
    return op


_elemwise_sample(
    '_sample_uniform',
    lambda g, p, s, d: p[0] + (p[1] - p[0]) * _uniform01(g, s, d),
    ['low', 'high'])
register_alias('sample_uniform', '_sample_uniform')
_elemwise_sample(
    '_sample_normal',
    lambda g, p, s, d: p[0] + p[1] * _normal01(g, s, d),
    ['mu', 'sigma'])
register_alias('sample_normal', '_sample_normal')
_elemwise_sample(
    '_sample_gamma',
    lambda g, p, s, d: _gamma(g, p[0].expand(s)) * p[1],
    ['alpha', 'beta'])
register_alias('sample_gamma', '_sample_gamma')
_elemwise_sample(
    '_sample_exponential',
    lambda g, p, s, d: _exponential01(g, s, d) / p[0],
    ['lam'])
register_alias('sample_exponential', '_sample_exponential')
_elemwise_sample(
    '_sample_poisson',
    lambda g, p, s, d: _poisson(g, p[0].expand(s)),
    ['lam'])
register_alias('sample_poisson', '_sample_poisson')
