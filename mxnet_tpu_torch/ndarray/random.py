"""nd.random: the sampling namespace, the counterpart of
``mxnet_tpu/ndarray/random.py`` (uniform, normal, gamma, ... over the ops
of :mod:`..ops.random_ops`). NDArray parameters take the per-element
``_sample_*`` ops, numbers the ``_random_*`` ones. ``ctx`` places a draw
that has no array input (the JAX package takes the current context there
whatever ``ctx`` says; the port honours it, as the reference does).
"""
from .ndarray import NDArray, invoke

__all__ = ['uniform', 'normal', 'gamma', 'exponential', 'poisson',
           'negative_binomial', 'generalized_negative_binomial',
           'multinomial', 'shuffle', 'randn']


def _sample(op_elem, op_scalar, params, shape, dtype, ctx, out, kwargs):
    if isinstance(shape, int):
        shape = (shape,)
    if any(isinstance(p, NDArray) for p in params.values()):
        return invoke(op_elem, list(params.values()),
                      {'shape': shape or (), 'dtype': dtype}, out)
    attrs = dict(params)
    attrs.update({'shape': shape or (1,), 'dtype': dtype})
    attrs.update(kwargs)
    if ctx is not None:
        attrs['ctx'] = ctx
    return invoke(op_scalar, [], attrs, out)


def uniform(low=0, high=1, shape=None, dtype='float32', ctx=None, out=None,
            **kwargs):
    return _sample('_sample_uniform', '_random_uniform',
                   {'low': low, 'high': high}, shape, dtype, ctx, out, kwargs)


def normal(loc=0, scale=1, shape=None, dtype='float32', ctx=None, out=None,
           **kwargs):
    return _sample('_sample_normal', '_random_normal',
                   {'loc': loc, 'scale': scale} if not isinstance(loc, NDArray)
                   else {'mu': loc, 'sigma': scale}, shape, dtype, ctx, out,
                   kwargs)


def randn(*shape, **kwargs):
    loc = kwargs.pop('loc', 0)
    scale = kwargs.pop('scale', 1)
    dtype = kwargs.pop('dtype', 'float32')
    return normal(loc, scale, shape, dtype, **kwargs)


def gamma(alpha=1, beta=1, shape=None, dtype='float32', ctx=None, out=None,
          **kwargs):
    return _sample('_sample_gamma', '_random_gamma',
                   {'alpha': alpha, 'beta': beta}, shape, dtype, ctx, out,
                   kwargs)


def exponential(scale=1, shape=None, dtype='float32', ctx=None, out=None,
                **kwargs):
    return _sample('_sample_exponential', '_random_exponential',
                   {'lam': 1.0 / scale}, shape, dtype, ctx, out, kwargs)


def poisson(lam=1, shape=None, dtype='float32', ctx=None, out=None, **kwargs):
    return _sample('_sample_poisson', '_random_poisson',
                   {'lam': lam}, shape, dtype, ctx, out, kwargs)


def negative_binomial(k=1, p=1, shape=None, dtype='float32', ctx=None,
                      out=None, **kwargs):
    return _sample('_sample_negative_binomial', '_random_negative_binomial',
                   {'k': k, 'p': p}, shape, dtype, ctx, out, kwargs)


def generalized_negative_binomial(mu=1, alpha=1, shape=None, dtype='float32',
                                  ctx=None, out=None, **kwargs):
    return _sample('_sample_generalized_negative_binomial',
                   '_random_generalized_negative_binomial',
                   {'mu': mu, 'alpha': alpha}, shape, dtype, ctx, out, kwargs)


def multinomial(data, shape=(), get_prob=False, out=None, dtype='int32'):
    return invoke('_sample_multinomial', [data],
                  {'shape': shape, 'get_prob': get_prob, 'dtype': dtype}, out)


def shuffle(data, out=None):
    return invoke('_shuffle', [data], {}, out)
