"""mx.sym.random: symbolic samplers, the counterpart of
``mxnet_tpu/symbol/random.py``. Scalar parameters compose the
``_random_*`` ops; Symbol parameters the ``_sample_*`` ops where one is
registered.
"""
from . import register as _register
from .symbol import Symbol

__all__ = ['uniform', 'normal', 'gamma', 'exponential', 'poisson',
           'negative_binomial', 'generalized_negative_binomial',
           'multinomial']


def _sampler(scalar_op, sample_op, pnames):
    scalar_fn = _register.make_sym_function(scalar_op)
    sample_fn = (_register.make_sym_function(sample_op)
                 if sample_op else None)

    def fn(*args, **kwargs):
        vals = dict(zip(pnames, args))
        # positionals past the distribution params follow the
        # reference's generated signature: shape, then dtype
        for extra_name, extra in zip(('shape', 'dtype'),
                                     args[len(pnames):]):
            if extra_name in kwargs:
                raise TypeError('%s() got multiple values for argument '
                                '%r' % (fn.__name__, extra_name))
            kwargs[extra_name] = extra
        for n in pnames:
            if n in kwargs:
                if n in vals:
                    raise TypeError('%s() got multiple values for '
                                    'argument %r' % (fn.__name__, n))
                vals[n] = kwargs.pop(n)
        n_sym = sum(isinstance(v, Symbol) for v in vals.values())
        if n_sym:
            if sample_fn is None:
                raise TypeError('%s does not take Symbol parameters'
                                % scalar_op)
            if n_sym != len(pnames) or len(vals) != len(pnames):
                raise ValueError('Distribution parameters must all '
                                 'have the same type (all Symbol or '
                                 'all numbers)')
            return sample_fn(*[vals[n] for n in pnames], **kwargs)
        kwargs.update(vals)
        return scalar_fn(**kwargs)
    fn.__name__ = scalar_op.replace('_random_', '')
    return fn


uniform = _sampler('_random_uniform', '_sample_uniform', ('low', 'high'))
normal = _sampler('_random_normal', '_sample_normal', ('loc', 'scale'))
gamma = _sampler('_random_gamma', '_sample_gamma', ('alpha', 'beta'))
exponential = _sampler('_random_exponential', '_sample_exponential',
                       ('lam',))
poisson = _sampler('_random_poisson', '_sample_poisson', ('lam',))
negative_binomial = _sampler('_random_negative_binomial', None,
                             ('k', 'p'))
generalized_negative_binomial = _sampler(
    '_random_generalized_negative_binomial', None, ('mu', 'alpha'))
multinomial = _register.make_sym_function('_sample_multinomial')
