"""The port's random streams and samplers (mxnet_tpu_torch.random,
.ops.random_ops, nd.random) against the JAX package's, on the CPU.

The streams cannot match (torch's generators against threefry), so each
sampler is held to its JAX counterpart by distribution: N draws on each
side, the sample means and variances within 5 standard errors of each
other (the standard error of a difference of two sample means is
sqrt(2 var / N); of two sample variances about sqrt(2 (m4 - var^2) / N),
taken here with the JAX side's fourth moment), so a sampler with another
distribution's mean or spread fails while two right ones pass at any seed
with probability about 1 - 6e-7 per moment. The draws are made from fixed
seeds, so the test is deterministic. A sampler is held to itself by seed:
the same seed gives the same draws, bit for bit, and another seed others.
"""
import math

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import nd, optimizer as topt, random as trandom

N = 20000
SE = 5.0

# (name, nd.random function name, kwargs)
SCALAR = [
    ('uniform', 'uniform', {'low': -1.0, 'high': 3.0}),
    ('normal', 'normal', {'loc': 1.0, 'scale': 2.0}),
    ('gamma', 'gamma', {'alpha': 2.0, 'beta': 1.5}),
    ('exponential', 'exponential', {'scale': 2.0}),
    ('poisson', 'poisson', {'lam': 3.0}),
    ('negative_binomial', 'negative_binomial', {'k': 3, 'p': 0.4}),
    ('generalized_negative_binomial', 'generalized_negative_binomial',
     {'mu': 2.0, 'alpha': 0.5}),
]
# (name, nd.random function, parameter arrays): two rows of parameters,
# N draws each
ELEMWISE = [
    ('sample_uniform', 'uniform', {'low': [0.0, -2.0], 'high': [1.0, 2.0]}),
    ('sample_normal', 'normal', {'loc': [0.0, 3.0], 'scale': [1.0, 0.5]}),
    ('sample_gamma', 'gamma', {'alpha': [0.5, 4.0], 'beta': [1.0, 2.0]}),
    ('sample_exponential', 'exponential', {'scale': [1.0, 0.25]}),
    ('sample_poisson', 'poisson', {'lam': [0.5, 7.0]}),
]


def _moments_agree(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    n = got.size
    var = want.var()
    m4 = ((want - want.mean()) ** 4).mean()
    assert abs(got.mean() - want.mean()) <= SE * math.sqrt(2 * var / n), \
        (what, 'mean', got.mean(), want.mean())
    assert abs(got.var() - want.var()) <= SE * math.sqrt(
        2 * max(m4 - var ** 2, 1e-12) / n), (what, 'var', got.var(), want.var())


@pytest.mark.parametrize('name,fn,kw', SCALAR, ids=[c[0] for c in SCALAR])
def test_scalar_sampler_matches_jax_by_distribution(name, fn, kw):
    mx.random.seed(1)
    trandom.seed(1)
    want = getattr(mx.nd.random, fn)(shape=(N,), **kw).asnumpy()
    got = getattr(nd.random, fn)(shape=(N,), ctx=mt.cpu(), **kw)
    assert got.shape == (N,) and got.dtype == np.float32
    _moments_agree(got.asnumpy(), want, name)


@pytest.mark.parametrize('name,fn,params', ELEMWISE,
                         ids=[c[0] for c in ELEMWISE])
def test_elemwise_sampler_matches_jax_by_distribution(name, fn, params):
    mx.random.seed(2)
    trandom.seed(2)
    want = getattr(mx.nd.random, fn)(
        **{k: mx.nd.array(v) for k, v in params.items()}, shape=(N,)).asnumpy()
    got = getattr(nd.random, fn)(
        **{k: nd.array(v, ctx=mt.cpu()) for k, v in params.items()},
        shape=(N,)).asnumpy()
    assert got.shape == want.shape == (2, N)
    for row in range(2):
        _moments_agree(got[row], want[row], (name, row))


def test_multinomial_and_shuffle_match_jax_by_distribution():
    mx.random.seed(3)
    trandom.seed(3)
    probs = [[0.1, 0.2, 0.7], [0.5, 0.5, 0.0]]
    want = mx.nd.random.multinomial(mx.nd.array(probs), shape=N).asnumpy()
    got = nd.random.multinomial(nd.array(probs, ctx=mt.cpu()), shape=N)
    assert got.shape == (2, N) and got.dtype == np.int32
    got = got.asnumpy()
    for row in range(2):
        for k in range(3):
            _moments_agree(got[row] == k, want[row] == k, ('multinomial', k))
    assert not (got[1] == 2).any()       # probability 0 is never drawn
    x = nd.arange(0, 1000, ctx=mt.cpu())
    perm = nd.random.shuffle(x).asnumpy()
    assert sorted(perm) == list(range(1000)) and (perm != np.arange(1000)).any()


def test_dtype_and_shape_defaults_match_jax():
    mx.random.seed(4)
    trandom.seed(4)
    for kw in ({}, {'dtype': 'float16'}, {'shape': (2, 3)}):
        want = mx.nd.random.uniform(**kw)
        got = nd.random.uniform(ctx=mt.cpu(), **kw)
        assert got.shape == want.shape and got.dtype == want.dtype, kw
    want = mx.nd.random.poisson(lam=2.0, shape=(3,), dtype='int32')
    got = nd.random.poisson(lam=2.0, shape=(3,), dtype='int32', ctx=mt.cpu())
    assert got.dtype == want.dtype


def test_same_seed_same_draws_other_seed_other_draws():
    def draw():
        return np.concatenate([
            nd.random.normal(shape=(100,), ctx=mt.cpu()).asnumpy(),
            nd.random.gamma(alpha=2.0, shape=(100,), ctx=mt.cpu()).asnumpy(),
            nd.random.poisson(lam=nd.array([1.0, 5.0], ctx=mt.cpu()),
                              shape=(50,)).asnumpy().ravel()])
    trandom.seed(11)
    a = draw()
    trandom.seed(11)
    np.testing.assert_array_equal(draw(), a)
    trandom.seed(12)
    assert (draw() != a).any()


def test_get_state_set_state_continues_the_streams():
    trandom.seed(5)
    nd.random.uniform(shape=(10,), ctx=mt.cpu())
    state = trandom.get_state()
    a = nd.random.uniform(shape=(10,), ctx=mt.cpu()).asnumpy()
    h = trandom.host_rng().randn(4)
    s = trandom.next_seed()
    nd.random.uniform(shape=(10,), ctx=mt.cpu())
    trandom.set_state(state)
    np.testing.assert_array_equal(
        nd.random.uniform(shape=(10,), ctx=mt.cpu()).asnumpy(), a)
    np.testing.assert_array_equal(trandom.host_rng().randn(4), h)
    assert trandom.next_seed() == s


def test_host_stream_matches_jax_after_seed():
    """The initializers' host stream is a numpy RandomState on both
    sides: after the same seed the draws are equal."""
    mx.random.seed(6)
    trandom.seed(6)
    np.testing.assert_array_equal(trandom.host_rng().uniform(size=5),
                                  mx.random.host_rng().uniform(size=5))


def test_node_generator_depends_on_seed_and_index():
    def draw(seed, index):
        g = trandom.node_generator(torch.device('cpu'), seed, index)
        return torch.rand(8, generator=g)
    assert torch.equal(draw(3, 7), draw(3, 7))
    assert not torch.equal(draw(3, 7), draw(3, 8))
    assert not torch.equal(draw(3, 7), draw(4, 7))


def test_sgld_noise_is_normal_with_variance_lr():
    """SGLD's noise: with a zero gradient and no weight decay, the update
    is the noise alone, N(0, lr) per element (held to the moments of
    N(0, lr): mean within 5 standard errors of 0, variance of lr, whose
    standard error is sqrt(2 lr^2 / N))."""
    trandom.seed(8)
    lr = 0.04
    opt = topt.create('sgld', learning_rate=lr)
    w = nd.zeros((N,), ctx=mt.cpu())
    opt.update(0, w, nd.zeros((N,), ctx=mt.cpu()), None)
    noise = w.asnumpy().astype(np.float64)
    assert abs(noise.mean()) <= SE * math.sqrt(lr / N)
    assert abs(noise.var() - lr) <= SE * math.sqrt(2 * lr ** 2 / N)


def test_invoke_passes_the_device_generator():
    """A needs_rng op gets its device's generator: Dropout in training
    draws from it, so the same seed gives the same mask."""
    from mxnet_tpu_torch import autograd
    x = nd.ones((64,), ctx=mt.cpu())
    outs = []
    for _ in range(2):
        trandom.seed(9)
        with autograd.train_mode():
            outs.append(nd.Dropout(x, p=0.5).asnumpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    assert set(np.unique(outs[0])) == {0.0, 2.0}
