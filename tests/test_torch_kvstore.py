"""The port's local KVStore (``mxnet_tpu_torch.kvstore``) against the JAX
package's: init, push of a list (summed) and pull into several targets,
string and int keys, pull casting to the target's dtype, the optimizer's
updater on push, the optimizer states' save and load, and the factory.
Values come from a numpy seed; sums of the same f32 values in the same
order agree exactly, updates to 1e-6.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

SHAPE = (3, 4)


def _vals(seed, n=3):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(n)]


def _push_pull(pkg, kv_type):
    kv = pkg.kv.create(kv_type)
    ctx = pkg.cpu()
    kv.init('w', pkg.nd.array(_vals(0, 1)[0], ctx=ctx))
    kv.init(['3', 5], [pkg.nd.zeros(SHAPE, ctx=ctx)] * 2)
    kv.push('w', [pkg.nd.array(v, ctx=ctx) for v in _vals(1)])
    outs = [pkg.nd.zeros(SHAPE, ctx=ctx), pkg.nd.zeros(SHAPE, ctx=ctx,
                                                       dtype='bfloat16')]
    kv.pull('w', out=outs)
    kv.push(['3', 5], [[pkg.nd.array(v, ctx=ctx) for v in _vals(2, 2)],
                       pkg.nd.array(_vals(3, 1)[0], ctx=ctx)])
    more = [pkg.nd.zeros(SHAPE, ctx=ctx) for _ in range(2)]
    kv.pull(['3', 5], out=more)
    return [o.asnumpy() for o in outs + more], kv


@pytest.mark.parametrize('kv_type', ['local', 'device'])
def test_push_sums_and_pull_broadcasts_as_jax(kv_type):
    want, kvj = _push_pull(mx, kv_type)
    got, kvt = _push_pull(mt, kv_type)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0], sum(_vals(1)))
    assert (kvt.type, kvt.rank, kvt.num_workers) == \
        (kvj.type, kvj.rank, kvj.num_workers) == (kv_type, 0, 1)


def _updated(pkg, tmp_path):
    kv = pkg.kv.create('local')
    ctx = pkg.cpu()
    kv.set_optimizer(pkg.optimizer.create('sgd', learning_rate=0.1,
                                          momentum=0.9, wd=1e-4,
                                          rescale_grad=0.5))
    kv.init(0, pkg.nd.array(_vals(4, 1)[0], ctx=ctx))
    out = pkg.nd.zeros(SHAPE, ctx=ctx)
    for seed in (5, 6):
        kv.push(0, [pkg.nd.array(v, ctx=ctx) for v in _vals(seed, 2)])
        kv.pull(0, out=out)
    fname = str(tmp_path / ('%s.states' % pkg.__name__))
    kv.save_optimizer_states(fname)
    kv.load_optimizer_states(fname)
    kv.push(0, [pkg.nd.array(_vals(7, 1)[0], ctx=ctx)])
    kv.pull(0, out=out)
    return out.asnumpy(), kv


def test_updater_on_push_matches_jax(tmp_path):
    want, _ = _updated(mx, tmp_path)
    got, kv = _updated(mt, tmp_path)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # the momentum state survives the save and load
    assert list(kv._updater.states) == [0]


def test_custom_updater_and_factory():
    kv = mt.kv.create('local_allreduce_device')
    seen = []
    kv._set_updater(lambda k, g, w: seen.append((k, g.asnumpy().sum())))
    kv.init('7', mt.nd.zeros((2,), ctx=mt.cpu()))
    kv.push('7', [mt.nd.ones((2,), ctx=mt.cpu())] * 3)
    assert seen == [(7, 6.0)]
    with pytest.raises(NotImplementedError, match='item 11'):
        mt.kv.create('dist_sync')
    with pytest.raises(mt.MXNetError):
        mt.kv.create('nccl')
