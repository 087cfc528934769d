"""The port's decode step cache (mxnet_tpu_torch.serving.step_cache:
StepCache, DecodeEngine) against the JAX package's, on the CPU.

- StepCache: one sequence of lookups and drops through both tables; the
  slots, the fresh flags, the live sessions and the evictions equal step
  for step.
- DecodeEngine over one LSTMCell step graph (``docs/serving.md``: the
  states as data inputs, the new states as the trailing outputs) on the
  same weights in both packages: interleaved sessions past the capacity
  (LRU evictions and fresh re-admissions), a ``reset``, pad rows; every
  step's payload and every live session's carried state in the ring
  against the JAX DecodeEngine's, and each session's payloads against a
  host-tracked per-step reference (a batch-1 Module fed its states, as
  ``tests/unittest/test_serving.py`` does). Tolerance: f32 rtol 1e-5, atol
  1e-6 (the same step of f32 ops at other batch sizes).
- A rejected call registers no session; the engine serves only a plain
  Module, as the JAX engine.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.serving import step_cache as jsc
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.serving import step_cache as tsc

H, F = 12, 6


def test_step_cache_lru_matches_jax():
    ops = [('lookup', ['a', 'b']), ('lookup', ['a']), ('lookup', ['c']),
           ('lookup', ['b']), ('drop', 'c'), ('drop', 'c'),
           ('lookup', ['d', 'e']), ('lookup', ['a', 'f']), ('drop', 'a'),
           ('lookup', ['g', 'b'])]
    jc, tc = jsc.StepCache(3), tsc.StepCache(3)
    for op, arg in ops:
        if op == 'lookup':
            (js, jf), (ts, tf) = jc.lookup(arg), tc.lookup(arg)
            np.testing.assert_array_equal(ts, js)
            np.testing.assert_array_equal(tf, jf)
            assert ts.dtype == js.dtype and tf.dtype == jf.dtype
        else:
            assert tc.drop(arg) == jc.drop(arg)
        assert tc.sessions() == jc.sessions()
        assert tc.evictions == jc.evictions
    with pytest.raises(ValueError, match='duplicate'):
        tc.lookup(['x', 'x'])


def _step_module(pkg, batch, ctx):
    cell = pkg.rnn.LSTMCell(num_hidden=H, prefix='lstm_')
    x = pkg.sym.Variable('data')
    states = [pkg.sym.Variable('state_h'), pkg.sym.Variable('state_c')]
    out, new_states = cell(x, states)
    step = pkg.sym.Group([out] + list(new_states))
    m = pkg.mod.Module(step, data_names=('data', 'state_h', 'state_c'),
                       label_names=[], context=ctx)
    m.bind(data_shapes=[('data', (batch, F)), ('state_h', (batch, H)),
                        ('state_c', (batch, H))], for_training=False)
    return m


@pytest.fixture(scope='module')
def engines():
    mx.random.seed(11)
    jmod = _step_module(mx, 4, mx.cpu())
    jmod.init_params(initializer=mx.initializer.Uniform(0.5))
    weights = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    tmod = _step_module(mt, 4, mt.cpu())
    tmod.init_params()
    tmod.set_params({k: mt.nd.array(v, ctx=mt.cpu())
                     for k, v in weights.items()}, {})
    tref = _step_module(mt, 1, mt.cpu())
    tref.init_params()
    tref.set_params({k: mt.nd.array(v, ctx=mt.cpu())
                     for k, v in weights.items()}, {})
    jeng = jsc.DecodeEngine(jmod, state_names=('state_h', 'state_c'),
                            capacity=4, max_batch=4)
    teng = tsc.DecodeEngine(tmod, state_names=('state_h', 'state_c'),
                            capacity=4, max_batch=4)
    return jeng, teng, tref


# five sessions over four slots, batches of 1-4 rows (pad rows at 3)
TRAFFIC = [(['a', 'b'], False), (['a', 'b', 'c'], False), (['d'], False),
           (['e', 'a', 'c'], False), (['b'], False), (['d', 'a', 'c'], True),
           (['b', 'd', 'e', 'a'], False), (['c', 'e'], False)]


def test_decode_matches_jax_and_the_stepwise_reference(engines):
    jeng, teng, tref = engines
    assert teng.buckets == jeng.buckets
    rng = np.random.RandomState(12)
    history = {}
    # which rows start from zero state: a new session, one evicted (even by
    # an earlier row of the same batch), or a reset
    table = jsc.StepCache(teng.capacity)
    for sids, reset in TRAFFIC:
        tok = rng.standard_normal((len(sids), F)).astype(np.float32)
        _, fresh = table.lookup(sids)
        want = jeng.decode(sids, [tok], reset=reset)
        got = teng.decode(sids, [tok], reset=reset)
        assert len(got) == len(want) == 1
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
        assert teng.cache.sessions() == jeng.cache.sessions()
        assert teng.cache.evictions == jeng.cache.evictions
        for i, s in enumerate(sids):
            hist = [] if reset or fresh[i] else history[s]
            history[s] = hist + [(tok[i], got[0][i])]
        # the carried states of every live session, row by row
        live = teng.cache.sessions()
        rows = [teng.cache._slots[s] for s in live]
        assert rows == [jeng.cache._slots[s] for s in live]
        for ts, js in zip(teng._store, jeng._store):
            np.testing.assert_allclose(ts.numpy()[rows],
                                       np.asarray(js)[rows],
                                       rtol=1e-5, atol=1e-6)
    assert teng.cache.evictions > 0
    # each live session's payloads since its last fresh start, against the
    # per-step reference fed its own states
    for s in teng.cache.sessions():
        h = np.zeros((1, H), np.float32)
        c = np.zeros((1, H), np.float32)
        for tok, out in history[s]:
            tref.forward(mt.io.DataBatch(data=[
                mt.nd.array(tok[None], ctx=mt.cpu()),
                mt.nd.array(h, ctx=mt.cpu()), mt.nd.array(c, ctx=mt.cpu())]),
                is_train=False)
            o = [a.asnumpy() for a in tref.get_outputs()]
            np.testing.assert_allclose(out, o[0][0], rtol=1e-5, atol=1e-6)
            h, c = o[1], o[2]


def test_rejected_call_registers_nothing_and_warmup():
    tmod = _step_module(mt, 4, mt.cpu())
    tmod.init_params()
    teng = tsc.DecodeEngine(tmod, state_names=('state_h', 'state_c'),
                            capacity=8, max_batch=4)
    teng.decode(['a'], [np.ones((1, F), np.float32)])
    with pytest.raises(ValueError, match='shape'):
        teng.decode(['new'], [np.zeros((1, F + 1), np.float32)])
    with pytest.raises(ValueError, match='largest bucket'):
        teng.decode(list('vwxyz'), [np.zeros((5, F), np.float32)])
    assert teng.cache.sessions() == ['a']
    assert teng.warmup() == len(teng.buckets) == 3
    assert teng.cache.sessions() == ['a']
    assert sorted(teng._programs) == teng.buckets


def test_engine_needs_a_plain_module():
    mod = mt.mod.SequentialModule()
    with pytest.raises(ValueError, match='plain Module'):
        tsc.DecodeEngine(mod, state_names=('state_h',))
    tmod = _step_module(mt, 2, mt.cpu())
    tmod.init_params()
    with pytest.raises(ValueError, match='not data inputs'):
        tsc.DecodeEngine(tmod, state_names=('state_x',))
