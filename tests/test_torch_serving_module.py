"""The port's serving engine over a Module and its dynamic batcher
(``mxnet_tpu_torch/serving``) against the JAX package's
(``mxnet_tpu/serving``) on the CPU.

The models are the JAX serving tests' 10-16-4 MLP under SoftmaxOutput
(``tests/unittest/test_serving.py``) and the decoder's head at D = 32,
V = 64 (``softmax(FullyConnected(LayerNorm(x), no_bias))``) under
``MXTPU_FORCE_PALLAS=1`` for both packages (the JAX side on its Pallas
kernels in interpret mode, the port on the kernels' plain versions). The
JAX package writes each checkpoint; both packages' ``from_checkpoint``
serve it. Tolerance, where the two packages compute: rtol 1e-5 / atol
1e-6 (the same f32 arithmetic, sums in another order). The port's full
bucket is held bit for bit to its own ``Module.predict`` (the same runner
on the same rows). Every wait carries a timeout.
"""
import os

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import telemetry as jtele
from mxnet_tpu.serving import DynamicBatcher as JBatcher
from mxnet_tpu.serving import ServingEngine as JEngine
from mxnet_tpu_torch import telemetry as ttele
from mxnet_tpu_torch.serving import DynamicBatcher, ServingEngine

RTOL, ATOL = 1e-5, 1e-6
WAIT = 30                   # seconds any one future may take
FLAGS = ('MXTPU_TELEMETRY', 'MXTPU_TELEMETRY_PATH', 'MXTPU_FUSED_EVAL',
         'MXTPU_SERVE_MAX_BATCH', 'MXTPU_SERVE_MAX_WAIT_MS',
         'MXTPU_FORCE_PALLAS')


def _reload():
    mx.config.flags.reload()
    mt.config.flags.reload()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in FLAGS:
        monkeypatch.delenv(name, raising=False)
    _reload()
    yield
    for name in FLAGS:
        monkeypatch.delenv(name, raising=False)
    _reload()
    jtele._reset_for_tests()
    ttele._reset_for_tests()


@pytest.fixture
def tele(tmp_path, monkeypatch):
    monkeypatch.setenv('MXTPU_TELEMETRY', '1')
    monkeypatch.setenv('MXTPU_TELEMETRY_PATH', str(tmp_path / 't.jsonl'))
    _reload()
    jtele._reset_for_tests()
    ttele._reset_for_tests()


def _mlp(pkg):
    S = pkg.sym
    h = S.FullyConnected(S.Variable('data'), num_hidden=16, name='fc1')
    h = S.Activation(h, act_type='relu', name='relu1')
    h = S.FullyConnected(h, num_hidden=4, name='fc2')
    return S.SoftmaxOutput(h, name='softmax')


def _head(pkg, vocab=64):
    S = pkg.sym
    h = S.LayerNorm(S.Variable('data'), name='ln')
    h = S.FullyConnected(h, num_hidden=vocab, no_bias=True, name='head')
    return S.softmax(h, axis=-1, name='probs')


@pytest.fixture(scope='module')
def mlp_ckpt(tmp_path_factory):
    """The MLP's checkpoint, written by the JAX package."""
    mx.random.seed(7)
    mod = mx.mod.Module(_mlp(mx), context=mx.cpu())
    mod.bind(data_shapes=[('data', (8, 10))], for_training=False)
    mod.init_params(mx.init.Uniform(0.5))
    prefix = str(tmp_path_factory.mktemp('mlp') / 'mlp')
    mod.save_checkpoint(prefix, 1)
    return prefix


@pytest.fixture(scope='module')
def engines(mlp_ckpt):
    """(JAX engine, port engine) over the MLP checkpoint, max_batch 8."""
    return (JEngine.from_checkpoint(mlp_ckpt, 1, [('data', (10,))],
                                    max_batch=8),
            ServingEngine.from_checkpoint(mlp_ckpt, 1, [('data', (10,))],
                                          max_batch=8, context=mt.cpu()))


def _rows(n, seed=0):
    return np.random.RandomState(seed).randn(n, 10).astype(np.float32)


@pytest.mark.parametrize('rows', [1, 3, 8, 21])
def test_engines_answer_the_jax_checkpoint_alike(engines, rows):
    jeng, teng = engines
    x = _rows(rows, seed=rows)
    want, got = jeng.infer([x]), teng.infer([x])
    assert len(got) == len(want) == 1
    assert got[0].shape == want[0].shape == (rows, 4)
    assert got[0].dtype == np.float32
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    assert [b for _, _, b in teng.dispatch_rows([x])] == \
        [b for _, _, b in jeng.dispatch_rows([x])]


def test_engines_describe_alike(engines):
    jeng, teng = engines
    assert teng.name == jeng.name == 'softmax'
    assert teng.buckets == jeng.buckets == [1, 2, 4, 8]
    assert teng.describe() == jeng.describe()


def _port_predict(prefix, x, batch):
    """The port's per-batch Module.predict over x's rows (padded up to
    whole batches)."""
    os.environ['MXTPU_FUSED_EVAL'] = '0'
    mt.config.flags.reload('MXTPU_FUSED_EVAL')
    try:
        mod = mt.mod.Module.load(prefix, 1, label_names=[], context=mt.cpu())
        mod.bind(data_shapes=[('data', (batch, 10))], for_training=False)
        pad = (-len(x)) % batch
        full = np.concatenate([x, np.zeros((pad, 10), x.dtype)])
        return mod.predict(mt.io.NDArrayIter(full, None, batch_size=batch)) \
            .asnumpy()[:len(x)]
    finally:
        os.environ.pop('MXTPU_FUSED_EVAL', None)
        mt.config.flags.reload('MXTPU_FUSED_EVAL')


def test_full_bucket_matches_port_predict_bit_for_bit(engines, mlp_ckpt):
    _, teng = engines
    x = _rows(16, seed=5)
    ref = _port_predict(mlp_ckpt, x, 8)
    np.testing.assert_array_equal(teng.infer([x[:8]])[0], ref[:8])
    np.testing.assert_array_equal(teng.infer([x])[0], ref)   # two chunks
    np.testing.assert_allclose(teng.infer([x[:5]])[0], ref[:5], rtol=RTOL,
                               atol=ATOL)


def _unsuitable(pkg, case):
    if case == 'not a module':
        return object()
    if case == 'a Module subclass':
        class Sub(pkg.mod.Module):
            pass
        mod = Sub(_mlp(pkg), context=pkg.cpu())
        mod.bind(data_shapes=[('data', (4, 10))], for_training=False)
        mod.init_params()
        return mod
    mod = pkg.mod.Module(_mlp(pkg), context=pkg.cpu())
    if case == 'bound, no parameters':
        mod.bind(data_shapes=[('data', (4, 10))], for_training=False)
    return mod


@pytest.mark.parametrize('case,error', [
    ('not a module', ValueError), ('a Module subclass', ValueError),
    ('unbound', AssertionError), ('bound, no parameters', AssertionError)])
def test_engines_reject_the_same_modules(case, error):
    with pytest.raises(error) as jerr:
        JEngine(_unsuitable(mx, case))
    with pytest.raises(error) as terr:
        ServingEngine(_unsuitable(mt, case))
    assert str(terr.value) == str(jerr.value)


def test_a_training_bound_module_is_served_by_both():
    """Neither engine checks for_training: the forward runs in prediction."""
    for pkg, cls in ((mx, JEngine), (mt, ServingEngine)):
        mod = pkg.mod.Module(_mlp(pkg), context=pkg.cpu())
        mod.bind(data_shapes=[('data', (4, 10))],
                 label_shapes=[('softmax_label', (4,))])
        mod.init_params()
        assert cls(mod).infer([_rows(3)])[0].shape == (3, 4)


def test_from_checkpoint_defaults_to_the_card(mlp_ckpt):
    import torch
    if torch.cuda.is_available():
        pytest.skip('this machine has a card; the default context is valid')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        ServingEngine.from_checkpoint(mlp_ckpt, 1, [('data', (10,))])


# requests queued before start(): 1+2+3+2 rows fill bucket 8, then 3+4 = 7
# rows take bucket 8 with one pad row
BATCHER_SIZES = (1, 2, 3, 2, 3, 4)
SERVE_COUNTERS = ('serve.requests', 'serve.dispatches', 'serve.rows',
                  'serve.pad_rows', 'serve.errors')


def _drive(batcher_cls, engine, xs):
    b = batcher_cls(engine, max_wait_ms=200)
    futs = [b.submit([x]) for x in xs]
    b.start()
    try:
        outs = [f.result(timeout=WAIT) for f in futs]
    finally:
        b.close()
    return outs, list(b.dispatch_log)


def test_batchers_answer_and_count_alike(tele, engines):
    jeng, teng = engines
    xs = [_rows(n, seed=10 + i) for i, n in enumerate(BATCHER_SIZES)]
    jout, jlog = _drive(JBatcher, jeng, xs)
    tout, tlog = _drive(DynamicBatcher, teng, xs)
    assert tlog == jlog == [(8, 8, 4), (7, 8, 2)]
    for x, j, t in zip(xs, jout, tout):
        assert t[0].shape == j[0].shape == (len(x), 4)
        np.testing.assert_allclose(t[0], j[0], rtol=RTOL, atol=ATOL)
    js, ts = jtele.snapshot(), ttele.snapshot()
    for name in SERVE_COUNTERS:
        assert ts['counters'].get(name) == js['counters'].get(name), name
    for name in ('serve.batch_size', 'serve.batch_size_p50',
                 'serve.pad_fraction', 'serve.queue_depth'):
        assert ts['gauges'][name] == js['gauges'][name], name
    for name in ('serve.request_latency', 'serve.queue_wait'):
        assert ts['histograms'][name]['count'] == \
            js['histograms'][name]['count'] == len(xs)
    assert ts['counters']['serve.rows'] == 15
    assert ts['counters']['serve.pad_rows'] == 1


def test_no_build_after_warmup(tele, mlp_ckpt):
    teng = ServingEngine.from_checkpoint(mlp_ckpt, 1, [('data', (10,))],
                                         max_batch=8, context=mt.cpu())
    assert teng.warmup() == 4
    snap = ttele.snapshot()
    assert snap['histograms']['serve.build']['count'] == 4
    assert snap['gauges']['serve.buckets_warm'] == 4
    rng = np.random.RandomState(3)
    xs = [_rows(int(n), seed=int(n)) for n in rng.randint(1, 9, 12)]
    xs.append(_rows(21))                            # chunked 8 + 8 + 5
    b = DynamicBatcher(teng, max_wait_ms=2).start()
    try:
        outs = [f.result(timeout=WAIT) for f in [b.submit([x]) for x in xs]]
    finally:
        b.close()
    assert [o[0].shape[0] for o in outs] == [len(x) for x in xs]
    snap = ttele.snapshot()
    assert snap['histograms']['serve.build']['count'] == 4
    assert snap['counters']['serve.requests'] == len(xs)
    assert snap['gauges']['serve.request_latency_p99_ms'] > 0


def test_batcher_errors_close_and_drain(tele, engines):
    _, teng = engines
    b = DynamicBatcher(teng, max_wait_ms=1000)
    with pytest.raises(ValueError, match='per-example shape'):
        b.submit([np.zeros((2, 9), np.float32)])
    fut = b.submit([_rows(2)])
    b.start()
    b.close()                       # drain: the queued answer still lands
    assert fut.result(timeout=WAIT)[0].shape == (2, 4)
    with pytest.raises(RuntimeError, match='closed'):
        b.submit([_rows(2)])
    # a failing dispatch answers each of its passengers with the error
    b = DynamicBatcher(teng, max_wait_ms=200)
    good = teng._programs.get(4)

    def boom(*a):
        raise RuntimeError('injected dispatch failure')
    teng._programs[4] = boom
    try:
        futs = [b.submit([_rows(1)]), b.submit([_rows(2)])]
        b.start()
        for f in futs:
            with pytest.raises(RuntimeError, match='injected'):
                f.result(timeout=WAIT)
    finally:
        b.close()
        if good is None:
            teng._programs.pop(4)
        else:
            teng._programs[4] = good
    assert ttele.snapshot()['counters']['serve.errors'] == 2


def test_refresh_params(mlp_ckpt):
    teng = ServingEngine.from_checkpoint(mlp_ckpt, 1, [('data', (10,))],
                                         max_batch=4, context=mt.cpu())
    x = _rows(3)
    before = teng.infer([x])[0]
    args, aux = teng.module.get_params()
    teng.module.set_params({n: a * 0 for n, a in args.items()}, aux)
    np.testing.assert_array_equal(teng.infer([x])[0], before)   # cached
    teng.refresh_params()
    np.testing.assert_allclose(teng.infer([x])[0], 0.25)       # uniform


def test_head_under_force_pallas(monkeypatch, tmp_path):
    """The decoder's head as a served Module, D = 32, V = 64, both packages
    on their kernel branch (MXTPU_FORCE_PALLAS=1)."""
    monkeypatch.setenv('MXTPU_FORCE_PALLAS', '1')
    _reload()
    rng = np.random.RandomState(0)
    mod = mx.mod.Module(_head(mx), label_names=[], context=mx.cpu())
    mod.bind(data_shapes=[('data', (4, 32))], for_training=False)
    mod.init_params(arg_params={
        'ln_gamma': mx.nd.array(1 + 0.1 * rng.randn(32)),
        'ln_beta': mx.nd.array(0.1 * rng.randn(32)),
        'head_weight': mx.nd.array(0.2 * rng.randn(64, 32))})
    prefix = str(tmp_path / 'head')
    mod.save_checkpoint(prefix, 0)
    jeng = JEngine.from_checkpoint(prefix, 0, [('data', (32,))], max_batch=4)
    teng = ServingEngine.from_checkpoint(prefix, 0, [('data', (32,))],
                                         max_batch=4, context=mt.cpu())
    assert teng.describe() == jeng.describe()
    x = (3 + 2 * rng.randn(7, 32)).astype(np.float32)
    want, got = jeng.infer([x])[0], teng.infer([x])[0]
    assert got.shape == want.shape == (7, 64)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.sum(-1), 1, rtol=RTOL)
