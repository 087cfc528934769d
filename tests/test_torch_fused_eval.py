"""The port's fused eval window (``mxnet_tpu_torch/module/fused_eval.py``)
against the JAX package's (``mxnet_tpu/module/fused_eval.py``) and against
the port's own per-batch loops.

Each case runs ``score``, ``predict`` or ``iter_predict`` on the same net
with the same parameters (drawn with numpy from a seed) over the same
NDArrayIter batches, W = 4 on both sides: the port with the window (its
default), the JAX package with its window (its default on the CPU), and the
port with ``MXTPU_FUSED_EVAL=0``. Metric values, the batch_end_callback's
``(nbatch, value)`` trajectory and the outputs are held to 1e-5 (1e-6 for
the metrics, whose sums are exact but for the CE's logs). The net is the
JAX test's MLP (10 -> 32 -> relu -> classes under SoftmaxOutput), batch 8,
bound for prediction. Each JAX run happens once and is shared between the
tests through a module-scoped cache.

The cases port those of the JAX package's ``tests/unittest/
test_fused_eval.py`` that need no mesh: score in statistics mode (acc, ce)
and in stacked-output mode (mse), a composite with top-k, predict merged
and not, a padded batch inside a window, iter_predict's pads and batch
numbers, num_batch remainders, column labels, top-k above the class count,
a width-1 output, the gates, the loop's cache, an iterator that reuses its
buffers, and score as fit's validation pass.
"""
import contextlib
import os

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.module.fused_eval import FusedEvalLoop

TOL = 1e-5
MTOL = 1e-6
BATCH, FEATURES = 8, 10
WINDOW_FLAGS = ('MXTPU_FUSED_FIT', 'MXTPU_FUSED_EVAL',
                'MXTPU_FIT_STEPS_PER_CALL', 'MXTPU_EVAL_STEPS_PER_CALL',
                'MXTPU_FUSED_FIT_PREFETCH', 'MXTPU_FUSED_EVAL_PREFETCH',
                'MXTPU_SHARDED_UPDATE', 'MXTPU_GRAD_COMPRESS',
                'MXTPU_HEALTH', 'MXTPU_DYNAMICS', 'MXTPU_TELEMETRY',
                'MXTPU_CKPT_DIR', 'MXTPU_FAULT_INJECT', 'MXTPU_HEALTH_ACTION',
                'MXTPU_CKPT_EVERY', 'MXTPU_CKPT_ASYNC', 'MXTPU_CKPT_RESUME',
                'MXTPU_CKPT_KEEP', 'MXTPU_FAULT_HOST')


@pytest.fixture(autouse=True)
def _clean_flags(monkeypatch):
    for name in WINDOW_FLAGS:
        monkeypatch.delenv(name, raising=False)
    mt.config.flags.reload()
    yield
    mt.config.flags.reload()


@contextlib.contextmanager
def _eval_flag(on):
    old = os.environ.get('MXTPU_FUSED_EVAL')
    os.environ['MXTPU_FUSED_EVAL'] = '1' if on else '0'
    mt.config.flags.reload()
    try:
        yield
    finally:
        if old is None:
            os.environ.pop('MXTPU_FUSED_EVAL', None)
        else:
            os.environ['MXTPU_FUSED_EVAL'] = old
        mt.config.flags.reload()


def _symbol(pkg, classes, hidden=32):
    S = pkg.sym
    h = S.FullyConnected(S.var('data'), num_hidden=hidden, name='fc1')
    h = S.Activation(h, act_type='relu')
    out = S.FullyConnected(h, num_hidden=classes, name='fc2')
    return S.SoftmaxOutput(out, name='softmax')


def _arrays(n, classes, column=False, seed=7):
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, FEATURES)).astype(np.float32)
    y = rng.randint(0, classes, n).astype(np.float32)
    return X, (y.reshape(-1, 1) if column else y)


def _module(pkg, n=56, classes=4, column=False, for_training=False,
            cls=None, ctx=None):
    X, y = _arrays(n, classes, column)
    it = pkg.io.NDArrayIter(X, y, batch_size=BATCH, shuffle=False,
                            label_name='softmax_label')
    sym = _symbol(pkg, classes)
    mod = (cls or pkg.mod.Module)(sym, context=ctx or pkg.cpu())
    mod.bind(it.provide_data, it.provide_label, for_training=for_training)
    rng = np.random.RandomState(1)
    shapes, _, _ = sym.infer_shape(data=(BATCH, FEATURES))
    vals = {k: (0.5 * rng.standard_normal(s)).astype(np.float32)
            for k, s in sorted(zip(sym.list_arguments(), shapes))
            if k not in ('data', 'softmax_label')}
    mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                for k, v in vals.items()})
    return mod, it


def _metric(pkg, key):
    if key == 'comp':
        m = pkg.metric.CompositeEvalMetric()
        m.add('acc')
        m.add(pkg.metric.TopKAccuracy(top_k=3))
        m.add('ce')
        return m
    if key == 'topk':
        return pkg.metric.TopKAccuracy(top_k=3)
    if key == 'topk5':
        return pkg.metric.TopKAccuracy(top_k=5)
    return pkg.metric.create(key)


def _score(pkg, fused, metric, num_batch=None, **mod_kw):
    """(name/values, [(nbatch, values)] at each batch end, the metric's
    num_inst, the module)."""
    with _eval_flag(fused):
        mod, it = _module(pkg, **mod_kw)
        m = _metric(pkg, metric)
        seen = []
        res = mod.score(it, m, num_batch=num_batch,
                        batch_end_callback=lambda p: seen.append(
                            (p.nbatch, tuple(v for _, v in
                                             p.eval_metric.get_name_value()))))
        leaves = m.metrics if hasattr(m, 'metrics') else [m]
        return res, seen, [c.num_inst for c in leaves], mod


def _predict(pkg, fused, merge=True, num_batch=None, **mod_kw):
    with _eval_flag(fused):
        mod, it = _module(pkg, **mod_kw)
        out = mod.predict(it, merge_batches=merge, num_batch=num_batch)
        if merge:
            return [out.asnumpy()], mod
        return [o.asnumpy() for outs in out for o in outs], mod


def _iter_predict(pkg, fused, **mod_kw):
    with _eval_flag(fused):
        mod, it = _module(pkg, **mod_kw)
        return [(nb, [o.asnumpy() for o in outs], b.pad)
                for outs, nb, b in mod.iter_predict(it)], mod


@pytest.fixture(scope='module')
def jax_runs():
    """The JAX package's windowed runs, each once in this module."""
    memo = {}

    def get(fn, *args, **kw):
        k = (fn.__name__, args, tuple(sorted(kw.items())))
        if k not in memo:
            memo[k] = fn(mx, True, *args, **kw)
        return memo[k]
    return get


def _windows(mod):
    return {k: v[1].windows
            for k, v in mod.__dict__.get('_fused_eval_cache', {}).items()}


def _assert_scores(got, want):
    (res_g, seen_g, inst_g, _), (res_w, seen_w, inst_w, _) = got, want
    assert [n for n, _ in res_g] == [n for n, _ in res_w]
    np.testing.assert_allclose([v for _, v in res_g], [v for _, v in res_w],
                               rtol=MTOL, atol=1e-7)
    assert [n for n, _ in seen_g] == [n for n, _ in seen_w]
    np.testing.assert_allclose([v for _, v in seen_g],
                               [v for _, v in seen_w], rtol=MTOL, atol=1e-7)
    assert inst_g == inst_w


def _check_score(jax_runs, metric, windows, **kw):
    got = _score(mt, True, metric, **kw)
    assert _windows(got[3]) == {'score': windows}
    _assert_scores(got, jax_runs(_score, metric, **kw))
    _assert_scores(got, _score(mt, False, metric, **kw))
    return got


@pytest.mark.parametrize('metric', ['acc', 'ce', 'mse'])
def test_score_matches_jax_and_per_batch(jax_runs, metric):
    """Statistics mode (acc, ce: one fetch a window) and stacked-output mode
    (mse, whose update runs on the host): the value and the per-batch
    trajectory, 7 batches (a window and a tail of 3)."""
    got = _check_score(jax_runs, metric, 1)
    assert [n for n, _ in got[1]] == list(range(7))
    loop = got[3].__dict__['_fused_eval_cache']['score'][1]
    assert (loop.stat_fns is None) == (metric == 'mse')
    assert loop.fetches == 1


def test_score_composite_and_topk(jax_runs):
    _check_score(jax_runs, 'comp', 1, n=48, classes=6)


@pytest.mark.parametrize('merge', [True, False])
def test_predict_matches_jax_and_per_batch(jax_runs, merge):
    """Merged or per batch; the windowed outputs come back on the host."""
    got, mod = _predict(mt, True, merge)
    assert _windows(mod) == {'predict': 1}
    for ref in (jax_runs(_predict, merge)[0], _predict(mt, False, merge)[0]):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=TOL, atol=1e-6)


def test_predict_pad_inside_a_window(jax_runs):
    """60 samples, 8 batches, the last padded by 4: with W = 4 the padded
    batch lands inside a window, and its pad rows are trimmed as the
    per-batch loop trims them."""
    got, _ = _predict(mt, True, n=60)
    for ref in (jax_runs(_predict, n=60)[0], _predict(mt, False, n=60)[0]):
        assert got[0].shape == ref[0].shape == (60, 4)
        np.testing.assert_allclose(got[0], ref[0], rtol=TOL, atol=1e-6)


def test_iter_predict_pads_and_batch_numbers(jax_runs):
    got, _ = _iter_predict(mt, True, n=60)
    for ref in (jax_runs(_iter_predict, n=60)[0],
                _iter_predict(mt, False, n=60)[0]):
        assert [(i[0], i[2]) for i in got] == [(i[0], i[2]) for i in ref]
        for (_, outs_g, _), (_, outs_r, _) in zip(got, ref):
            for a, b in zip(outs_g, outs_r):
                assert a.shape == b.shape
                np.testing.assert_allclose(a, b, rtol=TOL, atol=1e-6)
    assert got[-1][2] == 4


@pytest.mark.parametrize('num_batch', [2, 5, 7, 100])
def test_num_batch_remainders(jax_runs, num_batch):
    """num_batch under a window (all tail), inside the second window, at a
    window and a tail, and past the end: score and predict stop where the
    per-batch loop stops."""
    kw = dict(n=64, num_batch=num_batch)
    got = _score(mt, True, 'acc', **kw)
    _assert_scores(got, jax_runs(_score, 'acc', **kw))
    _assert_scores(got, _score(mt, False, 'acc', **kw))
    out, _ = _predict(mt, True, **kw)
    for ref in (jax_runs(_predict, **kw)[0], _predict(mt, False, **kw)[0]):
        assert out[0].shape == ref[0].shape
        np.testing.assert_allclose(out[0], ref[0], rtol=TOL, atol=1e-6)


@pytest.mark.parametrize('metric', ['acc', 'topk', 'ce'])
def test_score_column_labels(jax_runs, metric):
    """(N, 1) column labels: every metric ravels the label, and so do the
    statistics (num_inst 56, not 8 x 8 a batch)."""
    got = _check_score(jax_runs, metric, 1, column=True)
    assert got[2] == [56]


def test_score_topk_above_the_class_count(jax_runs):
    """top_k = 5 over 3 classes: the metric takes min(classes, k), and so
    do the statistics."""
    _check_score(jax_runs, 'topk5', 1, classes=3)


def test_width1_output_takes_stacked_output_mode(jax_runs):
    """A (N, 1) output: Accuracy compares raw values without the argmax,
    so the statistics decline and the window stacks the outputs for the
    metric's own update on the host."""
    got = _check_score(jax_runs, 'acc', 1, classes=1)
    assert got[3].__dict__['_fused_eval_cache']['score'][1].stat_fns is None


def test_gates_give_the_per_batch_loop(monkeypatch):
    """The flag off, a Module subclass and two contexts decline (build
    None) and score answers through the per-batch loop as before."""
    mod, it = _module(mt, for_training=True)
    assert FusedEvalLoop.build(mod, mt.metric.create('acc')) is not None
    assert FusedEvalLoop.build(mod, None) is not None
    monkeypatch.setenv('MXTPU_FUSED_EVAL', '0')
    assert FusedEvalLoop.build(mod, mt.metric.create('acc')) is None
    monkeypatch.setenv('MXTPU_FUSED_EVAL', '1')

    class MyModule(mt.mod.Module):
        pass
    sub, it2 = _module(mt, cls=MyModule)
    two, it3 = _module(mt, ctx=[mt.cpu(0), mt.cpu(1)])
    want = mod.score(it, 'acc')
    for m, i in ((sub, it2), (two, it3)):
        assert FusedEvalLoop.build(m, mt.metric.create('acc')) is None
        assert FusedEvalLoop.build_cached(m, None) is None
        np.testing.assert_allclose([v for _, v in m.score(i, 'acc')],
                                   [v for _, v in want], rtol=MTOL)
        assert '_fused_eval_cache' not in m.__dict__


def test_loop_cached_across_calls(monkeypatch):
    """score and predict reuse their loops and programs; an equal-config
    fresh metric rebinds into the cached loop; another configuration builds
    anew; score and predict cache apart; the flag off drops the cache."""
    mod, it = _module(mt)
    mod.score(it, 'acc')
    _, loop_a = mod.__dict__['_fused_eval_cache']['score']
    progs = [id(p) for p, _ in loop_a._programs.values()]
    assert len(progs) == 1
    m2 = mt.metric.create('acc')
    mod.score(it, m2)
    _, loop_b = mod.__dict__['_fused_eval_cache']['score']
    assert loop_b is loop_a and loop_b.children == [m2]
    assert [id(p) for p, _ in loop_b._programs.values()] == progs
    assert m2.num_inst == 56
    mod.score(it, mt.metric.TopKAccuracy(top_k=3))
    assert mod.__dict__['_fused_eval_cache']['score'][1] is not loop_a
    mod.predict(it)
    cache = mod.__dict__['_fused_eval_cache']
    assert set(cache) == {'score', 'predict'}
    loop_p = cache['predict'][1]
    mod.predict(it)
    assert cache['predict'][1] is loop_p and loop_p.windows == 2
    monkeypatch.setenv('MXTPU_FUSED_EVAL', '0')
    mod.score(it, 'acc')
    assert '_fused_eval_cache' not in mod.__dict__


class _ReusingIter:
    """Yields the same DataBatch and NDArrays every batch, writing each
    batch into the tensors in place."""

    def __init__(self, X, Y):
        self.X, self.Y = X, Y
        self._data = mt.nd.zeros((BATCH, X.shape[1]), ctx=mt.cpu())
        self._label = mt.nd.zeros((BATCH,), ctx=mt.cpu())
        self._b = mt.io.DataBatch(data=[self._data], label=[self._label],
                                  pad=0)
        self.provide_data = [mt.io.DataDesc('data', (BATCH, X.shape[1]))]
        self.provide_label = [mt.io.DataDesc('softmax_label', (BATCH,))]
        self.batch_size = BATCH
        self._i = 0

    def __iter__(self):
        return self

    def reset(self):
        self._i = 0

    def __next__(self):
        if (self._i + 1) * BATCH > len(self.X):
            raise StopIteration
        sl = slice(self._i * BATCH, (self._i + 1) * BATCH)
        self._data.handle.copy_(mt.nd.array(self.X[sl], ctx=mt.cpu()).handle)
        self._label.handle.copy_(mt.nd.array(self.Y[sl], ctx=mt.cpu()).handle)
        self._i += 1
        return self._b

    next = __next__


def test_buffer_reusing_iterator():
    """Each batch is copied at draw time, so the stacked-output score's
    deferred update and the stacked outputs see each batch's own values;
    the reference is the per-batch loop on a fresh-buffer iterator."""
    mod, it = _module(mt)
    X, y = _arrays(56, 4)
    reusing = _ReusingIter(X, y)
    got = mod.score(reusing, 'mse'), mod.predict(reusing).asnumpy()
    with _eval_flag(False):
        want = mod.score(it, 'mse'), mod.predict(it).asnumpy()
    np.testing.assert_allclose([v for _, v in got[0]],
                               [v for _, v in want[0]], rtol=MTOL)
    np.testing.assert_allclose(got[1], want[1], rtol=TOL, atol=1e-6)


def test_validation_score_inside_fit():
    """fit(eval_data=...) scores the validation set through the eval window
    while the fit window trains: both caches sit on the module, and the
    validation metric equals a per-batch score of the same state."""
    mod, it = _module(mt, n=64, for_training=True)
    _, val = _module(mt, n=32)
    mod.fit(it, eval_data=val, num_epoch=1, optimizer='sgd',
            optimizer_params={'learning_rate': 0.1}, eval_metric='acc')
    assert '_fused_fit_cache' in mod.__dict__
    assert _windows(mod) == {'score': 1}
    fused = mod.score(val, 'acc')
    with _eval_flag(False):
        ref = mod.score(val, 'acc')
    np.testing.assert_allclose([v for _, v in fused], [v for _, v in ref],
                               rtol=MTOL)
