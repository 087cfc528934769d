"""The port's Monitor (mxnet_tpu_torch.monitor) and its wiring through
Module and BucketingModule against the JAX package's, on the CPU.

- ``Module.fit(..., monitor=Monitor(...))``: every row (step, name, stat)
  of every batch against the JAX fit's from the same parameters, the RMS
  stats within rtol 1e-5 (f32, sums in another order), steps and names
  exact; both take the per-batch loop;
- ``Monitor.nan_watch``: the rows flag a poisoned weight with the same
  text as the JAX package's;
- a list of stat functions: the same rows as the JAX package's;
- a monitor installed before ``fit`` keeps the fused window out (the
  per-batch loop calls it each batch; no window is built or cached), and
  one installed between two fits drops the cached window;
- BucketingModule: buckets made after ``install_monitor`` get it too, and
  their rows match the JAX package's.
"""
import logging

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    for flag in ('MXTPU_FUSED_FIT', 'MXTPU_FUSED_EVAL'):
        monkeypatch.delenv(flag, raising=False)
        mt.config.flags.reload(flag)
    with mt.cpu():
        yield
    for flag in ('MXTPU_FUSED_FIT', 'MXTPU_FUSED_EVAL'):
        mt.config.flags.reload(flag)


def _net(lib):
    S = lib.sym
    x = S.var('data')
    h = S.Activation(S.FullyConnected(x, num_hidden=8, name='fc1'),
                     act_type='tanh', name='act')
    return S.SoftmaxOutput(S.FullyConnected(h, num_hidden=3, name='fc2'),
                           name='softmax')


def _data(n=48, seed=0):
    r = np.random.RandomState(seed)
    X = r.randn(n, 5).astype(np.float32)
    Y = r.randint(0, 3, n).astype(np.float32)
    params = {'fc1_weight': 0.3 * r.randn(8, 5), 'fc1_bias': 0.1 * r.randn(8),
              'fc2_weight': 0.3 * r.randn(3, 8), 'fc2_bias': 0.1 * r.randn(3)}
    return X, Y, {k: v.astype(np.float32) for k, v in params.items()}


def _recording(lib):
    class Recording(lib.mon.Monitor):
        """A Monitor that keeps its rows as well as logging them."""
        rows = None

        def toc_print(self):
            rows = self.toc()
            self.rows = (self.rows or []) + rows
    return Recording


def _fit(lib, monitor, n=48, params=None, epochs=1):
    X, Y, init = _data(n)
    it = lib.io.NDArrayIter(X, Y, batch_size=16, label_name='softmax_label')
    mod = lib.mod.Module(_net(lib), context=lib.cpu())
    mod.fit(it, num_epoch=epochs, optimizer='sgd',
            optimizer_params={'learning_rate': 0.1},
            arg_params={k: lib.nd.array(v)
                        for k, v in (params or init).items()},
            monitor=monitor)
    return mod


def _assert_rows_match(trows, jrows):
    assert [(s, n) for s, n, _ in trows] == [(s, n) for s, n, _ in jrows]
    for (s, n, t), (_, _, j) in zip(trows, jrows):
        tv = [float(v) for v in t.split('\t') if v]
        jv = [float(v) for v in j.split('\t') if v]
        np.testing.assert_allclose(tv, jv, rtol=RTOL, err_msg='%d %s'
                                   % (s, n))


def test_fit_monitor_rows_match_jax():
    rows = {}
    for lib in (mx, mt):
        mon = _recording(lib)(1, pattern='.*')
        _fit(lib, mon)
        rows[lib] = mon.rows
    names = {n for _, n, _ in rows[mt]}
    assert {'fc1_output', 'act_output', 'fc2_output', 'softmax_output',
            'fc1_weight', 'data', 'softmax_label'} <= names
    assert len(rows[mt]) == 3 * (4 + 6)     # 3 batches: 4 ops, 6 arguments
    _assert_rows_match(rows[mt], rows[mx])


def test_monitor_interval_pattern_and_sort_match_jax():
    rows = {}
    for lib in (mx, mt):
        mon = _recording(lib)(2, pattern='fc.*', sort=True)
        _fit(lib, mon)
        rows[lib] = mon.rows
    assert {s for s, _, _ in rows[mt]} == {1, 3}
    _assert_rows_match(rows[mt], rows[mx])


def test_stat_function_list_matches_jax():
    stats = [lambda x: x.abs().max().asscalar(),
             lambda x: str(x.shape[0])]
    rows = {}
    for lib in (mx, mt):
        mon = _recording(lib)(1, stat_func=stats, pattern='.*output')
        _fit(lib, mon)
        rows[lib] = mon.rows
    # one row a function for each matched output
    names = [n for _, n, _ in rows[mt]]
    assert names[0::2] == names[1::2] and len(names) == 3 * 4 * 2
    _assert_rows_match(rows[mt], rows[mx])


def test_nan_watch_flags_a_poisoned_weight_like_jax():
    _, _, init = _data()
    bad = dict(init)
    bad['fc2_weight'] = bad['fc2_weight'].copy()
    bad['fc2_weight'][0, :2] = np.nan
    rows = {}
    for lib in (mx, mt):
        mon = _recording(lib).nan_watch(1, pattern='fc2.*|softmax.*')
        _fit(lib, mon, n=16, params=bad)
        rows[lib] = mon.rows
    assert rows[mt] == rows[mx]
    flagged = dict(((n, s) for _, n, s in rows[mt]))
    assert flagged['fc2_weight'].startswith('nan=')
    assert flagged['fc2_output'] != 'ok\t'


def test_monitor_before_fit_keeps_the_window_out():
    """W = 4 takes the 4 batches of an epoch into a window. A monitor
    installed between two fits (and not passed to fit) drops the cached
    window and leaves the batches to the per-batch loop, as in the JAX
    package; passed to fit too, it gives a row set every batch; score
    declines its window as well."""
    X, Y, init = _data(64)
    caches = {}
    for lib in (mx, mt):
        it = lib.io.NDArrayIter(X, Y, batch_size=16,
                                label_name='softmax_label')
        mod = lib.mod.Module(_net(lib), context=lib.cpu())
        kw = dict(optimizer='sgd', optimizer_params={'learning_rate': 0.1},
                  arg_params={k: lib.nd.array(v) for k, v in init.items()})
        mod.fit(it, num_epoch=1, **kw)
        first = mod.__dict__.get('_fused_fit_cache') is not None
        mon = _recording(lib)(1, pattern='.*output')
        mod.install_monitor(mon)
        it.reset()
        mod.fit(it, num_epoch=1, **kw)
        second = mod.__dict__.get('_fused_fit_cache') is not None
        it.reset()
        mod.fit(it, num_epoch=1, monitor=mon, **kw)
        mod.score(it, 'acc')
        caches[lib] = (first, second, mon.rows,
                       bool(mod.__dict__.get('_fused_eval_cache')))
    assert caches[mt][:2] == caches[mx][:2] == (True, False)
    assert caches[mt][3] is caches[mx][3] is False
    rows = caches[mt][2]
    assert sorted({s for s, _, _ in rows}) == [1, 2, 3, 4]
    assert len(rows) == 4 * 4
    _assert_rows_match(rows, caches[mx][2])


def _bucket_sym_gen(lib):
    def sym_gen(key):
        S = lib.sym
        x = S.var('data')
        h = S.FullyConnected(x, num_hidden=4, name='fc')
        return S.SoftmaxOutput(h, name='softmax'), ('data',), \
            ('softmax_label',)
    return sym_gen


def test_bucketing_late_buckets_get_the_monitor_like_jax():
    r = np.random.RandomState(3)
    w = (0.3 * r.randn(4, 6)).astype(np.float32)
    b = np.zeros(4, np.float32)
    x = {k: r.randn(2, 6).astype(np.float32) for k in (6, 3)}
    y = r.randint(0, 4, 2).astype(np.float32)
    rows = {}
    for lib in (mx, mt):
        bm = lib.mod.BucketingModule(_bucket_sym_gen(lib),
                                     default_bucket_key=6,
                                     context=lib.cpu())
        bm.bind([('data', (2, 6))], [('softmax_label', (2,))])
        bm.init_params(arg_params={'fc_weight': lib.nd.array(w),
                                   'fc_bias': lib.nd.array(b)})
        mon = lib.mon.Monitor(1, pattern='.*')
        bm.install_monitor(mon)
        out = []
        for key in (6, 3):
            batch = lib.io.DataBatch(
                [lib.nd.array(x[key])], [lib.nd.array(y)], bucket_key=key,
                provide_data=[('data', (2, 6))],
                provide_label=[('softmax_label', (2,))])
            mon.tic()
            bm.forward(batch, is_train=False)
            out += mon.toc()
        rows[lib] = out
        assert bm._buckets[3]._exec_group.execs[0]._monitor is not None
    assert len([r for r in rows[mt] if r[0] == 2]) > 0
    _assert_rows_match(rows[mt], rows[mx])


def test_toc_print_logs_rows(caplog):
    with caplog.at_level(logging.INFO):
        mon = mt.mon.Monitor(1, pattern='fc1.*')
        _fit(mt, mon, n=16)
    assert any('fc1_output' in m for m in caplog.messages)
