"""The training loop's telemetry in the port (``module/base_module.py``,
``fused_fit.py``, ``fused_eval.py``, ``window_pipeline.py``, the executor,
the executor group, ``Module.update``, ``io``, ``kvstore`` and
``callback.Speedometer``) against the JAX package's on the CPU.

A small MLP with a BatchNorm (6 -> 8 -> BN -> relu -> 4 classes under
SoftmaxOutput, batch 8, 5 batches an epoch, 2 epochs with a validation
score each, then predict and iter_predict), fitted through both packages
with telemetry on from the same parameters (drawn with numpy from a seed),
in the per-batch loop and in the fused windows (W = 4, a tail of one):

- the span names and each span's count, the counters' names and values and
  the loops' gauges equal the JAX package's, restricted to the planes the
  port has (the JAX package's ``xla.*``, ``program.*`` and ``update.*``
  are its XLA-bound planes);
- the port's parameters after the fit are the same bit for bit with
  telemetry on and off, and within 1e-5 of the JAX package's (the bound of
  ``tests/test_torch_module.py``);
- the Speedometer's gauge is set and its log line is the JAX package's;
- the watchdog is suspended after fit and after each eval pass;
- the kvstore's spans and byte counters, and PrefetchingIter's wait
  histogram, equal the JAX package's for the same pushes, pulls and
  batches.
"""
import logging
import re

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

TOL = 1e-5
BATCH, N = 8, 40
FLAGS = ('MXTPU_TELEMETRY', 'MXTPU_TELEMETRY_PATH', 'MXTPU_FUSED_FIT',
         'MXTPU_FUSED_EVAL', 'MXTPU_WATCHDOG_SECS', 'MXTPU_TIMELINE',
         'MXTPU_FIT_STEPS_PER_CALL', 'MXTPU_EVAL_STEPS_PER_CALL')
# the JAX package's planes that the port does not have
JAX_ONLY = ('xla.', 'program.', 'update.')


def _reset(monkeypatch, **env):
    for name in FLAGS:
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for pkg in (mx, mt):
        pkg.config.flags.reload()
        pkg.telemetry._reset_for_tests()


@pytest.fixture
def clean(monkeypatch):
    _reset(monkeypatch)
    yield monkeypatch
    _reset(monkeypatch)


def _symbol(pkg):
    S = pkg.sym
    h = S.FullyConnected(S.var('data'), num_hidden=8, no_bias=True,
                         name='fc1')
    h = S.Activation(S.BatchNorm(h, name='bn1'), act_type='relu')
    return S.SoftmaxOutput(S.FullyConnected(h, num_hidden=4, name='fc2'),
                           name='softmax')


def _values(sym):
    rng = np.random.RandomState(1)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(BATCH, 6))
    a = {}
    for k, shape in sorted(zip(sym.list_arguments(), arg_shapes)):
        if k in ('data', 'softmax_label'):
            continue
        a[k] = ((0.3 * rng.standard_normal(shape)) if k.endswith('_weight')
                else np.full(shape, 1.0 if k.endswith('_gamma') else 0.0)
                ).astype(np.float32)
    x = {k: np.full(shape, 1.0 if k.endswith('_var') else 0.0, np.float32)
         for k, shape in zip(sym.list_auxiliary_states(), aux_shapes)}
    return a, x


def _iter(pkg):
    rng = np.random.RandomState(0)
    X = rng.standard_normal((N, 6)).astype(np.float32)
    y = rng.randint(0, 4, N).astype(np.float32)
    return pkg.io.NDArrayIter(X, y, batch_size=BATCH)


def _fit(pkg, callbacks=()):
    """The fit, its validation scores, predict and iter_predict; returns the
    parameters and aux states after the fit."""
    it = _iter(pkg)
    sym = _symbol(pkg)
    mod = pkg.mod.Module(sym, context=pkg.cpu())
    mod.bind(it.provide_data, it.provide_label)
    a, x = _values(sym)
    mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                for k, v in a.items()},
                    aux_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                for k, v in x.items()})
    mod.fit(it, eval_data=it, num_epoch=2, optimizer='sgd',
            optimizer_params=(('learning_rate', 0.1), ('momentum', 0.9)),
            eval_metric='acc', batch_end_callback=list(callbacks))
    args, aux = mod.get_params()
    state = {k: v.asnumpy() for k, v in list(args.items()) +
             list(aux.items())}
    mod.predict(it)
    assert len(list(mod.iter_predict(it))) == N // BATCH
    return state


def _loop_env(fused):
    flag = '1' if fused else '0'
    return dict(MXTPU_FUSED_FIT=flag, MXTPU_FUSED_EVAL=flag)


def _ours(snap):
    """A snapshot without the JAX package's XLA-bound planes."""
    return {kind: {k: v for k, v in vals.items()
                   if not k.startswith(JAX_ONLY)}
            for kind, vals in snap.items()}


@pytest.mark.parametrize('fused', [False, True], ids=['per_batch', 'window'])
def test_names_and_counts_match_jax(clean, tmp_path, fused):
    states, snaps = {}, {}
    for pkg in (mx, mt):
        _reset(clean, MXTPU_TELEMETRY='1',
               MXTPU_TELEMETRY_PATH=str(tmp_path / (pkg.__name__ + '.jsonl')),
               **_loop_env(fused))
        states[pkg] = _fit(pkg, [pkg.callback.Speedometer(BATCH, 2)])
        snaps[pkg] = _ours(pkg.telemetry.snapshot())
    j, t = snaps[mx], snaps[mt]
    assert sorted(t['histograms']) == sorted(j['histograms'])
    assert {k: v['count'] for k, v in t['histograms'].items()} == \
        {k: v['count'] for k, v in j['histograms'].items()}
    assert t['counters'] == j['counters']
    assert sorted(t['gauges']) == sorted(j['gauges'])
    c = t['counters']
    assert c['fit.steps'] == 2 * N // BATCH and c['fit.epochs'] == 2
    # each epoch's score and the predict and iter_predict passes
    assert c['eval.batches'] == 4 * N // BATCH
    assert c['io.batches'] == 6 * N // BATCH
    if fused:
        assert c['fused_fit.windows'] == 2 and c['fused_eval.windows'] == 4
        assert t['gauges']['fused_fit.steps_per_call'] == 4
        assert t['histograms']['fused_fit.overlap_ms']['count'] == 2
    else:
        assert 'fused_fit.windows' not in c
        assert t['histograms']['fit.batch']['count'] == 2 * N // BATCH
    assert t['gauges']['speedometer.samples_per_sec'] > 0
    assert t['gauges']['eval_samples_per_sec'] > 0
    for k, want in states[mx].items():
        np.testing.assert_allclose(states[mt][k], want, rtol=TOL, atol=TOL,
                                   err_msg=k)


@pytest.mark.parametrize('fused', [False, True], ids=['per_batch', 'window'])
def test_params_bit_for_bit_with_telemetry_on_and_off(clean, tmp_path,
                                                      fused):
    _reset(clean, MXTPU_TIMELINE='1', **_loop_env(fused))
    off = _fit(mt)
    assert not mt.telemetry.enabled()
    _reset(clean, MXTPU_TELEMETRY='1', MXTPU_TIMELINE='1',
           MXTPU_TELEMETRY_PATH=str(tmp_path / 't.jsonl'), **_loop_env(fused))
    on = _fit(mt)
    assert mt.telemetry.snapshot()['counters']['fit.steps'] == 10
    assert sorted(on) == sorted(off)
    for k in off:
        assert np.array_equal(on[k], off[k]), k


def _speed_lines(pkg, caplog):
    caplog.clear()
    with caplog.at_level(logging.INFO):
        _fit(pkg, [pkg.callback.Speedometer(BATCH, 2)])
    return [re.sub(r'\d+\.\d+', 'X', r.getMessage())
            for r in caplog.records if 'Speed:' in r.getMessage()]


def test_speedometer_gauge_and_log_line(clean, tmp_path, caplog):
    """The gauge mirrors the logged rate; the log line is the JAX
    package's, number for number in its format."""
    lines = {}
    for pkg in (mx, mt):
        _reset(clean, MXTPU_TELEMETRY='1', MXTPU_FUSED_FIT='0',
               MXTPU_TELEMETRY_PATH=str(tmp_path / (pkg.__name__ + '.jsonl')))
        lines[pkg] = _speed_lines(pkg, caplog)
    assert lines[mt] == lines[mx]
    assert lines[mt][0] == 'Epoch[0] Batch [2]\tSpeed: X samples/sec\t' \
        'accuracy=X'
    g = mt.telemetry.snapshot()['gauges']['speedometer.samples_per_sec']
    assert g > 0
    # telemetry off: the same lines, no gauge
    _reset(clean, MXTPU_FUSED_FIT='0')
    assert _speed_lines(mt, caplog) == lines[mx]
    assert mt.telemetry.snapshot()['gauges'] == {}


@pytest.mark.parametrize('fused', [False, True], ids=['per_batch', 'window'])
def test_watchdog_suspended_after_fit(clean, tmp_path, fused):
    from mxnet_tpu_torch.telemetry import watchdog
    _reset(clean, MXTPU_WATCHDOG_SECS='600', **_loop_env(fused))
    _fit(mt)
    assert watchdog._state.marks >= 2 * N // BATCH
    assert watchdog._state.last_mark is None      # suspended
    assert watchdog.hang_info() is None


def test_kvstore_and_prefetch_match_jax(clean, tmp_path):
    snaps = {}
    for pkg in (mx, mt):
        _reset(clean, MXTPU_TELEMETRY='1',
               MXTPU_TELEMETRY_PATH=str(tmp_path / (pkg.__name__ + '.jsonl')))
        kv = pkg.kv.create('local')
        shapes = {'w': (3, 4), 'b': (5,)}
        kv.init(list(shapes), [pkg.nd.zeros(s, ctx=pkg.cpu())
                               for s in shapes.values()])
        for _ in range(2):
            kv.push(list(shapes), [[pkg.nd.ones(s, ctx=pkg.cpu())] * 2
                                   for s in shapes.values()])
        outs = [pkg.nd.zeros(s, ctx=pkg.cpu()) for s in shapes.values()]
        kv.pull(list(shapes), out=outs)
        assert outs[0].asnumpy().sum() == 24.0
        it = pkg.io.PrefetchingIter(_iter(pkg))
        assert len(list(it)) == N // BATCH
        snaps[pkg] = _ours(pkg.telemetry.snapshot())
    j, t = snaps[mx], snaps[mt]
    assert t['counters'] == j['counters']
    assert t['counters']['kvstore.push_bytes'] == 2 * 2 * (12 + 5) * 4
    assert t['counters']['kvstore.pull_bytes'] == (12 + 5) * 4
    assert {k: v['count'] for k, v in t['histograms'].items()} == \
        {k: v['count'] for k, v in j['histograms'].items()} == \
        {'kvstore.push': 2, 'kvstore.pull': 1,
         'io.prefetch_wait': N // BATCH + 1}
