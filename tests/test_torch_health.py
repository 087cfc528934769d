"""The port's training-health and dynamics planes
(``mxnet_tpu_torch/telemetry/{health,dynamics}.py``) against the JAX
package's.

- ``health.step_stats`` and ``dynamics.step_stats`` on the same numpy
  arrays (jnp on one side, torch on the other), within 1e-6 relative: with
  and without the update's new parameters, without gradients, with a NaN
  output and an Inf gradient, and a bf16 weight;
- ``decode`` of the same rows is equal, and so are ``has_nonfinite`` and
  ``finite_report``;
- ``SpikeDetector`` flags the same anomalies on the same sequence;
- ``note_window`` and ``note_step`` give the same incident dicts (and the
  same counters), dynamics the same named-layer incidents and snapshot;
- the summary's "run health" block is the same text;
- the fused fit window with the sentinels on fetches as often as without
  them (its rows ride the statistics' one copy), and checks a row a step.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import telemetry as jtele
from mxnet_tpu.telemetry import dynamics as jdyn
from mxnet_tpu.telemetry import export as jexport
from mxnet_tpu.telemetry import health as jhealth
from mxnet_tpu_torch import telemetry as ttele
from mxnet_tpu_torch.telemetry import dynamics as tdyn
from mxnet_tpu_torch.telemetry import export as texport
from mxnet_tpu_torch.telemetry import health as thealth

RTOL = 1e-6
FLAGS = ('MXTPU_TELEMETRY', 'MXTPU_TELEMETRY_PATH', 'MXTPU_HEALTH',
         'MXTPU_HEALTH_ACTION', 'MXTPU_HEALTH_K', 'MXTPU_HEALTH_WINDOW',
         'MXTPU_DYNAMICS', 'MXTPU_SCALARS_EVERY', 'MXTPU_FUSED_FIT',
         'MXTPU_FIT_STEPS_PER_CALL', 'MXTPU_CKPT_DIR', 'MXTPU_FAULT_INJECT')


def _reset():
    for pkg in (mx, mt):
        pkg.config.flags.reload()
    jtele._reset_for_tests()
    ttele._reset_for_tests()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in FLAGS:
        monkeypatch.delenv(name, raising=False)
    _reset()
    yield
    for name in FLAGS:
        monkeypatch.delenv(name, raising=False)
    _reset()


@pytest.fixture
def planes_on(monkeypatch, tmp_path):
    """Telemetry with both planes on, action 'record' (incidents are
    returned, not raised)."""
    monkeypatch.setenv('MXTPU_TELEMETRY', '1')
    monkeypatch.setenv('MXTPU_TELEMETRY_PATH', str(tmp_path / 't.jsonl'))
    monkeypatch.setenv('MXTPU_HEALTH', '1')
    monkeypatch.setenv('MXTPU_HEALTH_ACTION', 'record')
    monkeypatch.setenv('MXTPU_DYNAMICS', '1')
    monkeypatch.setenv('MXTPU_SCALARS_EVERY', '2')
    _reset()
    assert jhealth.enabled() and thealth.enabled()
    assert jdyn.enabled() and tdyn.enabled()
    yield


def _arrays(seed, case):
    rng = np.random.RandomState(seed)
    shapes = [(16, 8), (8,), (4, 3, 5)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [rng.randn(*s).astype(np.float32) * 1e-2 for s in shapes]
    new = [p - 0.1 * g for p, g in zip(params, grads)]
    outs = [rng.rand(6, 4).astype(np.float32), np.maximum(
        rng.randn(6, 3), 0).astype(np.float32)]
    if case == 'nan_out':
        outs[1][2, 1] = np.nan
    if case == 'inf_grad':
        grads[0][3, 3] = np.inf
    return outs, grads, params, new


def _both(case, fn_j, fn_t):
    outs, grads, params, new = _arrays(1, case)
    j = lambda xs: [jnp.asarray(x) for x in xs]     # noqa: E731
    t = lambda xs: [torch.from_numpy(x.copy()) for x in xs]  # noqa: E731
    return np.asarray(fn_j(j, outs, grads, params, new)), \
        fn_t(t, outs, grads, params, new).numpy()


def _close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=RTOL, atol=0)


@pytest.mark.parametrize('case', ['update', 'proxy', 'no_grads', 'nan_out',
                                  'inf_grad'])
def test_health_step_stats_match(case):
    def call(mod, conv, outs, grads, params, new):
        if case == 'no_grads':
            return mod.step_stats(conv(outs))
        return mod.step_stats(conv(outs), grads=conv(grads),
                              params=conv(params),
                              new_params=None if case == 'proxy'
                              else conv(new))
    got, want = _both(case, lambda c, *a: call(jhealth, c, *a),
                      lambda c, *a: call(thealth, c, *a))
    _close(got, want)
    for row in (got, want):
        assert thealth.decode(row) == jhealth.decode(row)
    if case in ('nan_out', 'inf_grad'):
        assert got[0] == 0.0


@pytest.mark.parametrize('case', ['update', 'proxy', 'inf_grad'])
def test_dynamics_step_stats_match(case):
    def call(mod, conv, outs, grads, params, new):
        return mod.step_stats(conv(outs), conv(grads), conv(params),
                              new_params=None if case == 'proxy'
                              else conv(new))
    got, want = _both(case, lambda c, *a: call(jdyn, c, *a),
                      lambda c, *a: call(tdyn, c, *a))
    _close(got, want)
    names, outs = ['a', 'b', 'c'], ['o1', 'o2']
    for row in (got, want):
        assert tdyn.decode(row, names, outs) == jdyn.decode(row, names, outs)


def test_step_stats_of_a_bf16_weight():
    rng = np.random.RandomState(3)
    w = rng.randn(32, 16).astype(np.float32)
    g = rng.randn(32, 16).astype(np.float32)
    out = rng.randn(4, 4).astype(np.float32)
    jw = jnp.asarray(w).astype(jnp.bfloat16)
    tw = torch.from_numpy(w).to(torch.bfloat16)
    want = np.asarray(jhealth.step_stats([jnp.asarray(out)],
                                         grads=[jnp.asarray(g)], params=[jw]))
    got = thealth.step_stats([torch.from_numpy(out)],
                             grads=[torch.from_numpy(g)], params=[tw])
    _close(got.numpy(), want)


@pytest.mark.parametrize('a', [
    np.array([1.0, np.nan, np.inf, -np.inf], np.float32),
    np.ones((3, 3), np.float32), np.array([1, 2], np.int32),
    np.zeros((0,), np.float32)])
def test_host_checks_match(a):
    assert thealth.has_nonfinite(a) == jhealth.has_nonfinite(a)
    assert thealth.finite_report(a) == jhealth.finite_report(a)
    assert thealth.has_nonfinite(torch.from_numpy(a)) == \
        jhealth.has_nonfinite(a)


def test_spike_detector_flags_the_same_anomalies():
    rng = np.random.RandomState(0)
    seq = list(1.0 + 0.01 * rng.randn(40))
    seq[12] = 5.0
    seq[25] = -3.0
    seq[30] = float('nan')
    seq += [2.0] * 30            # a level shift: alarms, then the baseline
    jd = jhealth.SpikeDetector('x', window=16, k=6.0)
    td = thealth.SpikeDetector('x', window=16, k=6.0)
    got = [td.observe(v) for v in seq]
    want = [jd.observe(v) for v in seq]
    assert got == want
    flagged = [i for i, a in enumerate(got) if a]
    assert 12 in flagged and 25 in flagged and 30 not in flagged
    assert flagged[-1] < len(seq) - 1


def _window_rows(bad_rows=(), width=2):
    rows = []
    for i in range(4):
        row = [1.0, 0.5 + i, 2.0, 0.25 + 0.01 * i] + [1.0] * width
        if i in bad_rows:
            row[0] = 0.0
            row[1] = float('nan')
            row[4 + 1] = 0.0
        rows.append(row)
    return np.asarray(rows, np.float32)


@pytest.mark.parametrize('bad', [(), (2,), (1, 3)])
def test_note_window_gives_the_same_incident(planes_on, bad):
    mat = _window_rows(bad)
    got = thealth.note_window(torch.from_numpy(mat), source='fused_fit',
                              nbatch_base=8, bisect=lambda i: ('fc1', i))
    want = jhealth.note_window(mat, source='fused_fit', nbatch_base=8,
                               bisect=lambda i: ('fc1', i))
    assert got == want
    if bad:
        assert got['step'] == 8 + bad[0] and got['first_bad_layer'] == 'fc1'
    for name in ('health.steps', 'health.nonfinite_steps'):
        assert ttele.get_registry().counter(name).value == \
            jtele.get_registry().counter(name).value
    assert thealth.snapshot_health() == jhealth.snapshot_health()


def test_note_step_and_the_raise_action(planes_on, monkeypatch):
    row = _window_rows((0,))[0]
    thealth.note_batch(5)
    jhealth.note_batch(5)
    assert thealth.note_step(torch.from_numpy(row)) == jhealth.note_step(row)
    monkeypatch.setenv('MXTPU_HEALTH_ACTION', 'raise')
    _reset()
    errs = []
    for mod, r in ((jhealth, row), (thealth, torch.from_numpy(row))):
        mod.enabled()
        with pytest.raises(mod.TrainingHealthError) as e:
            mod.note_step(r, step=7, bisect=lambda: ('data', 0))
        errs.append((str(e.value), e.value.diagnostic))
    assert errs[0] == errs[1]
    assert errs[1][1]['first_bad_layer'] == 'data'


def test_dynamics_window_incident_and_snapshot(planes_on):
    names, outs = ['w1', 'w2'], ['out']
    rng = np.random.RandomState(2)
    mat = np.abs(rng.randn(4, 7)).astype(np.float32)
    mat[2, 3] = np.inf          # w2's grad norm at window step 2
    assert tdyn.note_window(torch.from_numpy(mat), names, outs, 4) == \
        jdyn.note_window(mat, names, outs, 4)
    # the kept incidents carry the sink's wall stamp: compared without it
    snaps = [dict(m.snapshot_dynamics()) for m in (tdyn, jdyn)]
    for snap in snaps:
        snap['incidents'] = [{k: v for k, v in i.items() if k != 't'}
                             for i in snap['incidents']]
    assert snaps[0] == snaps[1]
    assert snaps[0]['incidents'] == [{
        'event': 'layer_nonfinite', 'layer': 'w2', 'stat': 'grad_norm',
        'step': 6, 'host': 0}]


def test_run_health_block_is_the_same_text(planes_on):
    mat = _window_rows((1,))
    thealth.note_window(mat, source='fused_fit')
    jhealth.note_window(mat, source='fused_fit')
    for mod in (thealth, jhealth):
        mod.note_restart(1, reason='TrainingHealthError', restore_step=4)
    snap = thealth.snapshot_health()
    assert snap == jhealth.snapshot_health() and snap['restarts'] == 1
    assert texport._health_lines(snap) == jexport._health_lines(snap)
    assert '-- run health --' in ttele.summary()


def _fit(pkg, ctx):
    """4 batches of 8 rows through the window (W = 2), acc and ce."""
    rng = np.random.RandomState(0)
    X = rng.randn(32, 10).astype(np.float32)
    y = rng.randint(0, 4, 32).astype(np.float32)
    d = pkg.sym.Variable('data')
    h = pkg.sym.Activation(pkg.sym.FullyConnected(d, num_hidden=16,
                                                  name='fc1'),
                           act_type='relu')
    sym = pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(h, num_hidden=4,
                                                       name='fc2'),
                                name='softmax')
    init = {n: (0.3 * rng.randn(*s)).astype(np.float32) for n, s in
            (('fc1_weight', (16, 10)), ('fc1_bias', (16,)),
             ('fc2_weight', (4, 16)), ('fc2_bias', (4,)))}
    mod = pkg.mod.Module(sym, context=ctx)
    it = pkg.io.NDArrayIter(X, y, batch_size=8, label_name='softmax_label')
    mod.fit(it, num_epoch=1, optimizer='sgd', eval_metric=['acc', 'ce'],
            optimizer_params=(('learning_rate', 0.1),),
            arg_params={n: pkg.nd.array(v, ctx=ctx)
                        for n, v in init.items()})
    return mod


@pytest.mark.parametrize('on', [False, True])
def test_window_sentinels_cost_no_extra_fetch(monkeypatch, tmp_path, on):
    monkeypatch.setenv('MXTPU_FIT_STEPS_PER_CALL', '2')
    monkeypatch.setenv('MXTPU_TELEMETRY', '1')
    monkeypatch.setenv('MXTPU_TELEMETRY_PATH', str(tmp_path / 't.jsonl'))
    if on:
        monkeypatch.setenv('MXTPU_HEALTH', '1')
        monkeypatch.setenv('MXTPU_DYNAMICS', '1')
    _reset()
    mod = _fit(mt, mt.cpu())
    loop = mod.__dict__['_fused_fit_cache'][1]
    assert (loop.windows, loop.fetches) == (2, 2)
    reg = ttele.get_registry()
    assert reg.counter('health.steps').value == (4 if on else 0)
    snap = tdyn.snapshot_dynamics()
    if on:
        assert snap['steps'] == 4
        assert set(snap['layers']) == {'fc1_weight', 'fc1_bias',
                                       'fc2_weight', 'fc2_bias'}
        # the JAX window's rows from the same parameters and batches
        jmod = _fit(mx, mx.cpu())
        jsnap = jdyn.snapshot_dynamics()
        for n, stats in snap['layers'].items():
            for k, v in stats.items():
                assert v == pytest.approx(jsnap['layers'][n][k], rel=1e-4)
        del jmod
    else:
        assert snap is None
