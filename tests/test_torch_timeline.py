"""The port's step timeline (``mxnet_tpu_torch/telemetry/timeline.py``)
against the JAX package's (``mxnet_tpu/telemetry/timeline.py``) on the CPU.

Parity, exact: ``estimate_offsets``, ``decompose`` and ``attribute`` of both
packages on the same inputs (the cases of the JAX package's
``test_timeline.py``: the median and NaN offsets, a wrapped clock, the
decomposition's clamp, the gating host and phase of two hosts, one host's
largest share, short and NaN rows), and the sync vector's layout and the
span-to-phase map. The port's own contracts: the local ledger over a CPU
fit, per batch and in the windows (the timeline record, its gauges and the
summary's block, the draw, put, dispatch and fetch phases a step); the
ledger's units; MXTPU_TIMELINE off leaves no trace; the sync-round half
raises NotImplementedError naming its ROADMAP.md items.
"""
import json
import math

import numpy as np
import pytest

import mxnet_tpu_torch as mt
from mxnet_tpu.telemetry import cluster as jcluster
from mxnet_tpu.telemetry import timeline as jtl
from mxnet_tpu_torch.telemetry import cluster as tcluster
from mxnet_tpu_torch.telemetry import timeline as ttl

NAN = float('nan')
FLAGS = ('MXTPU_TELEMETRY', 'MXTPU_TELEMETRY_PATH', 'MXTPU_TIMELINE',
         'MXTPU_FUSED_FIT', 'MXTPU_FUSED_EVAL')


def _reset(monkeypatch, **env):
    for name in FLAGS:
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    mt.config.flags.reload()
    mt.telemetry._reset_for_tests()


@pytest.fixture
def clean(monkeypatch):
    _reset(monkeypatch)
    yield monkeypatch
    _reset(monkeypatch)


def _same(a, b):
    """Equal, with NaN equal to NaN, through dicts and lists."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b and type(a) is type(b)


def _row(step_ms=NAN, comm=NAN, proc=0.0, wall=NAN, mono=NAN, **phases):
    """One SYNC_KEYS-shaped row (NaN everywhere not named)."""
    keys = jcluster.SYNC_KEYS
    row = [NAN] * len(keys)
    row[keys.index('step_time_ms')] = step_ms
    row[keys.index('comm_pct')] = comm
    row[keys.index('proc_index')] = proc
    row[keys.index('clock_wall_s')] = wall
    row[keys.index('clock_mono_s')] = mono
    for k, p in enumerate(jtl.PHASES):
        if p in phases:
            row[keys.index(jtl.SLOTS[2 + k])] = phases[p]
    return row


def test_layout_is_the_jax_packages():
    assert tcluster.SYNC_KEYS == jcluster.SYNC_KEYS
    assert ttl.PHASES == jtl.PHASES
    assert ttl.SLOTS == jtl.SLOTS
    assert ttl.PHASE_SPANS == jtl.PHASE_SPANS
    assert ttl.CLOCK_MOD == jtl.CLOCK_MOD


OFFSET_CASES = {
    'median_and_nan': [100.0, 100.08, NAN],
    'one_host': [123.4],
    'none_sampled': [NAN, NAN],
    'wrapped': [63.99, 0.02, 0.05, 63.97],
    'four_hosts': [10.0, 10.004, 9.999, 10.25],
}


@pytest.mark.parametrize('case', sorted(OFFSET_CASES))
def test_estimate_offsets_matches_jax(case):
    walls = OFFSET_CASES[case]
    assert _same(ttl.estimate_offsets(walls), jtl.estimate_offsets(walls))


DECOMPOSE_CASES = {
    'all_phases': (10.0, {'draw': 2.0, 'put': 1.0, 'fetch': 0.5,
                          'checkpoint': 0.3, 'kvstore': 0.2}, 20.0),
    'clamped': (1.0, {'draw': 5.0}, None),
    'no_step': (NAN, {'draw': 1.0, 'fetch': 2.0}, 10.0),
    'nan_phase': (4.0, {'draw': NAN, 'dispatch': 3.0, 'fetch': 0.25}, NAN),
}


@pytest.mark.parametrize('case', sorted(DECOMPOSE_CASES))
def test_decompose_matches_jax(case):
    step, phases, comm = DECOMPOSE_CASES[case]
    assert _same(ttl.decompose(step, phases, comm),
                 jtl.decompose(step, phases, comm))


ATTRIBUTE_CASES = {
    'two_hosts': ([_row(step_ms=10.0, comm=20.0, proc=0.0, draw=0.4, put=0.2,
                        dispatch=1.0, fetch=0.1),
                   _row(step_ms=14.0, comm=15.0, proc=1.0, draw=4.5, put=0.2,
                        dispatch=1.1, fetch=0.1)],
                  dict(step=200, offsets={0: -40.0, 1: 40.0})),
    'one_host': ([_row(step_ms=8.0, proc=0.0, draw=1.0, fetch=5.0)], {}),
    'short_rows': (np.array([[5.0, 10.0, 4.0, 1e6, NAN, 0.0, NAN, NAN, NAN,
                              NAN],
                             [9.0, 40.0, 8.0, 2e6, NAN, 1.0, NAN, NAN, NAN,
                              NAN]]), {}),
    'no_step_times': ([_row(), _row(proc=1.0)], {}),
    'one_vector': (_row(step_ms=3.0, proc=2.0, dispatch=2.5, put=0.1),
                   dict(host_ids=[7])),
    'three_hosts': ([_row(step_ms=12.0, proc=0.0, draw=1.0, dispatch=9.0),
                     _row(step_ms=12.5, proc=1.0, draw=1.2, dispatch=9.1),
                     _row(step_ms=20.0, proc=2.0, draw=1.1, dispatch=9.0,
                          fetch=8.0)], dict(step=7)),
}


@pytest.mark.parametrize('case', sorted(ATTRIBUTE_CASES))
def test_attribute_matches_jax(case):
    mat, kw = ATTRIBUTE_CASES[case]
    assert _same(ttl.attribute(mat, **kw), jtl.attribute(mat, **kw))


def _records(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def _fit():
    S = mt.sym
    h = S.FullyConnected(S.var('data'), num_hidden=8, name='fc1')
    h = S.Activation(S.BatchNorm(h, name='bn1'), act_type='relu')
    net = S.SoftmaxOutput(S.FullyConnected(h, num_hidden=4, name='fc2'),
                          name='softmax')
    rng = np.random.RandomState(0)
    X = rng.standard_normal((80, 6)).astype(np.float32)
    y = rng.randint(0, 4, 80).astype(np.float32)
    it = mt.io.NDArrayIter(X, y, batch_size=8)
    mod = mt.mod.Module(net, context=mt.cpu())
    mt.random.seed(0)
    mod.fit(it, num_epoch=1, optimizer='sgd',
            optimizer_params=(('learning_rate', 0.1),),
            initializer=mt.init.Xavier(), eval_metric='acc')


@pytest.mark.parametrize('fused', [False, True], ids=['per_batch', 'window'])
def test_local_ledger_over_a_fit(clean, tmp_path, fused):
    """The end-of-run attribution from this host's ledger: one host, its
    step split into phases a step (the per-batch loop's draw, dispatch and
    fetch; the window's put besides), the step's decomposition and the
    largest phase named, in the record, the gauges and the table."""
    path = tmp_path / 't.jsonl'
    _reset(clean, MXTPU_TELEMETRY='1', MXTPU_TELEMETRY_PATH=str(path),
           MXTPU_TIMELINE='1', MXTPU_FUSED_FIT='1' if fused else '0')
    _fit()
    assert ttl._state.steps == 10
    assert ttl.snapshot_timeline() is None
    table = mt.telemetry.write_summary(log=False)
    mt.telemetry._state.sink.flush()
    recs = _records(path)
    tl = [r for r in recs if r['type'] == 'timeline']
    assert len(tl) == 1
    out = tl[0]
    assert out['hosts'] == 1 and out['step'] == 10
    row = out['per_host'][0]
    assert row['host'] == 0 and row['step_time_ms'] > 0
    for p in ('draw', 'dispatch', 'fetch'):
        assert row['phases'][p] > 0, p
    assert row['phases']['checkpoint'] == 0 and row['phases']['kvstore'] == 0
    assert out['critical_host'] == 0 and out['skew_ms'] == 0.0
    assert out['critical_phase'] in ttl.PHASES + ('compute',)
    # each phase is its spans' sum a step
    hists = mt.telemetry.snapshot()['histograms']
    for phase in ('draw', 'put', 'dispatch', 'fetch'):
        spans = [n for n, p in ttl.PHASE_SPANS.items() if p == phase]
        total = sum(hists[n]['sum'] for n in spans if n in hists)
        assert abs(row['phases'][phase] - total / 10) <= 1e-3, phase
    assert ('fused_fit.put' in hists) == fused
    gauges = [r for r in recs if r['type'] == 'summary'][-1]['snapshot'][
        'gauges']
    assert gauges['timeline.critical_phase'] == out['critical_phase']
    assert '-- step timeline --' in table
    assert 'timeline.skew_ms' not in table
    pct = ttl.phase_breakdown()
    assert set(pct) == {'compute_pct', 'collective_pct', 'io_pct',
                        'host_pct'}
    assert pct['collective_pct'] == 0.0


def test_ledger_units(clean, tmp_path):
    """note_span adds only phase spans, note_step counts steps and the
    wall between calls; the local attribution divides by the steps."""
    _reset(clean, MXTPU_TELEMETRY='1', MXTPU_TIMELINE='1',
           MXTPU_TELEMETRY_PATH=str(tmp_path / 't.jsonl'))
    assert ttl.enabled()
    ttl.note_step(2)
    ttl.note_span('fused_fit.draw', 6.0)
    ttl.note_span('fused_fit.dispatch', 10.0)
    ttl.note_span('fit.metric', 4.0)
    ttl.note_span('not.a.phase', 99.0)
    ttl.note_step(2)
    assert ttl._state.steps == 4
    assert ttl._state.phase_ms == {'draw': 6.0, 'put': 0.0,
                                   'dispatch': 10.0, 'fetch': 4.0,
                                   'checkpoint': 0.0, 'kvstore': 0.0}
    out = ttl._local_attribution()
    phases = out['per_host'][0]['phases']
    assert phases['draw'] == 1.5 and phases['dispatch'] == 2.5
    assert phases['fetch'] == 1.0
    # a span through telemetry reaches the ledger
    with mt.telemetry.span('kvstore.push'):
        pass
    assert ttl._state.phase_ms['kvstore'] > 0.0


def test_timeline_off_leaves_no_trace(clean, tmp_path):
    path = tmp_path / 't.jsonl'
    _reset(clean, MXTPU_TELEMETRY='1', MXTPU_TELEMETRY_PATH=str(path),
           MXTPU_FUSED_FIT='0')
    _fit()
    assert not ttl.enabled()
    assert ttl._state.steps == 0
    assert ttl._state.phase_ms == dict.fromkeys(ttl.PHASES, 0.0)
    table = mt.telemetry.write_summary(log=False)
    mt.telemetry._state.sink.flush()
    recs = _records(path)
    assert not [r for r in recs if r['type'] == 'timeline']
    assert 'timeline' not in recs[-1]
    assert not [g for g in recs[-1]['snapshot']['gauges']
                if g.startswith('timeline.')]
    assert 'step timeline' not in table
    assert ttl.summarize() is None and ttl.phase_breakdown() is None
    # with telemetry off too
    _reset(clean, MXTPU_TIMELINE='1')
    assert not ttl.enabled()
    ttl.note_step(3)
    ttl.note_span('fit.draw', 1.0)
    assert ttl._state.steps == 0 and ttl.summarize() is None


@pytest.mark.parametrize('fn', ['note_sync_exit', 'local_slots',
                                'publish_round'])
def test_sync_round_half_raises(fn):
    args = ([[0.0]], [0], 1) if fn == 'publish_round' else ()
    with pytest.raises(NotImplementedError, match='items 12 and 13'):
        getattr(ttl, fn)(*args)
