"""The port's goodput plane (``mxnet_tpu_torch/telemetry/goodput.py``)
against the JAX package's (``mxnet_tpu/telemetry/goodput.py``) on the CPU.

Parity, exact: ``compute`` of both packages on the same snapshots gives the
same dict, over the cases of the JAX package's ``test_goodput.py`` (the sum
invariant, an empty run, the compile carve-out and the fused build's
absorption, the comm carve-out with its provenance, rework, the top badput,
negative overhead, the prior attempts' books), with the port's
``cuda.compile_secs`` counter in the place of ``xla.compile_secs``. The
span families that feed each bucket are the JAX package's. The port's own
contracts: a CPU fit with telemetry on feeds each bucket from those spans,
per batch and in the windows, and the record's buckets sum to its wall; a
kernel build counts in ``cuda.compile_secs`` and the compile bucket;
``MXTPU_GOODPUT=0`` and telemetry off emit nothing.
"""
import json

import numpy as np
import pytest

import mxnet_tpu_torch as mt
from mxnet_tpu.telemetry import goodput as jgood
from mxnet_tpu_torch.telemetry import export as texport
from mxnet_tpu_torch.telemetry import goodput as tgood

FLAGS = ('MXTPU_TELEMETRY', 'MXTPU_TELEMETRY_PATH', 'MXTPU_GOODPUT',
         'MXTPU_GOODPUT_LOST_S', 'MXTPU_TIMELINE', 'MXTPU_FUSED_FIT',
         'MXTPU_FUSED_EVAL')


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


def _snaps(hists=None, compile_s=None):
    """The same snapshot for each package: the compile seconds under the
    JAX package's counter and under the port's."""
    h = {k: {'count': 1, 'sum': v} for k, v in (hists or {}).items()}
    out = []
    for name in ('xla.compile_secs', 'cuda.compile_secs'):
        counters = {name: compile_s} if compile_s is not None else {}
        out.append({'counters': counters, 'gauges': {}, 'histograms': h})
    return out


# (histograms, compile seconds, elapsed, keyword arguments)
CASES = {
    'sum_invariant': ({'fit.dispatch': 2000.0, 'fit.draw': 500.0,
                       'ckpt.save': 250.0, 'eval.dispatch': 100.0}, 1.0, 10.0,
                      dict(rework_steps=5, total_steps=20, comm_pct=25.0)),
    'empty_run': ({}, None, 4.0, {}),
    'compile_carved': ({'fit.dispatch': 1000.0}, 0.4, 1.0, {}),
    'fused_build_absorbs': ({'fused_fit.dispatch': 1000.0,
                             'fused_fit.build': 500.0}, 0.4, 2.0, {}),
    'comm_measured': ({'fit.dispatch': 1000.0}, None, 2.0,
                      dict(comm_pct=25.0, comm_source='measured')),
    'comm_modeled': ({}, None, 1.0, dict(comm_pct=10.0)),
    'rework': ({'fit.dispatch': 10000.0}, None, 20.0,
               dict(rework_steps=10, total_steps=100)),
    'badput_top': ({'fit.dispatch': 5000.0, 'fit.draw': 1000.0}, None, 6.5,
                   {}),
    'negative_overhead': ({'fit.dispatch': 3000.0}, None, 2.0, {}),
    'prior_lost': ({'fit.dispatch': 1000.0}, None, 2.0,
                   dict(prior_lost_s=2.0)),
    'every_family': ({'fit.dispatch': 700.0, 'fused_fit.dispatch': 300.0,
                      'fused_fit.fetch': 250.0, 'fit.draw': 40.0,
                      'fused_fit.draw': 30.0, 'fused_fit.put': 20.0,
                      'eval.metric': 15.0, 'fused_eval.fetch': 12.0,
                      'ckpt.capture': 9.0, 'fit.batch': 5000.0,
                      'fit.metric': 80.0}, 0.05, 3.0, {}),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_compute_matches_jax(case):
    hists, compile_s, elapsed, kw = CASES[case]
    jsnap, tsnap = _snaps(hists, compile_s)
    want = jgood.compute(jsnap, elapsed, **kw)
    got = tgood.compute(tsnap, elapsed, **kw)
    assert got == want
    assert abs(sum(got['buckets'].values()) - got['wall_s']) < 0.01


def test_span_families_and_buckets_are_the_jax_packages():
    assert tgood.BUCKETS == jgood.BUCKETS
    for fam in ('STEP_SPANS', 'INPUT_SPANS', 'EVAL_SPANS', 'CKPT_SPANS',
                'BUILD_SPANS'):
        assert getattr(tgood, fam) == getattr(jgood, fam), fam


def test_compile_bucket_reads_the_ports_counter():
    """The port's compile seconds are cuda.compile_secs; XLA's counter,
    which no port code writes, counts for nothing."""
    snap = {'counters': {'xla.compile_secs': 0.4},
            'histograms': {'fit.dispatch': {'count': 1, 'sum': 1000.0}}}
    out = tgood.compute(snap, 1.0)
    assert out['buckets']['compile'] == 0.0
    assert out['buckets']['step'] == 1.0


def _records(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def _mlp_fit(epochs=2):
    S = mt.sym
    h = S.FullyConnected(S.var('data'), num_hidden=8, name='fc1')
    h = S.Activation(S.BatchNorm(h, name='bn1'), act_type='relu')
    net = S.SoftmaxOutput(S.FullyConnected(h, num_hidden=4, name='fc2'),
                          name='softmax')
    rng = np.random.RandomState(0)
    X = rng.standard_normal((40, 6)).astype(np.float32)
    y = rng.randint(0, 4, 40).astype(np.float32)
    it = mt.io.NDArrayIter(X, y, batch_size=8)
    mod = mt.mod.Module(net, context=mt.cpu())
    mt.random.seed(0)
    mod.fit(it, eval_data=it, num_epoch=epochs, optimizer='sgd',
            optimizer_params=(('learning_rate', 0.1),),
            initializer=mt.init.Xavier(), eval_metric='acc')
    return mod


@pytest.mark.parametrize('fused', [False, True], ids=['per_batch', 'window'])
def test_cpu_fit_feeds_each_bucket(clean, tmp_path, fused):
    """A fit with telemetry on: the goodput record's buckets and overhead
    sum to its wall within the rounding of its fields, the step, input and
    eval buckets are fed by their loops' spans, and the record, the gauges,
    the summary record and the table's block carry the same numbers."""
    path = tmp_path / 't.jsonl'
    _reset(clean, MXTPU_TELEMETRY='1', MXTPU_TELEMETRY_PATH=str(path),
           MXTPU_FUSED_FIT='1' if fused else '0',
           MXTPU_FUSED_EVAL='1' if fused else '0')
    _mlp_fit()
    snap = mt.telemetry.snapshot()
    hists = snap['histograms']
    fam = ('fused_fit', 'fused_eval') if fused else ('fit', 'eval')
    for name in ((fam[0] + '.dispatch', fam[0] + '.draw',
                  fam[1] + '.dispatch') +
                 (('fused_fit.fetch', 'fused_fit.put', 'fused_eval.fetch')
                  if fused else ('eval.metric',))):
        assert hists[name]['count'] > 0, name
    table = mt.telemetry.write_summary(log=False)
    mt.telemetry._state.sink.flush()
    recs = _records(path)
    good = [r for r in recs if r['type'] == 'goodput']
    assert len(good) == 1
    g = good[0]
    b = g['buckets']
    assert list(b) == list(tgood.BUCKETS)
    assert abs(sum(b.values()) - g['wall_s']) <= 0.005
    assert b['step'] > 0 and b['input_wait'] > 0 and b['eval'] > 0
    assert b['compile'] == 0.0 and b['comm'] == 0.0
    assert 'comm_source' not in g
    # the step bucket is exactly its spans' sum (nothing compiled here)
    want_step = tgood._span_sum_s(hists, tgood.STEP_SPANS)
    assert abs(b['step'] - want_step) <= 0.0005
    summ = [r for r in recs if r['type'] == 'summary'][-1]
    assert summ['goodput']['buckets'] == b
    gauges = summ['snapshot']['gauges']
    assert gauges['goodput.step_s'] == b['step']
    assert gauges['goodput.goodput_pct'] == g['goodput_pct']
    assert '-- where the time went --' in table
    assert 'goodput.step_s' not in table      # the block carries it
    assert tgood.snapshot_goodput()['buckets'] == b
    assert table == texport.summary_table(
        summ['snapshot'], summ['elapsed_s'], goodput=summ['goodput'],
        timeline=summ.get('timeline'))


def test_kernel_build_counts_in_compile_bucket(clean, tmp_path):
    """ops/_build.load's build of a library counts its seconds in
    cuda.compile_secs, which the compile bucket reads (the build stands in
    for nvcc, which this machine lacks)."""
    import time
    from mxnet_tpu_torch.ops import _build
    _reset(clean, MXTPU_TELEMETRY='1',
           MXTPU_TELEMETRY_PATH=str(tmp_path / 't.jsonl'))
    lib = tmp_path / 'libfake.so'

    def fake_build(name, out):
        time.sleep(0.02)
        out.write_bytes(b'')
    clean.setattr(_build, '_library_path', lambda name: lib)
    clean.setattr(_build, '_build', fake_build)
    clean.setattr(_build.ctypes, 'CDLL', lambda path: ('loaded', path))
    try:
        assert _build.load('fake_source') == ('loaded', str(lib))
        _build.load('fake_source')              # loaded: no second build
    finally:
        _build._loaded.pop('fake_source', None)
    secs = mt.telemetry.snapshot()['counters']['cuda.compile_secs']
    assert 0.02 <= secs < 5.0
    assert tgood.current()['buckets']['compile'] == round(secs, 3)


def test_goodput_off_emits_nothing(clean, tmp_path):
    path = tmp_path / 't.jsonl'
    _reset(clean, MXTPU_TELEMETRY='1', MXTPU_TELEMETRY_PATH=str(path),
           MXTPU_GOODPUT='0', MXTPU_FUSED_FIT='0')
    _mlp_fit(epochs=1)
    table = mt.telemetry.write_summary(log=False)
    mt.telemetry._state.sink.flush()
    recs = _records(path)
    assert not [r for r in recs if r['type'] == 'goodput']
    assert 'goodput' not in recs[-1]
    assert not [g for g in recs[-1]['snapshot']['gauges']
                if g.startswith('goodput.')]
    assert 'where the time went' not in table
    assert tgood.current() is None and tgood.summarize() is None


def test_telemetry_off_is_a_no_op(clean):
    io0 = texport._io_calls
    _mlp_fit(epochs=1)
    assert not mt.telemetry.enabled()
    assert tgood.current() is None
    assert tgood.summarize() is None
    assert tgood.snapshot_goodput() is None
    tgood.note_rework(3)
    assert mt.telemetry.snapshot() == {'counters': {}, 'gauges': {},
                                       'histograms': {}}
    assert texport._io_calls == io0
    assert all(np.isnan(v) for v in tgood.local_stats())


def test_prior_lost_seconds_from_the_flag(clean, tmp_path):
    """MXTPU_GOODPUT_LOST_S: the job's books beside the process's, as the
    JAX package reports them."""
    _reset(clean, MXTPU_TELEMETRY='1',
           MXTPU_TELEMETRY_PATH=str(tmp_path / 't.jsonl'),
           MXTPU_GOODPUT_LOST_S='2.5')
    g = tgood.summarize(elapsed_s=5.0)
    assert g['prior_lost_s'] == 2.5 and g['job_wall_s'] == 7.5
    want = jgood.compute({'counters': {}, 'histograms': {}}, 5.0,
                         prior_lost_s=2.5)
    assert g == want
    tgood.note_rework(4)
    assert mt.telemetry.snapshot()['gauges']['goodput.rework_steps'] == 4
