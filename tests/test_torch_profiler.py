"""The port's profiler (``mxnet_tpu_torch/profiler.py``) against the JAX
package's (``mxnet_tpu/profiler.py``) on the CPU: the counterparts of the
JAX package's ``tests/unittest/test_profiler.py``.

The host-span chrome trace: a mid-run dump and the exit's re-dump merge
into one valid file with each event once; a dump of a complete run is
idempotent; periodic dumps accumulate; telemetry spans land in the trace
with telemetry off; the executor's spans; ``maybe_span`` outside a run is
the shared no-op. The port's and the JAX package's profile.json after the
same ``simple_bind`` forward and backward carry the same span names. The
device trace: ``Profiler`` exports a ``torch.profiler`` chrome trace into
``<stem>_cuda/`` (on the CPU it holds CPU activity only), and
``MXTPU_PROFILER_XLA_TRACE=0`` leaves it out. The MXTPU_XPROF window
starts and stops, ignores a bad spec, costs nothing when unset, and spans
one interval when a fused window jumps past both of its boundaries.
"""
import json
import logging
import os

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import profiler as jprof
from mxnet_tpu_torch import profiler

XFLAGS = ('MXTPU_XPROF', 'MXTPU_XPROF_DIR', 'MXTPU_PROFILER_XLA_TRACE',
          'MXTPU_TELEMETRY')


def _reload():
    for f in XFLAGS:
        mt.config.flags.reload(f)
        mx.config.flags.reload(f)


@pytest.fixture
def prof(tmp_path, monkeypatch):
    """The profiler writing to a temporary file, the device trace off (the
    tests of the device trace turn it on)."""
    for f in XFLAGS:
        monkeypatch.delenv(f, raising=False)
    monkeypatch.setenv('MXTPU_PROFILER_XLA_TRACE', '0')
    _reload()
    mt.telemetry._reset_for_tests()
    path = tmp_path / 'profile.json'
    profiler.profiler_set_config('all', str(path))
    yield path
    if profiler.is_running():
        profiler.profiler_set_state('stop')
    for f in XFLAGS:
        monkeypatch.delenv(f, raising=False)
    _reload()


def _names(path):
    with open(path) as f:
        doc = json.load(f)
    assert 'traceEvents' in doc and 'displayTimeUnit' in doc
    return [e['name'] for e in doc['traceEvents']]


def test_dump_then_atexit_redump_merges_not_duplicates(prof):
    profiler.profiler_set_state('run')
    with profiler.span('ev_before_dump'):
        pass
    profiler.dump_profile()
    assert _names(prof).count('ev_before_dump') == 1
    with profiler.span('ev_after_dump'):
        pass
    profiler._atexit_dump()          # what the process's exit runs
    names = _names(prof)
    assert names.count('ev_before_dump') == 1, 'duplicated on re-dump'
    assert names.count('ev_after_dump') == 1, 'post-dump event lost'
    assert not profiler.is_running()  # the exit hook stopped the run


def test_atexit_redump_idempotent_when_complete(prof):
    profiler.profiler_set_state('run')
    with profiler.span('only_event'):
        pass
    profiler.profiler_set_state('stop')
    profiler.dump_profile()
    before = _names(prof)
    profiler._atexit_dump()
    assert _names(prof) == before
    assert before.count('only_event') == 1


def test_periodic_dump_accumulates_each_event_once(prof):
    profiler.profiler_set_state('run')
    for i in range(3):
        with profiler.span('burst%d' % i):
            pass
        profiler.dump_profile()
    profiler.profiler_set_state('stop')
    profiler._atexit_dump()
    names = _names(prof)
    for i in range(3):
        assert names.count('burst%d' % i) == 1


def test_telemetry_spans_merge_into_chrome_trace(prof):
    """telemetry.span events land in the profiler's chrome trace while it
    runs, with MXTPU_TELEMETRY off."""
    assert not mt.telemetry.enabled()
    profiler.profiler_set_state('run')
    with mt.telemetry.span('tele_region', 'telemetry'):
        pass
    profiler.profiler_set_state('stop')
    with mt.telemetry.span('after_stop'):
        pass
    profiler.dump_profile()
    with open(prof) as f:
        events = json.load(f)['traceEvents']
    ev = [e for e in events if e['name'] == 'tele_region']
    assert len(ev) == 1
    assert ev[0]['cat'] == 'telemetry'
    assert ev[0]['ph'] == 'X' and ev[0]['dur'] >= 0
    assert not [e for e in events if e['name'] == 'after_stop']
    assert mt.telemetry.snapshot()['histograms'] == {}


def _bound(pkg):
    x = pkg.sym.Variable('x')
    y = pkg.sym.FullyConnected(x, num_hidden=4, name='fc')
    return y.simple_bind(pkg.cpu(), x=(2, 3))


def test_executor_spans_in_trace(prof):
    exe = _bound(mt)
    profiler.profiler_set_state('run')
    exe.forward(is_train=True,
                x=mt.nd.array(np.ones((2, 3), dtype=np.float32),
                              ctx=mt.cpu()))
    exe.backward()
    profiler.profiler_set_state('stop')
    profiler.dump_profile()
    names = _names(prof)
    assert 'executor.forward' in names
    assert 'executor.backward' in names


def test_span_names_match_the_jax_packages(prof, tmp_path):
    """The same simple_bind forward and backward under each package's
    profiler: the same span names in both profile.json files."""
    out = {}
    for pkg, prof_mod in ((mx, jprof), (mt, profiler)):
        exe = _bound(pkg)
        path = tmp_path / ('%s.json' % pkg.__name__)
        prof_mod.profiler_set_config('all', str(path))
        prof_mod.profiler_set_state('run')
        exe.forward(is_train=True,
                    x=pkg.nd.array(np.ones((2, 3), dtype=np.float32),
                                   ctx=pkg.cpu()))
        exe.backward()
        prof_mod.profiler_set_state('stop')
        prof_mod.dump_profile()
        out[pkg.__name__] = sorted(set(_names(path)))
    assert out['mxnet_tpu_torch'] == out['mxnet_tpu']
    assert 'executor.forward' in out['mxnet_tpu_torch']


def test_no_dump_without_run(prof):
    assert profiler.maybe_span('x') is profiler._NULL_SPAN
    assert not profiler.is_running()
    profiler.record_event('not_running', 0, 1)
    assert profiler._state['events'] == []


def _trace_events(trace_dir):
    files = [f for f in os.listdir(trace_dir) if f.endswith('.json')]
    assert len(files) == 1, files
    with open(os.path.join(trace_dir, files[0])) as f:
        return json.load(f)['traceEvents']


def test_device_trace_beside_the_host_trace(prof, monkeypatch):
    """Profiler(...) exports the torch.profiler trace into <stem>_cuda/; on
    the CPU it holds the CPU activity (the executor's record_function
    ranges among it) and no kernel."""
    monkeypatch.setenv('MXTPU_PROFILER_XLA_TRACE', 'auto')
    _reload()
    exe = _bound(mt)
    with profiler.Profiler(mode='all', filename=str(prof)):
        exe.forward(is_train=True,
                    x=mt.nd.array(np.ones((2, 3), dtype=np.float32),
                              ctx=mt.cpu()))
        exe.backward()
    assert 'executor.backward' in _names(prof)
    trace_dir = str(prof)[:-len('.json')] + '_cuda'
    events = _trace_events(trace_dir)
    cats = {e.get('cat') for e in events}
    assert 'cpu_op' in cats or 'user_annotation' in cats
    assert 'kernel' not in cats
    names = {e.get('name') for e in events}
    assert 'fc' in names            # the graph node's record_function range


def test_device_trace_off(prof):
    with profiler.Profiler(mode='all', filename=str(prof)):
        with profiler.span('x'):
            pass
    assert _names(prof) == ['x']
    assert not os.path.exists(str(prof)[:-len('.json')] + '_cuda')


# ---------------------------------------------------------------------------
# MXTPU_XPROF: the step-windowed device trace
# ---------------------------------------------------------------------------

@pytest.fixture
def xprof_env(tmp_path, monkeypatch):
    trace_dir = tmp_path / 'xprof'
    monkeypatch.setenv('MXTPU_XPROF', '2:4')
    monkeypatch.setenv('MXTPU_XPROF_DIR', str(trace_dir))
    monkeypatch.setenv('MXTPU_PROFILER_XLA_TRACE', '1')
    _reload()
    profiler._xprof_reset_for_tests()
    yield trace_dir
    profiler._xprof_reset_for_tests()
    for v in XFLAGS:
        monkeypatch.delenv(v, raising=False)
    _reload()
    profiler._xprof_reset_for_tests()


def test_xprof_window_starts_and_stops(xprof_env):
    profiler.note_step()                       # 1 < start: idle
    assert isinstance(profiler._xprof, dict)
    assert not profiler._xprof['on']
    profiler.note_step()                       # 2 >= start: tracing
    assert profiler._xprof['on']
    mt.nd.array(np.ones(3, np.float32), ctx=mt.cpu()) * 2   # CPU activity
    profiler.note_step(2)                      # 4 >= stop: done, disarmed
    assert profiler._xprof is None
    events = _trace_events(str(xprof_env))     # the trace landed on disk
    assert events and 'kernel' not in {e.get('cat') for e in events}
    profiler.note_step()                       # disarmed: a cheap no-op


def test_xprof_bad_spec_is_ignored(xprof_env, monkeypatch, caplog):
    monkeypatch.setenv('MXTPU_XPROF', 'nonsense')
    _reload()
    profiler._xprof_reset_for_tests()
    with caplog.at_level(logging.WARNING):
        profiler.note_step()
    assert profiler._xprof is None             # parsed once, disarmed
    assert any('MXTPU_XPROF' in r.getMessage() for r in caplog.records)


def test_xprof_unset_is_free(monkeypatch):
    monkeypatch.delenv('MXTPU_XPROF', raising=False)
    _reload()
    profiler._xprof_reset_for_tests()
    profiler.note_step()
    assert profiler._xprof is None


def test_xprof_window_spans_one_interval_when_jumped(xprof_env):
    """A fused window advancing past both boundaries in one note_step still
    captures one whole interval, not a start and stop back to back."""
    profiler.note_step(32)                     # crosses 2 and 4 at once
    assert isinstance(profiler._xprof, dict) and profiler._xprof['on']
    profiler.note_step(32)                     # the next call closes it
    assert profiler._xprof is None
    assert _trace_events(str(xprof_env))


def test_xprof_suppressed_without_the_device_trace(xprof_env, monkeypatch,
                                                   caplog):
    monkeypatch.setenv('MXTPU_PROFILER_XLA_TRACE', '0')
    _reload()
    with caplog.at_level(logging.WARNING):
        profiler.note_step(4)
    assert profiler._xprof is None
    assert not os.path.exists(str(xprof_env))
