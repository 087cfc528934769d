"""The port's engine (mxnet_tpu_torch.engine over the native dependency
engine of src/engine.cc, built by mxnet_tpu_torch._native) against the JAX
package's engine on the same push sequences, on the CPU.

- ordering: per var, writers run in push order and the readers pushed
  between two writers run after the first and before the second; the
  same event order as the JAX package's engine for a sequence whose order
  the rules fix;
- naive mode (NaiveEngine): every op runs at its push, in both packages;
- ``push(fn, sync=True)`` returns after the task ran; ``push`` keeps the
  tasks' order; ``wait_for_all`` waits for the engine;
- the profiler's dump holds the engine's op spans.
Every wait has a timeout.
"""
import json
import threading
import time

import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import engine as jengine
from mxnet_tpu_torch import engine as tengine

WAIT_S = 30


def _ordered_run(eng):
    """Writers of one var (slow) with a reader after each, then a writer
    of both vars and a reader of the second: returns the event log."""
    log = []
    lock = threading.Lock()

    def ev(tag, pause=0.0):
        def fn():
            if pause:
                time.sleep(pause)
            with lock:
                log.append(tag)
        return fn

    a, b = eng.new_var(), eng.new_var()
    for i in range(4):
        eng.push(ev('w%d' % i, 0.005 * (4 - i)), mutable_vars=[a])
        eng.push(ev('r%d' % i), const_vars=[a])
    eng.push(ev('copy'), mutable_vars=[a, b])
    eng.push(ev('last'), const_vars=[b])
    eng.wait_for_var(b)
    eng.wait_for_all()
    assert eng.pending_ops() == 0
    return log


def test_ordering_matches_jax():
    tlog = _ordered_run(tengine.Engine(num_workers=4))
    jlog = _ordered_run(jengine.Engine(num_workers=4))
    assert tlog == jlog
    assert tlog == ['w0', 'r0', 'w1', 'r1', 'w2', 'r2', 'w3', 'r3', 'copy',
                    'last']


def test_readers_run_together_between_writers():
    """Two readers of one var run at once (each waits for the other)."""
    eng = tengine.Engine(num_workers=4)
    v = eng.new_var()
    both = threading.Barrier(2, timeout=WAIT_S)
    log = []
    eng.push(lambda: log.append('w'), mutable_vars=[v])
    for _ in range(2):
        eng.push(lambda: log.append(both.wait()), const_vars=[v])
    eng.push(lambda: log.append('w2'), mutable_vars=[v])
    eng.wait_for_all()
    assert log[0] == 'w' and log[-1] == 'w2' and sorted(log[1:3]) == [0, 1]


@pytest.mark.parametrize('lib', ['jax', 'port'])
def test_naive_mode_runs_at_push(monkeypatch, lib):
    mod = jengine if lib == 'jax' else tengine
    monkeypatch.setattr(mod, '_engine_type', 'NaiveEngine')
    assert mod.naive() and mod.engine_type() == 'NaiveEngine'
    eng = mod.Engine()
    v = eng.new_var()
    log = []
    eng.push(lambda: log.append(threading.get_ident()), mutable_vars=[v])
    assert log == [threading.get_ident()]      # inline, on this thread
    ev = mod._worker.push(lambda: log.append('host'))
    assert ev.is_set() and log[-1] == 'host'


def test_push_sync_and_order_match_jax():
    logs = {}
    for mod in (jengine, tengine):
        log = []
        evs = [mod.push(lambda i=i: (time.sleep(0.002 * (5 - i)),
                                     log.append(i))) for i in range(5)]
        ev = mod.push(lambda: log.append('sync'), sync=True)
        assert ev.is_set() and log[-1] == 'sync'
        assert all(e.wait(WAIT_S) for e in evs)
        mod.wait_for_all()
        logs[mod] = log
    assert logs[tengine] == logs[jengine] == [0, 1, 2, 3, 4, 'sync']


def test_wait_helpers_and_bulk_size():
    a = mt.nd.ones((3,), ctx=mt.cpu())
    tengine.wait_for_var(a)
    tengine.wait_for_all()
    prev = tengine.set_bulk_size(7)
    assert tengine.set_bulk_size(prev) == 7
    assert prev == jengine._bulk_size


def test_profiler_dump_holds_engine_spans(tmp_path):
    path = str(tmp_path / 'profile.json')
    eng = tengine.Engine(num_workers=2)
    mt.profiler.profiler_set_config(mode='all', filename=path)
    mt.profiler.profiler_set_state('run')
    try:
        v = eng.new_var()
        for i in range(3):
            eng.push(lambda: time.sleep(0.001), mutable_vars=[v],
                     name='engine_op_%d' % i)
        eng.wait_for_all()
    finally:
        mt.profiler.profiler_set_state('stop')
    mt.profiler.dump_profile()
    with open(path) as f:
        events = json.load(f)['traceEvents']
    spans = [e for e in events if e['name'].startswith('engine_op_')]
    assert sorted(e['name'] for e in spans) == ['engine_op_0', 'engine_op_1',
                                                'engine_op_2']
    assert all(e['ph'] == 'X' and e['dur'] >= 0 for e in spans)
    t0 = time.time() * 1e6
    assert all(abs(e['ts'] - t0) < 600e6 for e in spans)   # one clock


def test_mx_exports():
    assert mt.engine.engine_type() == mx.engine.engine_type()
    assert set(jengine.__all__) <= set(tengine.__all__)
