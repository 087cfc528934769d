"""Runtime telemetry, the backend-neutral core of ``mxnet_tpu/telemetry``:
the planes the training loop and the serving plane report to.

- a metrics registry (:mod:`.registry`): counters, gauges, histograms
  with recent-window p50/p95;
- a span tracer (:func:`span`): times a host-side region into a
  histogram and a JSONL span record and, whenever the profiler runs
  (:mod:`..profiler`), into its chrome trace too, even with telemetry off;
- exporters (:mod:`.export`): the append-only JSONL log (host-stamped,
  size-capped by ``MXTPU_TELEMETRY_MAX_MB``) and the end-of-run summary
  table;
- goodput accounting (:mod:`.goodput`, ``MXTPU_GOODPUT``, on by
  default with telemetry): the run's wall clock in named buckets (step,
  compile, input wait, eval, ...) from the loops' leaf spans, summing to
  the wall;
- the step timeline (:mod:`.timeline`, ``MXTPU_TIMELINE``): the fit
  loops' phase spans per step (draw, put, dispatch, fetch) and the step's
  decomposition, with the largest phase named;
- the live plane (:mod:`.serve`, ``MXTPU_TELEMETRY_PORT``): ``/metrics``
  (Prometheus text), ``/healthz`` and ``/summary`` over HTTP;
- request-level tracing (:mod:`.trace`): one trace id per serving
  request and its stage breakdown as a ``trace`` JSONL record;
- the SLO plane (:mod:`.slo`, ``MXTPU_SLO_LATENCY_MS`` /
  ``MXTPU_SLO_ERROR_PCT``): the error budget's burn rate over the
  request stream and the ``slo_degraded`` /healthz state;
- the incident flight recorder (:mod:`.flight`,
  ``MXTPU_FLIGHT_RECORDER``): a ring of the latest records, dumped to
  ``flight-<reason>.jsonl`` by each incident path;
- the hang watchdog (:mod:`.watchdog`, ``MXTPU_WATCHDOG_SECS``): a
  progress monitor fed by the fit, eval and serving loops, whose stall
  flips /healthz to ``hung``.

Not ported: the planes bound to XLA (``xla``, ``programs``, ``roofline``,
``memory``), the training-health planes (``health``, ``dynamics``), the
run ledger (``ledger``), cluster aggregation and the step timeline's
sync-round half; reaching one raises NotImplementedError naming ROADMAP.md
§1 item 13.

Everything is OFF by default. ``MXTPU_TELEMETRY=1`` turns it on;
``MXTPU_TELEMETRY_PATH`` points the JSONL log (default
``telemetry.jsonl``). While off, every entry point hands out a shared
no-op object: no I/O, no registry writes, one cached-bool check per call
site.

Instrumented sites, with the JAX package's names: ``fit.batch`` (the
parent) with its leaves ``fit.dispatch`` / ``fit.draw`` / ``fit.metric``
/ ``fit.callback`` and the ``fit.steps`` / ``fit.epochs`` counters (the
per-batch loop); ``fused_fit.build|draw|put|dispatch|fetch``, the
``fused_fit.windows`` counter, the ``fused_fit.steps_per_call`` gauge and
the ``fused_fit.overlap_ms`` histogram (the fit window);
``eval.dispatch|metric|fetch``, the ``eval.batches`` counter and the
``eval_samples_per_sec`` gauge (the per-batch score and predict);
``fused_eval.build|draw|put|dispatch|fetch``, ``fused_eval.windows`` and
``fused_eval.steps_per_call`` (the eval window); ``executor.forward|
backward``, ``exec_group.forward|backward``, ``module.update``; the
``io.batches`` counter and the ``io.prefetch_wait`` histogram; the
``kvstore.push|pull`` spans with the ``kvstore.push_bytes|pull_bytes``
counters; the ``speedometer.samples_per_sec`` gauge; the
``cuda.compile_secs`` counter (the port's kernel builds, in place of the
JAX package's ``xla.compile_secs``). The serving plane
(:mod:`mxnet_tpu_torch.serving`) reports the ``serve.request_latency``
and ``serve.queue_wait`` histograms, the ``serve.requests`` /
``serve.errors`` / ``serve.dispatches`` / ``serve.rows`` /
``serve.pad_rows`` counters, the queue, batch and pad gauges, and the
``serve.build`` / ``serve.dispatch`` / ``serve.fetch`` spans.
"""
import atexit
import logging
import os
import threading
import time

from .registry import (Registry, NULL_COUNTER, NULL_GAUGE, NULL_HISTOGRAM)
from . import export as _export
from .. import profiler as _profiler
from . import cluster  # noqa: F401  (host_index and the sync vector's keys)
from . import goodput  # noqa: F401  (public submodule)
from . import timeline  # noqa: F401  (public submodule)
from . import serve  # noqa: F401  (public submodule: telemetry.serve.*)
from . import watchdog  # noqa: F401  (public submodule)
from . import trace  # noqa: F401  (public submodule)
from . import slo  # noqa: F401  (public submodule)
from . import flight  # noqa: F401  (public submodule)

__all__ = ['enabled', 'counter', 'gauge', 'histogram', 'span',
           'current_span_path', 'event', 'snapshot', 'summary',
           'write_summary', 'shutdown', 'serve', 'watchdog', 'trace', 'slo',
           'flight', 'goodput', 'timeline', 'get_registry']

# the JAX package's telemetry planes that are not ported, each raising
# where it is reached
_UNPORTED = ('xla', 'programs', 'health', 'roofline', 'memory', 'dynamics',
             'ledger')


def __getattr__(name):
    if name in _UNPORTED:
        raise NotImplementedError(
            'telemetry.%s is not ported yet (ROADMAP.md §1 item 13)' % name)
    raise AttributeError('module %r has no attribute %r' % (__name__, name))


class _State:
    __slots__ = ('decided', 'active', 'registry', 'sink', 't_start',
                 'summary_written')

    def __init__(self):
        self.decided = False
        self.active = False
        self.registry = Registry()
        self.sink = None
        self.t_start = None
        self.summary_written = False


_state = _State()
_decide_lock = threading.Lock()
_atexit_registered = False


def _decide():
    global _atexit_registered
    with _decide_lock:
        if _state.decided:
            return _state.active
        from ..config import flags
        flags.reload('MXTPU_TELEMETRY')
        on = bool(flags.get('MXTPU_TELEMETRY'))
        _state.active = on
        _state.decided = True
        if on:
            _state.t_start = time.time()
            flags.reload('MXTPU_TELEMETRY_PATH')
            flags.reload('MXTPU_TELEMETRY_MAX_MB')
            path = os.path.expanduser(flags.get('MXTPU_TELEMETRY_PATH')
                                      or 'telemetry.jsonl')
            max_mb = float(flags.get('MXTPU_TELEMETRY_MAX_MB'))
            try:
                _state.sink = _export.JsonlSink(
                    path,
                    max_bytes=int(max_mb * 2**20) if max_mb else None)
                # every record carries this process's host index
                _state.sink.host = cluster.host_index()
                _state.sink.emit({'type': 'start', 'pid': os.getpid(),
                                  'path': path})
            except OSError as e:
                logging.warning('telemetry: cannot open %s (%s) — metrics '
                                'stay in-process, no JSONL log', path, e)
                _state.sink = None
            # live endpoint (telemetry/serve.py): only with
            # MXTPU_TELEMETRY_PORT set — port unset = no thread/socket
            serve.maybe_start()
            if not _atexit_registered:
                _atexit_registered = True
                atexit.register(shutdown)
    return _state.active


def enabled():
    """Whether telemetry is on (decided once from MXTPU_TELEMETRY; the
    first True decision opens the sink). Hot call sites rely on this being
    one attribute check after the first call."""
    if _state.decided:
        return _state.active
    return _decide()


def get_registry():
    return _state.registry


def counter(name):
    """Live counter when enabled, shared no-op otherwise."""
    return _state.registry.counter(name) if enabled() else NULL_COUNTER


def gauge(name):
    return _state.registry.gauge(name) if enabled() else NULL_GAUGE


def histogram(name):
    return _state.registry.histogram(name) if enabled() else NULL_HISTOGRAM


# -- span tracer -------------------------------------------------------------

_TLS = threading.local()


def _stack():
    st = getattr(_TLS, 'stack', None)
    if st is None:
        st = _TLS.stack = []
    return st


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    """Times a host region: histogram (ms) + JSONL record, and a
    chrome-trace event whenever the profiler runs. Nesting is tracked per
    thread; the JSONL record carries the full path
    ('fit.batch/fit.dispatch') so traces reconstruct the tree."""

    __slots__ = ('name', 'cat', 't0', 'path')

    def __init__(self, name, category):
        self.name = name
        self.cat = category

    def __enter__(self):
        stack = _stack()
        self.path = (stack[-1].path + '/' + self.name) if stack else self.name
        stack.append(self)
        self.t0 = time.time()
        return self

    def __exit__(self, *a):
        t1 = time.time()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:           # unwound out of order (exception)
            stack.remove(self)
        dur_ms = (t1 - self.t0) * 1e3
        st = _state
        if st.active:
            st.registry.histogram(self.name).observe(dur_ms)
            # the step-phase ledger (MXTPU_TIMELINE): leaf phase spans add
            # to their phase — one cached bool while off
            if timeline.enabled():
                timeline.note_span(self.name, dur_ms)
            if st.sink is not None:
                st.sink.emit({'type': 'span', 'name': self.name,
                              'path': self.path, 't': self.t0,
                              'dur_ms': round(dur_ms, 4)})
        if _profiler.is_running():
            _profiler.record_event(self.name, int(self.t0 * 1e6),
                                   int(t1 * 1e6), self.cat)


def span(name, category='telemetry'):
    """Context manager timing a host-side region.

    Telemetry on: a histogram observation (ms) under ``name`` and a JSONL
    span record. Profiler running: a chrome-trace event in its trace, with
    telemetry off too. Neither: the shared no-op."""
    if enabled() or _profiler.is_running():
        return _Span(name, category)
    return _NULL_SPAN


def current_span_path():
    """Path of the innermost open span on this thread (tests)."""
    stack = getattr(_TLS, 'stack', None)
    return stack[-1].path if stack else None


def event(name, **fields):
    """Append an ad-hoc JSONL record (type='event')."""
    if enabled() and _state.sink is not None:
        rec = {'type': 'event', 'name': name}
        rec.update(fields)
        _state.sink.emit(rec)


# -- summary / shutdown ------------------------------------------------------

def snapshot():
    return _state.registry.snapshot()


def summary():
    """The human-readable end-of-run table, as a string (read-only: no
    gauge is written and no record emitted). Its goodput block is the
    books so far, or, once write_summary() has closed them, the written
    ones (the wall after the run's end is nobody's step)."""
    elapsed = (time.time() - _state.t_start) if _state.t_start else None
    good = goodput.snapshot_goodput() if _state.summary_written \
        else goodput.current()
    return _export.summary_table(_state.registry.snapshot(), elapsed,
                                 goodput=good,
                                 timeline=timeline.snapshot_timeline())


def write_summary(log=True):
    """Append the goodput and timeline records and the JSONL summary
    record, and (by default) log the table. Returns the table string, or
    None when telemetry is off."""
    if not enabled():
        return None
    elapsed = time.time() - _state.t_start
    # wall-clock attribution: publishes the goodput.* gauges and the
    # goodput JSONL record before the snapshot below, so that the gauges
    # land in the summary record too
    gsnap = goodput.summarize(elapsed)
    # the step timeline (MXTPU_TIMELINE): this host's attribution from its
    # ledger, published the same way
    tsnap = timeline.summarize()
    snap = _state.registry.snapshot()
    if _state.sink is not None:
        rec = {'type': 'summary', 'elapsed_s': round(elapsed, 3),
               'snapshot': snap}
        if gsnap:
            rec['goodput'] = gsnap
        if tsnap:
            rec['timeline'] = tsnap
        _state.sink.emit(rec)
        _state.sink.flush()
    table = _export.summary_table(snap, elapsed, goodput=gsnap,
                                  timeline=tsnap)
    if log:
        logging.info('%s', table)
    _state.summary_written = True
    return table


def shutdown():
    """atexit hook: final summary + sink close. Idempotent — and when the
    program already called write_summary() itself, that record IS the
    end-of-run summary: no duplicate is appended here."""
    st = _state
    if not st.active:
        return
    if not st.summary_written:
        try:
            write_summary()
        except Exception:  # noqa: BLE001 — an atexit hook must not raise
            pass
    if st.sink is not None:
        try:
            st.sink.close()
        except Exception:  # noqa: BLE001
            pass
        st.sink = None
    serve.stop()
    st.active = False


def _reset_for_tests():
    """Close the current epoch of telemetry state and re-read the flags on
    next use (tests toggle MXTPU_TELEMETRY in the environment)."""
    global _state
    if _state.sink is not None:
        try:
            _state.sink.close()
        except Exception:  # noqa: BLE001
            pass
    serve.stop()
    _state = _State()
    watchdog._reset_for_tests()
    slo._reset_for_tests()
    flight._reset_for_tests()
    goodput._reset_for_tests()
    timeline._reset_for_tests()
