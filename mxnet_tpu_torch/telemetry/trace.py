"""Request-level tracing, the counterpart of ``mxnet_tpu/telemetry/trace.py``:
one id per serving request, end to end.

A trace id is minted at the HTTP front end (or accepted from the client
via ``X-Request-Id`` / W3C ``traceparent``), rides the request through
:class:`~mxnet_tpu_torch.serving.batcher.DynamicBatcher` into the engine
dispatch, and lands as one ``trace`` JSONL record carrying the stage
breakdown::

    {"type": "trace", "trace_id": "...", "dispatch_span": "...",
     "rows": 2, "status": "ok", "total_ms": 7.31,
     "stages": {"queue_wait_ms": 4.8, "coalesce_ms": 0.02,
                "pad_ms": 0.05, "dispatch_ms": 0.7, "fetch_ms": 1.6,
                "split_ms": 0.03}}

N coalesced requests emit N trace records that all carry the SAME
``dispatch_span`` id (pad/dispatch/fetch are batch-level stages;
queue_wait and split are per request). The ``serve.request_latency``
histogram carries the trace id as an exemplar, so a scraped p95 on
``/metrics`` names a trace. (The JAX package also lays each finished
trace on the chrome-trace profiler's timeline; that waits for the
profiler's port.)

Gating: tracing rides ``MXTPU_TELEMETRY``: with telemetry off no trace
object is allocated and no id is minted.
"""
import os
import re
import time

__all__ = ['enabled', 'new_trace_id', 'new_span_id', 'from_headers',
           'start', 'RequestTrace', 'STAGES']

# the stage vocabulary, in pipeline order
STAGES = ('queue_wait', 'coalesce', 'pad', 'dispatch', 'fetch', 'split')

_TRACEPARENT_RE = re.compile(
    r'^[0-9a-f]{2}-([0-9a-f]{32})-[0-9a-f]{16}-[0-9a-f]{2}$')
_ID_SAFE_RE = re.compile(r'[^A-Za-z0-9_.\-]')
_MAX_ID_LEN = 64


def enabled():
    """Whether request tracing is on — exactly the telemetry switch."""
    from . import enabled as _tele_enabled
    return _tele_enabled()


def new_trace_id():
    """A fresh 16-hex-char trace id."""
    return os.urandom(8).hex()


def new_span_id():
    """A fresh 8-hex-char span id (the shared dispatch span)."""
    return os.urandom(4).hex()


def from_headers(headers):
    """The client-supplied trace id out of an HTTP header mapping, or
    None. ``X-Request-Id`` wins (sanitized, bounded); else the
    trace-id field of a well-formed W3C ``traceparent``."""
    if headers is None:
        return None
    rid = headers.get('X-Request-Id')
    if rid:
        rid = _ID_SAFE_RE.sub('_', rid.strip())[:_MAX_ID_LEN]
        if rid:
            return rid
    tp = headers.get('traceparent')
    if tp:
        m = _TRACEPARENT_RE.match(tp.strip().lower())
        if m:
            return m.group(1)
    return None


class RequestTrace:
    """One request's accumulating span breakdown (host-side only)."""

    __slots__ = ('trace_id', 'dispatch_span', 'rows', 'status',
                 't0_wall', 't0', 'stages', '_done')

    def __init__(self, trace_id, rows=None):
        self.trace_id = trace_id or new_trace_id()
        self.dispatch_span = None
        self.rows = rows
        self.status = 'ok'
        self.t0_wall = time.time()
        self.t0 = time.monotonic()
        self.stages = {}
        self._done = False

    def add(self, stage, ms):
        """Accumulate ``ms`` under ``stage`` (chunked dispatches add
        per chunk)."""
        self.stages[stage] = self.stages.get(stage, 0.0) + float(ms)

    def add_shared(self, dispatch_span, timings):
        """Absorb one dispatch's batch-level stage timings ({'pad_ms':
        ..}-style dict from the engine) plus the shared dispatch span
        id all passengers point at."""
        self.dispatch_span = dispatch_span
        for stage in STAGES:
            v = timings.get(stage + '_ms')
            if v is not None:
                self.add(stage, v)

    def finish(self, status='ok'):
        """Seal the trace: emit the ``trace`` JSONL record (which also
        enters the flight-recorder ring). Idempotent — the error path and
        the completion path can race."""
        if self._done:
            return None
        self._done = True
        self.status = status
        total_ms = (time.monotonic() - self.t0) * 1e3
        rec = {'type': 'trace', 'trace_id': self.trace_id,
               'dispatch_span': self.dispatch_span,
               'rows': self.rows, 'status': status,
               't': self.t0_wall, 'total_ms': round(total_ms, 4),
               'stages': {s + '_ms': round(v, 4)
                          for s, v in self.stages.items()}}
        from . import _state as st
        if st.active and st.sink is not None:
            st.sink.emit(dict(rec))
        return rec


def start(trace_id=None, rows=None):
    """A live :class:`RequestTrace` when tracing is on, else None (the
    batcher's one cached-bool check per submit)."""
    if not enabled():
        return None
    return RequestTrace(trace_id, rows=rows)
