"""Dynamic batcher, the counterpart of ``mxnet_tpu/serving/batcher.py``:
queue, coalesce, dispatch, split — continuously.

Every request enters a thread-safe queue; the dispatcher holds the OLDEST
request at most ``MXTPU_SERVE_MAX_WAIT_MS`` while later arrivals coalesce
behind it, and fires as soon as the coalesced rows fill the engine's
largest bucket — whichever comes first. One padded device call serves
the whole batch; the outputs are split back per request, pad rows
already stripped by the engine.

Continuous, not lockstep: the dispatch returns once its kernels are
queued on the card (the engine records a CUDA event after them) and the
blocking device->host fetch runs on a one-thread side pool that waits on
that event, so the dispatcher is back at the queue collecting the NEXT
batch while the current one computes. The dispatcher thread runs under
``torch.inference_mode`` (which, like the current device, is per thread
in torch: entered in the caller's thread it would not cover the
dispatches) and never synchronises the device.

Metrics (through the telemetry registry, on ``/metrics``), with the JAX
package's names: the ``serve.request_latency`` histogram (enqueue ->
answer, ms; p99 published as the ``serve.request_latency_p99_ms`` gauge,
exemplar trace ids attached), the ``serve.queue_wait`` histogram
(enqueue -> dispatcher pop, ms; p50 published as
``serve.queue_wait_p50_ms``), ``serve.queue_depth`` /
``serve.batch_size`` / ``serve.pad_fraction`` gauges,
``serve.batch_size_p50`` (recent-window), and the ``serve.requests`` /
``serve.errors`` / ``serve.dispatches`` / ``serve.rows`` /
``serve.pad_rows`` counters.

Tracing (telemetry/trace.py, rides MXTPU_TELEMETRY): every submitted
request carries a RequestTrace (client-supplied id or minted) that
accumulates the stage breakdown — queue_wait (per request), coalesce /
pad / dispatch / fetch / split (batch-shared) — and lands as a ``trace``
JSONL record; the N requests of one coalesced dispatch share ONE
dispatch span id. Completed requests also feed the SLO plane
(telemetry/slo.py): latency per request, and dispatch/fetch failures as
the 5xx the error budget measures (client-side rejects in submit never
burn budget). The host-side ``dispatch_log``, ``queue_wait_log`` and
``stage_log`` deques are kept whether telemetry is on or off.
"""
import collections
import logging
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from .. import telemetry as _tele
from ..telemetry import slo as _slo
from ..telemetry import trace as _trace

__all__ = ['DynamicBatcher']


def _serve_max_wait_s():
    from ..config import flags
    flags.reload('MXTPU_SERVE_MAX_WAIT_MS')
    return flags.get('MXTPU_SERVE_MAX_WAIT_MS') / 1e3


class _Request:
    __slots__ = ('arrays', 'rows', 'future', 't0', 'trace', 'queue_ms')

    def __init__(self, arrays, rows, trace=None):
        self.arrays = arrays
        self.rows = rows
        self.future = Future()
        self.t0 = time.monotonic()
        self.trace = trace       # RequestTrace or None (telemetry off)
        self.queue_ms = None     # stamped when the dispatcher pops it


class DynamicBatcher:
    """Coalescing request queue in front of one :class:`ServingEngine`.

    ``submit`` may be called before :meth:`start` (requests queue up
    and dispatch once the loop runs — how the deterministic coalescing
    tests drive it) and from any number of threads after.
    """

    def __init__(self, engine, max_wait_ms=None, logger=logging):
        self.engine = engine
        self.max_wait = (max_wait_ms / 1e3 if max_wait_ms is not None
                         else _serve_max_wait_s())
        self.max_rows = engine.buckets[-1]
        self.logger = logger
        self._queue = collections.deque()
        self._cond = threading.Condition()
        self._running = False
        self._closed = False
        self._thread = None
        # one worker keeps completions ordered; the blocking fetch of
        # dispatch k runs here while the dispatcher coalesces k+1
        self._fetch_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix='mxtt-serve-fetch')
        self._inflight = collections.deque()
        self._recent_batches = collections.deque(maxlen=256)
        # (rows, bucket_rows, n_requests) per dispatch — the test/debug
        # ledger proving requests actually coalesced
        self.dispatch_log = collections.deque(maxlen=1024)
        # per-request queue waits (ms) + per-dispatch stage timings —
        # host clock reads only, kept unconditionally like dispatch_log
        # so the bench can bank the breakdown without telemetry
        self.queue_wait_log = collections.deque(maxlen=4096)
        self.stage_log = collections.deque(maxlen=1024)

    # -- client API --------------------------------------------------------
    def submit(self, arrays, trace_id=None):
        """Enqueue one request (list of per-input arrays sharing a row
        count, or a single array). Returns a Future resolving to the
        list of output arrays for exactly those rows. ``trace_id``
        seeds the request's trace (client-supplied X-Request-Id /
        traceparent); with telemetry on and none given, one is minted —
        telemetry off mints nothing."""
        arrays, rows = self.engine._check_and_cast(arrays)
        req = _Request(arrays, rows, trace=_trace.start(trace_id,
                                                        rows=rows))
        with self._cond:
            if self._closed:
                # after close() no dispatcher will ever serve the queue
                # — fail fast instead of stranding the future forever
                # (an HTTP handler thread can race ServingServer.stop)
                raise RuntimeError('batcher closed')
            self._queue.append(req)
            _tele.gauge('serve.queue_depth').set(len(self._queue))
            self._cond.notify_all()
        return req.future

    def predict(self, arrays, timeout=None, trace_id=None):
        """submit + wait — the synchronous client call."""
        return self.submit(arrays,
                           trace_id=trace_id).result(timeout=timeout)

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        with self._cond:
            if self._running:
                return self
            self._running = True
        self._thread = threading.Thread(target=self._loop,
                                        name='mxtt-serve-batcher',
                                        daemon=True)
        self._thread.start()
        return self

    def close(self, drain=True):
        """Stop the dispatcher. ``drain=True`` (default) serves every
        request queued before the close; anything else — including a
        submit that raced past the dispatcher's exit — fails with
        RuntimeError instead of hanging its caller."""
        with self._cond:
            self._running = False
            if not drain:
                stranded, self._queue = list(self._queue), \
                    collections.deque()
            else:
                stranded = []
            self._cond.notify_all()
        for req in stranded:
            req.future.set_exception(RuntimeError('batcher closed'))
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        with self._cond:
            # seal the queue AFTER the dispatcher exits: later submits
            # raise, and whatever slipped in between the drain and the
            # thread's exit is failed here, never silently stranded
            self._closed = True
            stranded, self._queue = list(self._queue), \
                collections.deque()
        for req in stranded:
            req.future.set_exception(RuntimeError('batcher closed'))
        while self._inflight:
            try:
                self._inflight.popleft().result(timeout=30)
            except Exception:  # noqa: BLE001 — request futures carry it
                pass
        self._fetch_pool.shutdown(wait=True)

    # -- the dispatcher ----------------------------------------------------
    def _collect(self):
        """Block until a batch is ready (coalesce up to the largest
        bucket or max-wait from the OLDEST request), then pop it.
        Returns (requests, rows) or (None, 0) at shutdown."""
        with self._cond:
            while self._running and not self._queue:
                self._cond.wait(0.05)
            if not self._queue:
                return None, 0
            deadline = self._queue[0].t0 + self.max_wait
            while self._running:
                rows = sum(r.rows for r in self._queue)
                if rows >= self.max_rows:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            batch, rows = [], 0
            while self._queue:
                r = self._queue[0]
                if batch and rows + r.rows > self.max_rows:
                    break          # r boards the NEXT dispatch
                batch.append(self._queue.popleft())
                rows += r.rows
            _tele.gauge('serve.queue_depth').set(len(self._queue))
            return batch, rows

    def _loop(self):
        # inference mode is per thread: this is the thread that dispatches
        with torch.inference_mode():
            while True:
                batch, rows = self._collect()
                if batch is None:
                    return
                self._dispatch(batch, rows)

    def _fail_batch(self, batch, e):
        """Answer every passenger of a failed dispatch: exception on
        the future, an error-status trace record, and one bad request
        against the SLO error budget (these are the 5xx the budget
        measures; client-side rejects never reach a batch)."""
        _tele.counter('serve.errors').inc(len(batch))
        now = time.monotonic()
        for r in batch:
            r.future.set_exception(e)
            _slo.note_request((now - r.t0) * 1e3, error=True)
            if r.trace is not None:
                r.trace.finish(status='error')

    def _dispatch(self, batch, rows):
        # queue_wait: enqueue -> the dispatcher owning the request
        # (includes the coalesce hold on the oldest passenger)
        t_pop = time.monotonic()
        for r in batch:
            r.queue_ms = (t_pop - r.t0) * 1e3
            self.queue_wait_log.append(r.queue_ms)
        timings = {}
        try:
            n_in = len(batch[0].arrays)
            t0 = time.perf_counter()
            arrays = [np.concatenate([r.arrays[i] for r in batch])
                      if len(batch) > 1 else batch[0].arrays[i]
                      for i in range(n_in)]
            timings['coalesce_ms'] = (time.perf_counter() - t0) * 1e3
            chunks = self.engine.dispatch_rows(arrays, timings=timings)
        except Exception as e:  # noqa: BLE001 — answer, don't die
            self._fail_batch(batch, e)
            return
        bucket_rows = sum(b for _, _, b in chunks)
        self.dispatch_log.append((rows, bucket_rows, len(batch)))
        self._recent_batches.append(rows)
        _tele.counter('serve.dispatches').inc()
        _tele.counter('serve.rows').inc(rows)
        _tele.counter('serve.pad_rows').inc(bucket_rows - rows)
        _tele.gauge('serve.batch_size').set(rows)
        rb = sorted(self._recent_batches)
        _tele.gauge('serve.batch_size_p50').set(rb[len(rb) // 2])
        _tele.gauge('serve.pad_fraction').set(
            round((bucket_rows - rows) / float(bucket_rows), 4))
        # ONE dispatch span id shared by every passenger's trace — the
        # coalescing structure survives into the per-request records
        if any(r.trace is not None for r in batch):
            timings['dispatch_span'] = _trace.new_span_id()
        # hand the blocking fetch to the side thread and go collect the
        # next batch — arrivals during device compute board dispatch k+1
        self._inflight.append(
            self._fetch_pool.submit(self._complete, batch, chunks,
                                    timings))
        while self._inflight and self._inflight[0].done():
            self._inflight.popleft()

    def _complete(self, batch, chunks, timings):
        try:
            outs = self.engine.fetch_chunks(chunks, timings=timings)
        except Exception as e:  # noqa: BLE001
            self._fail_batch(batch, e)
            return
        t0 = time.perf_counter()
        hist = _tele.histogram('serve.request_latency')
        qhist = _tele.histogram('serve.queue_wait')
        off = 0
        for r in batch:
            r.future.set_result([o[off:off + r.rows] for o in outs])
            off += r.rows
        timings['split_ms'] = (time.perf_counter() - t0) * 1e3
        self.stage_log.append(dict(timings, rows=sum(r.rows
                                                     for r in batch),
                                   requests=len(batch)))
        dispatch_span = timings.get('dispatch_span')
        now = time.monotonic()
        for r in batch:
            lat_ms = (now - r.t0) * 1e3
            hist.observe(lat_ms,
                         exemplar={'trace_id': r.trace.trace_id}
                         if r.trace is not None else None)
            if r.queue_ms is not None:
                qhist.observe(r.queue_ms)
            _slo.note_request(lat_ms, error=False)
            if r.trace is not None:
                # per-request queue wait + the batch-shared stages, all
                # pointing at the ONE dispatch span
                r.trace.add('queue_wait', r.queue_ms or 0.0)
                r.trace.add_shared(dispatch_span, timings)
                r.trace.finish(status='ok')
        _tele.counter('serve.requests').inc(len(batch))
        p99 = hist.percentile(99)
        if p99 is not None:
            _tele.gauge('serve.request_latency_p99_ms').set(round(p99, 3))
        q50 = qhist.percentile(50)
        if q50 is not None:
            _tele.gauge('serve.queue_wait_p50_ms').set(round(q50, 3))
        _tele.watchdog.note_progress('serve.dispatch')
