"""Metrics registry: counters, gauges, histograms, the counterpart of
``mxnet_tpu/telemetry/registry.py`` (backend-neutral, ported as it is).

Three metric kinds, all thread-safe (the serving batcher and its fetch
thread report off the main thread):

- ``Counter``: monotonically increasing float (requests served, rows).
- ``Gauge``: last-write-wins value (queue depth, pad fraction).
- ``Histogram``: streaming count/sum/min/max over ALL observations plus
  p50/p95 over a bounded ring of the most recent observations — a
  recent-window percentile (an old warmup outlier must not pin p95
  forever).

Every site gets its metric via ``registry.counter(name)`` etc. —
create-once by name. Distinct kinds may not share a name (that is a bug
at the call site).
"""
import collections
import threading

__all__ = ['Counter', 'Gauge', 'Histogram', 'Registry',
           'NULL_COUNTER', 'NULL_GAUGE', 'NULL_HISTOGRAM']

_HIST_WINDOW = 8192   # ring capacity backing the percentile estimates
_EXEMPLARS_KEPT = 8   # recent exemplar-carrying observations retained


class Counter:
    """Monotonic accumulator (float increments allowed: compile secs)."""

    __slots__ = ('name', '_value', '_lock')

    def __init__(self, name):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n=1):
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value


class Gauge:
    """Last-write-wins sample."""

    __slots__ = ('name', '_value')

    def __init__(self, name):
        self.name = name
        self._value = None

    def set(self, v):
        self._value = v

    @property
    def value(self):
        return self._value


class Histogram:
    """count/sum/min/max over everything; p50/p95/max over the recent
    ring (last ``_HIST_WINDOW`` observations). Observations may carry
    an exemplar — a small label dict (e.g. ``{'trace_id': ...}``)
    linking the sample to a concrete artifact; the most recent few are
    retained and the highest-valued one rides the snapshot, so a
    scraped p99 names a trace an operator can actually pull up."""

    __slots__ = ('name', '_count', '_sum', '_min', '_max', '_ring',
                 '_ring_pos', '_exemplars', '_lock')

    def __init__(self, name):
        self.name = name
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None
        self._ring = []
        self._ring_pos = 0
        self._exemplars = collections.deque(maxlen=_EXEMPLARS_KEPT)
        self._lock = threading.Lock()

    def observe(self, v, exemplar=None):
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v
            if len(self._ring) < _HIST_WINDOW:
                self._ring.append(v)
            else:
                self._ring[self._ring_pos] = v
                self._ring_pos = (self._ring_pos + 1) % _HIST_WINDOW
            if exemplar:
                self._exemplars.append((v, dict(exemplar)))

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    @property
    def mean(self):
        return self._sum / self._count if self._count else None

    @property
    def min(self):
        return self._min

    @property
    def max(self):
        return self._max

    def percentile(self, p):
        """p in [0, 100]; nearest-rank over the recent ring."""
        with self._lock:
            vals = sorted(self._ring)
        if not vals:
            return None
        idx = max(0, min(len(vals) - 1,
                         int(round(p / 100.0 * (len(vals) - 1)))))
        return vals[idx]

    def exemplar(self):
        """The highest-valued recent exemplar as {'value': v,
        'labels': {...}}, or None — the tail sample the /metrics
        quantile line links to."""
        with self._lock:
            if not self._exemplars:
                return None
            v, labels = max(self._exemplars, key=lambda e: e[0])
        return {'value': v, 'labels': dict(labels)}

    def stats(self):
        out = {'count': self._count, 'sum': self._sum, 'mean': self.mean,
               'min': self._min, 'max': self._max,
               'p50': self.percentile(50), 'p95': self.percentile(95)}
        ex = self.exemplar()
        if ex is not None:
            out['exemplar'] = ex
        return out


class Registry:
    """Name -> metric, create-once, kind-checked."""

    def __init__(self):
        self._metrics = {}
        self._lock = threading.Lock()

    def _get(self, name, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name)
            elif not isinstance(m, cls):
                raise TypeError('metric %r is a %s, requested as %s'
                                % (name, type(m).__name__, cls.__name__))
            return m

    def counter(self, name):
        return self._get(name, Counter)

    def gauge(self, name):
        return self._get(name, Gauge)

    def histogram(self, name):
        return self._get(name, Histogram)

    def get(self, name):
        """The metric registered under ``name``, or None."""
        return self._metrics.get(name)

    def names(self):
        return sorted(self._metrics)

    def snapshot(self):
        """Point-in-time {'counters': {...}, 'gauges': {...},
        'histograms': {name: stats-dict}} — the exporter's input."""
        with self._lock:
            items = list(self._metrics.items())
        out = {'counters': {}, 'gauges': {}, 'histograms': {}}
        for name, m in items:
            if isinstance(m, Counter):
                out['counters'][name] = m.value
            elif isinstance(m, Gauge):
                if m.value is not None:
                    out['gauges'][name] = m.value
            else:
                out['histograms'][name] = m.stats()
        return out

    def reset(self):
        with self._lock:
            self._metrics.clear()


class _NullCounter:
    """Shared do-nothing metric: the disabled-telemetry fast path hands
    these out so hot sites never branch beyond one enabled() check."""

    __slots__ = ()
    name = '<null>'
    value = 0.0

    def inc(self, n=1):
        pass


class _NullGauge:
    __slots__ = ()
    name = '<null>'
    value = None

    def set(self, v):
        pass


class _NullHistogram:
    __slots__ = ()
    name = '<null>'
    count = 0
    sum = 0.0
    mean = None
    min = None
    max = None

    def observe(self, v, exemplar=None):
        pass

    def percentile(self, p):
        return None

    def exemplar(self):
        return None

    def stats(self):
        return {'count': 0, 'sum': 0.0, 'mean': None, 'min': None,
                'max': None, 'p50': None, 'p95': None}


NULL_COUNTER = _NullCounter()
NULL_GAUGE = _NullGauge()
NULL_HISTOGRAM = _NullHistogram()
