"""Telemetry exporters, the counterpart of ``mxnet_tpu/telemetry/export.py``:
the append-only JSONL log and the human-readable summary table.

The JSONL sink is the machine-readable record: one JSON object per line,
each with a ``type`` ('start', 'span', 'event', 'trace', 'slo', 'hang',
'flight', 'goodput', 'timeline', 'health', 'anomaly', 'restart',
'dynamics', 'summary') and a ``t`` epoch-seconds stamp. Records buffer in
memory and flush every ``_FLUSH_EVERY`` lines or ``_FLUSH_SECS`` seconds
(and at shutdown). ``MXTPU_TELEMETRY_MAX_MB`` caps the file.

``summary_table`` renders a registry snapshot as the end-of-run table:
counters, gauges, the "where the time went" block (goodput), the "step
timeline" block, the "run health" block and histograms. The JAX table's
sections of planes that are not ported (programs, roofline, memory,
cluster, run ledger) are left out; for the same snapshot, goodput,
timeline and health the two tables are the same text.
"""
import json
import logging
import os
import threading
import time

__all__ = ['JsonlSink', 'summary_table']

_FLUSH_EVERY = 64
# ...and at least this often in wall time, so that a reader watching the
# file sees a slow loop's records
_FLUSH_SECS = 5.0

# Module-wide count of actual file I/O calls (open/write/flush) — the
# zero-overhead tests assert this stays put while telemetry is off.
_io_calls = 0


class JsonlSink:
    """Append-only JSONL writer; thread-safe, buffered.

    ``host`` (stamped when the sink opens) labels every record with this
    process's host index so multi-host logs merge on it. ``max_bytes`` (MXTPU_TELEMETRY_MAX_MB) caps the file:
    once the NEXT record would push the file past the cap, writing
    stops for good — metrics stay live in-process and the
    ``telemetry.dropped_records`` counter keeps the true drop count —
    so a week-long run cannot fill a disk."""

    def __init__(self, path, max_bytes=None):
        global _io_calls
        self.path = path
        self.host = None
        self._lock = threading.Lock()
        self._buf = []
        self._closed = False
        self._max_bytes = max_bytes
        self._capped = False
        self._last_flush = time.time()
        try:
            # append mode: what is already on disk counts against the cap
            self._bytes = os.path.getsize(path)
        except OSError:
            self._bytes = 0
        _io_calls += 1
        self._f = open(path, 'a')

    def _count_dropped(self):
        from . import _state
        if _state.active:
            _state.registry.counter('telemetry.dropped_records').inc()

    def emit(self, record):
        if self._closed:
            return
        record.setdefault('t', time.time())
        if self.host is not None:
            record.setdefault('host', self.host)
        # the flight recorder rides the emit chokepoint: everything
        # headed for the log (including records a capped sink drops)
        # enters the bounded in-memory ring too — one deque append
        from . import flight
        flight.note(record)
        if self._capped:
            self._count_dropped()
            self._heartbeat()
            return
        line = json.dumps(record)
        tripped = False
        raced = False
        with self._lock:
            if self._capped:
                # a concurrent emit tripped the cap between the
                # unlocked check and here — it owns the one warning,
                # this record is just another drop
                raced = True
            elif self._max_bytes is not None and \
                    self._bytes + len(line) + 1 > self._max_bytes:
                self._capped = True
                tripped = True
            else:
                self._bytes += len(line) + 1
                self._buf.append(line)
                if len(self._buf) >= _FLUSH_EVERY or \
                        record['t'] - self._last_flush >= _FLUSH_SECS:
                    self._flush_locked()
        if tripped:
            logging.warning(
                'telemetry: %s reached MXTPU_TELEMETRY_MAX_MB '
                '(%.1f MB) — no further JSONL records will be written; '
                'metrics stay live in-process and '
                'telemetry.dropped_records counts the drops',
                self.path, self._max_bytes / 2.0**20)
        if tripped or raced:
            self._count_dropped()

    def _heartbeat(self):
        """A capped sink appends nothing ever again, but a supervisor that
        watches the file reads 'file stopped changing' as 'process is
        wedged': touch the mtime (no growth, so the size cap's contract
        holds) at the flush cadence."""
        now = time.time()
        if now - self._last_flush < _FLUSH_SECS:
            return
        self._last_flush = now
        try:
            os.utime(self.path)
        except OSError:
            pass

    def _flush_locked(self):
        global _io_calls
        self._last_flush = time.time()
        if self._buf and not self._closed:
            _io_calls += 1
            self._f.write('\n'.join(self._buf) + '\n')
            self._f.flush()
            self._buf = []

    def flush(self):
        with self._lock:
            self._flush_locked()

    def close(self):
        with self._lock:
            self._flush_locked()
            if not self._closed:
                self._closed = True
                self._f.close()


def _fmt(v):
    if v is None:
        return '-'
    if isinstance(v, float):
        if v != v:   # nan
            return 'nan'
        if abs(v) >= 1e6 or (abs(v) < 1e-3 and v != 0):
            return '%.3e' % v
        return '%.3f' % v
    return str(v)


def _goodput_lines(good):
    """The "where the time went" block (telemetry.goodput's dict): one row a
    bucket with its seconds and share of the wall, the goodput verdict and
    the rework and provenance context."""
    lines = ['-- where the time went --']
    wall = float(good.get('wall_s') or 0.0)
    buckets = good.get('buckets') or {}
    # the canonical bucket order (telemetry.goodput.BUCKETS)
    order = ('step', 'compile', 'input_wait', 'checkpoint', 'eval',
             'comm', 'rework', 'overhead')
    names = [n for n in order if n in buckets]
    names += [n for n in sorted(buckets) if n not in order]
    for name in names:
        secs = float(buckets[name] or 0.0)
        pct = (100.0 * secs / wall) if wall > 0.0 else 0.0
        label = name
        if name == 'comm' and good.get('comm_source'):
            label = 'comm (%s)' % good['comm_source']
        lines.append('  %-18s  %9ss  %5.1f%%'
                     % (label, _fmt(round(secs, 3)), pct))
    lines.append('  %-18s  %9ss' % ('wall', _fmt(round(wall, 3))))
    verdict = 'goodput           %s%%' % _fmt(good.get('goodput_pct'))
    if good.get('badput_top'):
        verdict += ' (top badput: %s)' % good['badput_top']
    lines.append('  %s' % verdict)
    if good.get('rework_steps'):
        lines.append('  rework_steps      %d' % int(good['rework_steps']))
    if good.get('prior_lost_s'):
        lines.append('  prior_lost        %ss across relaunches -> '
                     'job goodput %s%% of %ss'
                     % (_fmt(good['prior_lost_s']),
                        _fmt(good.get('job_goodput_pct')),
                        _fmt(good.get('job_wall_s'))))
    return lines


def _timeline_lines(tl):
    """The "step timeline" block (telemetry.timeline's attribution dict):
    one decomposition row a host (the step split into compute, collective
    wait, io and host-side time, and the clock offset), then the skew and
    the gating host and phase."""
    lines = ['-- step timeline --']
    lines.append('  hosts             %s' % tl.get('hosts'))
    per = tl.get('per_host') or []
    if per:
        lines.append('  host   step_ms    compute    collect    io    '
                     '     host_side  offset_ms')
        crit = tl.get('critical_host')
        for r in per:
            mark = '*' if (r.get('host') == crit and len(per) > 1) else ''
            lines.append('  %-5s  %-9s  %-9s  %-9s  %-9s  %-9s  %s'
                         % ('%s%s' % (r.get('host'), mark),
                            _fmt(r.get('step_time_ms')),
                            _fmt(r.get('compute_ms')),
                            _fmt(r.get('collective_ms')),
                            _fmt(r.get('io_ms')),
                            _fmt(r.get('host_ms')),
                            _fmt(r.get('clock_offset_ms'))))
    if tl.get('skew_ms') is not None:
        lines.append('  skew              %s ms/step (fastest-host idle '
                     'at the allreduce)' % _fmt(float(tl['skew_ms'])))
    if tl.get('critical_phase') is not None:
        line = '  critical_path     host %s %s' % (tl.get('critical_host'),
                                                   tl['critical_phase'])
        if tl.get('phase_excess_ms') is not None:
            if (tl.get('hosts') or 1) > 1:
                line += ' (+%s ms/step of skew)' \
                    % _fmt(float(tl['phase_excess_ms']))
            else:
                line += ' (%s ms/step)' % _fmt(float(tl['phase_excess_ms']))
        lines.append(line)
    return lines


def _health_lines(health):
    """The "run health" block (telemetry.health.snapshot_health's dict):
    non-finite incidents, anomaly counts, the last anomaly, restarts, hangs
    and the input-bound share."""
    lines = ['-- run health --']
    n_bad = int(health.get('nonfinite_steps') or 0)
    lines.append('  status            %s'
                 % ('DEGRADED (%d non-finite step%s)'
                    % (n_bad, 's' if n_bad != 1 else '')
                    if n_bad else 'ok'))
    incidents = health.get('incidents') or []
    if incidents:
        first = incidents[0]
        desc = '%s' % first.get('source', '?')
        if first.get('step') is not None:
            desc += ' step %s' % first['step']
        if first.get('window_step') is not None:
            desc += ' (window step %d)' % first['window_step']
        if first.get('first_bad_layer'):
            desc += ': first non-finite symbol %s' % first['first_bad_layer']
        lines.append('  first_incident    %s' % desc)
    counts = health.get('anomaly_counts') or {}
    if counts:
        lines.append('  anomalies         %s'
                     % ', '.join('%s=%d' % (k, counts[k])
                                 for k in sorted(counts)))
    last = health.get('last_anomaly')
    if last:
        lines.append('  last_anomaly      %s=%s (baseline %s)'
                     % (last.get('detector', '?'), _fmt(last.get('value')),
                        _fmt(last.get('baseline'))))
    if health.get('restarts'):
        lines.append('  restarts          %d' % int(health['restarts']))
    if health.get('hangs'):
        lines.append('  hangs             %d' % int(health['hangs']))
    if health.get('input_bound_pct') is not None:
        lines.append('  input_bound_pct   %s'
                     % _fmt(float(health['input_bound_pct'])))
    return lines


def summary_table(snapshot, elapsed_s=None, goodput=None, timeline=None,
                  health=None):
    """Registry snapshot -> aligned text table (one block per kind).
    ``goodput`` is telemetry.goodput's dict, rendered as the "where the time
    went" block, ``timeline`` telemetry.timeline's attribution, rendered
    as the "step timeline" block, and ``health``
    telemetry.health.snapshot_health()'s dict, rendered as the "run health"
    block; the ``goodput.*`` and ``timeline.*`` gauges that those blocks
    carry are left out of the gauges block."""
    lines = ['== telemetry summary%s ==' %
             (' (%.1fs)' % elapsed_s if elapsed_s is not None else '')]
    counters = snapshot.get('counters', {})
    gauges = snapshot.get('gauges', {})
    hists = snapshot.get('histograms', {})
    if goodput:
        gauges = {n: v for n, v in gauges.items()
                  if not n.startswith('goodput.')}
    if timeline:
        gauges = {n: v for n, v in gauges.items()
                  if not n.startswith('timeline.')}
    if counters:
        lines.append('-- counters --')
        w = max(len(n) for n in counters)
        for name in sorted(counters):
            lines.append('  %-*s  %s' % (w, name, _fmt(counters[name])))
    if gauges:
        lines.append('-- gauges --')
        w = max(len(n) for n in gauges)
        for name in sorted(gauges):
            lines.append('  %-*s  %s' % (w, name, _fmt(gauges[name])))
    if goodput:
        lines.extend(_goodput_lines(goodput))
    if timeline:
        lines.extend(_timeline_lines(timeline))
    if health:
        lines.extend(_health_lines(health))
    if hists:
        lines.append('-- histograms (ms) --')
        w = max(len(n) for n in hists)
        lines.append('  %-*s  %8s %10s %10s %10s %10s' %
                     (w, 'name', 'count', 'mean', 'p50', 'p95', 'max'))
        for name in sorted(hists):
            st = hists[name]
            lines.append('  %-*s  %8s %10s %10s %10s %10s' %
                         (w, name, _fmt(st['count']), _fmt(st['mean']),
                          _fmt(st['p50']), _fmt(st['p95']),
                          _fmt(st['max'])))
    if len(lines) == 1:
        lines.append('  (no metrics recorded)')
    return '\n'.join(lines)
