"""Live telemetry plane, the counterpart of ``mxnet_tpu/telemetry/serve.py``:
/metrics, /healthz and /summary over HTTP.

- ``/metrics`` — the registry snapshot (counters, gauges, histograms) in
  Prometheus text exposition format, every sample labeled with this
  process's ``host`` index;
- ``/healthz`` — 200 while healthy; 503 while the hang watchdog says
  the loop is stalled (``hung``), the SLO plane's error budget is burning
  (``slo_degraded``) or the health sentinels have recorded a non-finite
  step (``degraded``), with the digest (the health snapshot among it) as
  the JSON body;
- ``/summary`` — the registry snapshot, the health, dynamics and SLO
  snapshots and the rendered summary table, as JSON.

The JAX package's endpoint also reports planes that are not ported
(memory pressure, the cluster round, programs, roofline, ledger, goodput,
timeline); their keys are left out of these payloads.

Transport is stdlib ``http.server`` (ThreadingHTTPServer) on a daemon
thread. Gating: ``MXTPU_TELEMETRY=1`` *and* ``MXTPU_TELEMETRY_PORT`` set
(0 binds an OS-assigned ephemeral port; -1/unset = off): with the port
unset or telemetry off, no thread or socket is ever created. Scrapes only
READ registry state (handler errors answer 500).
"""
import json
import logging
import re
import threading

__all__ = ['maybe_start', 'start', 'stop', 'port', 'render_prometheus',
           'healthz_payload', 'summary_payload', 'bind_address']

_CONTENT_PROM = 'text/plain; version=0.0.4; charset=utf-8'
_THREAD_NAME = 'mxtpu-telemetry-serve'

_server = None
_thread = None
_lock = threading.Lock()


def _tele():
    """The telemetry package state (deciding it from the flag first)."""
    from . import enabled as _tele_enabled, _state as st
    _tele_enabled()
    return st


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

def _prom_name(name):
    return 'mxtpu_' + re.sub(r'[^a-zA-Z0-9_]', '_', name)


def _prom_num(v):
    """Prometheus sample value, or None for non-numeric gauges."""
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    f = float(v)
    if f != f:
        return 'NaN'
    if f == float('inf'):
        return '+Inf'
    if f == float('-inf'):
        return '-Inf'
    if f == int(f) and abs(f) < 1e15:
        return '%d' % int(f)
    return repr(f)


def _prom_label_val(v):
    """A value escaped for a Prometheus label position (text format
    0.0.4: backslash, double-quote and newline must be escaped, in that
    order — an info-style gauge carrying a path or an error string must
    not break the whole scrape)."""
    return str(v).replace('\\', '\\\\').replace('"', '\\"') \
        .replace('\n', '\\n')


def render_prometheus(snapshot, host=None):
    """A registry snapshot as Prometheus text exposition (format 0.0.4).

    Counters render with the conventional ``_total`` suffix, histograms
    as summaries carrying the recent-window p50/p95 quantiles plus
    ``_sum``/``_count`` (values are milliseconds, hence the ``_ms``
    suffix). Every sample is labeled ``host="<process index>"`` so a
    Prometheus scraping all hosts of a multi-host job can aggregate and
    diff them. Non-numeric gauges (e.g. ``cluster.straggler_class``)
    render info-style: value in a label, sample fixed at 1."""
    hl = 'host="%s"' % host if host is not None else ''

    def lbl(extra=''):
        parts = [p for p in (hl, extra) if p]
        return '{%s}' % ','.join(parts) if parts else ''

    lines = []
    counters = snapshot.get('counters', {})
    for name in sorted(counters):
        m = _prom_name(name) + '_total'
        lines.append('# HELP %s mxnet_tpu counter %s' % (m, name))
        lines.append('# TYPE %s counter' % m)
        lines.append('%s%s %s' % (m, lbl(), _prom_num(counters[name])))
    gauges = snapshot.get('gauges', {})
    for name in sorted(gauges):
        v = gauges[name]
        m = _prom_name(name)
        lines.append('# HELP %s mxnet_tpu gauge %s' % (m, name))
        lines.append('# TYPE %s gauge' % m)
        num = _prom_num(v)
        if num is None:
            lines.append('%s%s 1'
                         % (m, lbl('value="%s"' % _prom_label_val(v))))
        else:
            lines.append('%s%s %s' % (m, lbl(), num))
    hists = snapshot.get('histograms', {})
    for name in sorted(hists):
        st = hists[name]
        m = _prom_name(name) + '_ms'
        lines.append('# HELP %s mxnet_tpu span histogram %s '
                     '(milliseconds; quantiles over the recent window)'
                     % (m, name))
        lines.append('# TYPE %s summary' % m)
        for q, key in (('0.5', 'p50'), ('0.95', 'p95')):
            if st.get(key) is not None:
                lines.append('%s%s %s' % (m, lbl('quantile="%s"' % q),
                                          _prom_num(st[key])))
        # exemplar: a sibling info-style gauge (NOT an OpenMetrics '#'
        # suffix — the 0.0.4 text format this endpoint declares has no
        # exemplar syntax, and a strict scraper would fail the whole
        # scrape on one). The highest-valued recent exemplar-carrying
        # observation lands with its labels, so a scraped p95/p99
        # still links to a concrete trace id
        ex = st.get('exemplar')
        if ex and ex.get('labels'):
            em = m + '_exemplar'
            lines.append('# HELP %s mxnet_tpu exemplar for %s (recent '
                         'high sample and the trace that produced it)'
                         % (em, name))
            lines.append('# TYPE %s gauge' % em)
            lines.append('%s%s %s' % (
                em,
                lbl(','.join('%s="%s"'
                             % (k, _prom_label_val(ex['labels'][k]))
                             for k in sorted(ex['labels']))),
                _prom_num(float(ex['value']))))
        lines.append('%s_sum%s %s' % (m, lbl(),
                                      _prom_num(float(st.get('sum') or 0.0))))
        lines.append('%s_count%s %s' % (m, lbl(),
                                        _prom_num(int(st.get('count') or 0))))
    return '\n'.join(lines) + '\n'


# ---------------------------------------------------------------------------
# endpoint payloads
# ---------------------------------------------------------------------------

def healthz_payload():
    """(ok, digest) for /healthz. ``ok`` flips False — the endpoint
    answers 503 — while the hang watchdog says the loop is stalled right
    now, the SLO plane's error budget is burning, or the health sentinels
    have seen a non-finite step (so a warn-action NaN run is visible). The
    states are distinct (``hung`` / ``slo_degraded`` / ``degraded``) so a
    supervisor or load balancer can choose its reaction; the hang and SLO
    states clear on recovery. The digest carries the health snapshot."""
    from . import cluster, watchdog, slo, health
    st = _tele()
    hs = health.snapshot_health(input_bound=health.input_bound_pct()) \
        if st.active else None
    bad = int(hs.get('nonfinite_steps') or 0) if hs else 0
    hang = watchdog.hang_info()
    slo_bad = slo.degraded()
    body = {
        'status': 'hung' if hang is not None
        else ('slo_degraded' if slo_bad is not None
              else ('ok' if not bad else 'degraded')),
        'telemetry': bool(st.active),
        'health_sentinels': bool(health.enabled()),
        'host': cluster.host_index(),
    }
    if hang is not None:
        body['hang'] = hang
    if hs is not None:
        body['health'] = hs
    slo_snap = slo.snapshot_slo()
    if slo_snap is not None:
        body['slo'] = slo_snap
    return bad == 0 and hang is None and slo_bad is None, body


def summary_payload():
    """The /summary JSON: the registry snapshot, the health, dynamics and
    SLO snapshots, read-only, plus the rendered summary table."""
    import time
    from . import cluster, slo, health, dynamics
    from .export import summary_table
    st = _tele()
    snap = st.registry.snapshot()
    elapsed = (time.time() - st.t_start) if st.t_start else None
    hs = health.snapshot_health(input_bound=health.input_bound_pct())
    return {
        'elapsed_s': round(elapsed, 3) if elapsed is not None else None,
        'host': cluster.host_index(),
        'snapshot': snap,
        'health': hs,
        'dynamics': dynamics.snapshot_dynamics(),
        'slo': slo.snapshot_slo(),
        'table': summary_table(snap, elapsed, health=hs),
    }


# ---------------------------------------------------------------------------
# HTTP plumbing
# ---------------------------------------------------------------------------

def _make_handler():
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        server_version = 'mxtpu-telemetry'

        def log_message(self, fmt, *args):   # no stderr line per scrape
            logging.debug('telemetry.serve: ' + fmt, *args)

        def _send(self, code, body, ctype):
            data = body.encode('utf-8')
            self.send_response(code)
            self.send_header('Content-Type', ctype)
            self.send_header('Content-Length', str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            path = self.path.split('?', 1)[0].rstrip('/') or '/'
            try:
                if path == '/metrics':
                    from . import cluster
                    body = render_prometheus(_tele().registry.snapshot(),
                                             host=cluster.host_index())
                    self._send(200, body, _CONTENT_PROM)
                elif path == '/healthz':
                    ok, digest = healthz_payload()
                    self._send(200 if ok else 503,
                               json.dumps(digest, indent=2) + '\n',
                               'application/json')
                elif path == '/summary':
                    self._send(200,
                               json.dumps(summary_payload(), indent=2)
                               + '\n', 'application/json')
                elif path == '/':
                    self._send(200, 'mxnet_tpu telemetry endpoints: '
                               '/metrics /healthz /summary\n', 'text/plain')
                else:
                    self._send(404, 'not found\n', 'text/plain')
            except Exception as e:  # noqa: BLE001 — a scrape must not kill
                logging.debug('telemetry.serve: handler failed: %s', e)
                try:
                    self._send(500, 'internal error\n', 'text/plain')
                except Exception:  # noqa: BLE001
                    pass

    return Handler


def maybe_start():
    """Start the endpoint iff telemetry is on AND MXTPU_TELEMETRY_PORT
    is set (>= 0). Called from telemetry's decide path; with the port
    unset (or telemetry off) this touches no socket and spawns no
    thread. Returns the bound port, or None."""
    if not _tele().active:
        return None
    from ..config import flags
    flags.reload('MXTPU_TELEMETRY_PORT')
    p = flags.get('MXTPU_TELEMETRY_PORT')
    if p < 0:
        return None
    return start(p)


def bind_address(flag):
    """The address a bind flag names (MXTPU_TELEMETRY_BIND,
    MXTPU_SERVE_BIND): loopback by default — exposing an endpoint to the
    network is an explicit opt-in; '0.0.0.0' or empty = all interfaces."""
    from ..config import flags
    flags.reload(flag)
    addr = flags.get(flag).strip()
    return '' if addr == '0.0.0.0' else addr


def start(port_):
    """Bind and serve on a daemon thread; idempotent (returns the
    already-bound port). ``port_=0`` asks the OS for an ephemeral port;
    the bind address comes from MXTPU_TELEMETRY_BIND (loopback unless
    opted out). A bind failure warns and returns None — observability
    must not take the run down."""
    global _server, _thread
    with _lock:
        if _server is not None:
            return _server.server_address[1]
        from http.server import ThreadingHTTPServer
        try:
            srv = ThreadingHTTPServer((bind_address('MXTPU_TELEMETRY_BIND'),
                                       int(port_)),
                                      _make_handler())
        except OSError as e:
            logging.warning('telemetry: cannot bind the live endpoint on '
                            'port %s (%s) — live scraping disabled for '
                            'this run', port_, e)
            return None
        srv.daemon_threads = True
        _server = srv
        _thread = threading.Thread(target=srv.serve_forever,
                                   name=_THREAD_NAME, daemon=True)
        _thread.start()
        bound = srv.server_address[1]
    logging.info('telemetry: live endpoint on :%d '
                 '(/metrics /healthz /summary)', bound)
    return bound


def port():
    """The live endpoint's bound port, or None while it is not up."""
    with _lock:
        return _server.server_address[1] if _server is not None else None


def stop():
    """Shut the endpoint down (telemetry.shutdown / test resets).
    No-op when it never started."""
    global _server, _thread
    with _lock:
        srv, th = _server, _thread
        _server = _thread = None
    if srv is not None:
        try:
            srv.shutdown()
            srv.server_close()
        except Exception:  # noqa: BLE001
            pass
    if th is not None:
        th.join(timeout=5)
