"""The port's telemetry core (``mxnet_tpu_torch/telemetry``) against the JAX
package's (``mxnet_tpu/telemetry``) on the CPU.

Parity, exact: the registry's snapshot after the same observations, the
Prometheus text ``render_prometheus`` gives for the same snapshot, the
summary table of the same snapshot, the ids ``trace.from_headers`` reads
from the same headers, and the SLO plane's gauges, verdicts and
``degraded()`` state over the same request stream. The port's own
contracts: the no-op path with telemetry off, spans and the JSONL sink
(with its size cap), the flight recorder's ring and dumps, the watchdog's
stall flipping /healthz to ``hung``, the live endpoint, and the unported
planes raising NotImplementedError. Every wait carries a timeout.
"""
import json
import os
import time
import urllib.error
import urllib.request

import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import telemetry as jtele
from mxnet_tpu.telemetry import export as jexport
from mxnet_tpu.telemetry import serve as jserve
from mxnet_tpu.telemetry.registry import Registry as JRegistry
from mxnet_tpu_torch import telemetry as ttele
from mxnet_tpu_torch.telemetry import export as texport
from mxnet_tpu_torch.telemetry import serve as tserve
from mxnet_tpu_torch.telemetry.registry import Registry as TRegistry

TELE_FLAGS = ('MXTPU_TELEMETRY', 'MXTPU_TELEMETRY_PATH',
              'MXTPU_TELEMETRY_MAX_MB', 'MXTPU_TELEMETRY_PORT',
              'MXTPU_FLIGHT_RECORDER', 'MXTPU_SLO_LATENCY_MS',
              'MXTPU_SLO_ERROR_PCT', 'MXTPU_SLO_WINDOW',
              'MXTPU_WATCHDOG_SECS', 'MXTPU_WATCHDOG_ACTION')


def _reset_both():
    mx.config.flags.reload()
    mt.config.flags.reload()
    jtele._reset_for_tests()
    ttele._reset_for_tests()


@pytest.fixture
def tele(tmp_path, monkeypatch):
    """Telemetry on in both packages, the log in a temporary directory (a
    test that sets more flags calls ``_reset_both`` after them)."""
    for name in TELE_FLAGS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv('MXTPU_TELEMETRY', '1')
    monkeypatch.setenv('MXTPU_TELEMETRY_PATH', str(tmp_path / 't.jsonl'))
    _reset_both()
    yield tmp_path
    for name in TELE_FLAGS:
        monkeypatch.delenv(name, raising=False)
    _reset_both()


@pytest.fixture
def tele_off(monkeypatch):
    for name in TELE_FLAGS:
        monkeypatch.delenv(name, raising=False)
    _reset_both()
    yield
    _reset_both()


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# ---------------------------------------------------------------------------
# registry, Prometheus text, summary table
# ---------------------------------------------------------------------------

def _feed(reg):
    """The same observations into either package's Registry."""
    reg.counter('serve.requests').inc()
    reg.counter('serve.requests').inc(4)
    reg.counter('serve.rows').inc(2.5)
    reg.counter('serve.zero')
    reg.gauge('serve.queue_depth').set(3)
    reg.gauge('serve.pad_fraction').set(0.125)
    reg.gauge('slo.degraded').set(0)
    reg.gauge('never.set')
    reg.gauge('info.path').set('a "quoted"\\path\nline')
    reg.gauge('flag.on').set(True)
    h = reg.histogram('serve.request_latency')
    for i, v in enumerate([5.0, 1.25, 9.5, 3.0, 7.75, 2.0, 4.5]):
        h.observe(v, exemplar={'trace_id': 'id%d' % i} if i % 2 else None)
    reg.histogram('serve.build').observe(12.0)
    reg.histogram('serve.empty')
    return reg


def test_registry_snapshot_matches_jax():
    j, t = _feed(JRegistry()), _feed(TRegistry())
    assert t.snapshot() == j.snapshot()
    assert t.names() == j.names()
    h = t.histogram('serve.request_latency')
    for p in (0, 50, 95, 99, 100):
        assert h.percentile(p) == j.histogram('serve.request_latency') \
            .percentile(p)
    for reg in (j, t):
        with pytest.raises(TypeError, match='requested as'):
            reg.gauge('serve.requests')
    from mxnet_tpu.telemetry import registry as jr
    from mxnet_tpu_torch.telemetry import registry as tr
    assert tr.NULL_HISTOGRAM.stats() == jr.NULL_HISTOGRAM.stats()
    assert tr.NULL_COUNTER.value == jr.NULL_COUNTER.value


def test_histogram_window_matches_jax():
    """Past the ring's capacity both keep the same recent window."""
    j, t = JRegistry().histogram('h'), TRegistry().histogram('h')
    for i in range(8192 + 300):
        v = (i * 7919) % 1000 / 10.0
        j.observe(v)
        t.observe(v)
    assert t.stats() == j.stats()


_ODD_SNAPSHOTS = [
    {},
    {'counters': {'a.b': 0.0, 'big': 1e16, 'frac': 0.1}},
    {'gauges': {'nan': float('nan'), 'inf': float('inf'),
                'ninf': float('-inf'), 'neg': -2, 'text': 'x\\y"z\n',
                'none_kind': [1, 2], 'b': False}},
    {'histograms': {'h': {'count': 0, 'sum': 0.0, 'mean': None,
                          'min': None, 'max': None, 'p50': None,
                          'p95': None}}},
    {'histograms': {'h-x/y': {'count': 3, 'sum': 6.5, 'mean': 2.1,
                              'min': 1.0, 'max': 3.0, 'p50': 2.0,
                              'p95': 3.0,
                              'exemplar': {'value': 3.0, 'labels': {
                                  'trace_id': 't"1', 'b': 'x'}}}}},
]


@pytest.mark.parametrize('host', [None, 0, 3])
@pytest.mark.parametrize('which', range(len(_ODD_SNAPSHOTS) + 1))
def test_render_prometheus_matches_jax(which, host):
    snap = (_ODD_SNAPSHOTS[which] if which < len(_ODD_SNAPSHOTS)
            else _feed(JRegistry()).snapshot())
    assert tserve.render_prometheus(snap, host=host) == \
        jserve.render_prometheus(snap, host=host)


@pytest.mark.parametrize('elapsed', [None, 12.345])
def test_summary_table_matches_jax(elapsed):
    for snap in ({}, _feed(JRegistry()).snapshot(),
                 {'gauges': {'x': 1e-5, 'y': 2e7, 'z': float('nan')}}):
        assert texport.summary_table(snap, elapsed) == \
            jexport.summary_table(snap, elapsed)


# ---------------------------------------------------------------------------
# request tracing and the SLO plane
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('headers', [
    None, {}, {'X-Request-Id': 'req-42'},
    {'X-Request-Id': '  spaced id/with:odd*chars  '},
    {'X-Request-Id': 'x' * 100}, {'X-Request-Id': '   '},
    {'traceparent': '00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01'},
    {'traceparent': '00-4BF92F3577B34DA6A3CE929D0E0E4736-00F067AA0BA902B7-01'},
    {'traceparent': 'garbage'},
    {'X-Request-Id': 'wins',
     'traceparent': '00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01'},
])
def test_from_headers_matches_jax(headers):
    from mxnet_tpu.telemetry import trace as jtrace
    from mxnet_tpu_torch.telemetry import trace as ttrace
    assert ttrace.from_headers(headers) == jtrace.from_headers(headers)
    assert ttrace.STAGES == jtrace.STAGES


def test_trace_record(tele):
    from mxnet_tpu_torch.telemetry import trace as ttrace
    tr = ttrace.start('abc', rows=2)
    tr.add('queue_wait', 1.5)
    tr.add_shared('span1', {'pad_ms': 0.25, 'dispatch_ms': 2.0,
                            'other_ms': 9.0})
    rec = tr.finish()
    assert tr.finish() is None                      # idempotent
    assert rec['trace_id'] == 'abc' and rec['dispatch_span'] == 'span1'
    assert rec['stages'] == {'queue_wait_ms': 1.5, 'pad_ms': 0.25,
                             'dispatch_ms': 2.0}
    ttele.shutdown()
    assert any(r['type'] == 'trace' and r['trace_id'] == 'abc'
               for r in _records(tele / 't.jsonl'))


# (latency objective ms, error budget %, window): each stream runs through
# both packages' SLO planes request by request
SLO_CASES = [(10.0, 0.0, 16), (0.0, 5.0, 16), (10.0, 25.0, 32),
             (0.0, 0.0, 16)]


def _slo_stream():
    """40 healthy requests, 30 slow or failing ones, 60 healthy: the
    window fills, degrades and recovers."""
    out = [(3.0, False)] * 40
    out += [(50.0, False) if i % 2 else (2.0, True) for i in range(30)]
    out += [(1.0, False)] * 60
    return out


@pytest.mark.parametrize('lat,err,window', SLO_CASES)
def test_slo_matches_jax(tele, monkeypatch, lat, err, window):
    from mxnet_tpu.telemetry import slo as jslo
    from mxnet_tpu_torch.telemetry import slo as tslo
    monkeypatch.setenv('MXTPU_SLO_LATENCY_MS', str(lat))
    monkeypatch.setenv('MXTPU_SLO_ERROR_PCT', str(err))
    monkeypatch.setenv('MXTPU_SLO_WINDOW', str(window))
    _reset_both()
    assert tslo.enabled() == jslo.enabled() == (lat > 0 or err > 0)
    states = []
    for ms, bad in _slo_stream():
        verdicts = (tslo.note_request(ms, error=bad),
                    jslo.note_request(ms, error=bad))
        assert verdicts[0] == verdicts[1]
        assert tslo.degraded() == jslo.degraded()
        assert tslo.snapshot_slo() == jslo.snapshot_slo()
        states.append(tslo.degraded() is not None)
    slo_gauges = [{k: v for k, v in tele_mod.snapshot()['gauges'].items()
                   if k.startswith('slo.')} for tele_mod in (ttele, jtele)]
    assert slo_gauges[0] == slo_gauges[1]
    if lat > 0 or err > 0:
        assert any(states) and not states[-1]       # degraded, recovered
        assert os.path.exists(tele / 'flight-slo-burn.jsonl')
    else:
        assert not any(states) and not slo_gauges[0]


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------

def test_off_is_a_no_op(tele_off, tmp_path, monkeypatch):
    from mxnet_tpu_torch.telemetry import flight, registry, slo, trace
    monkeypatch.setenv('MXTPU_TELEMETRY_PATH', str(tmp_path / 'off.jsonl'))
    monkeypatch.setenv('MXTPU_TELEMETRY_PORT', '0')
    mt.config.flags.reload()
    assert not ttele.enabled()
    assert ttele.counter('a') is registry.NULL_COUNTER
    assert ttele.gauge('a') is registry.NULL_GAUGE
    assert ttele.histogram('a') is registry.NULL_HISTOGRAM
    with ttele.span('x'):
        assert ttele.current_span_path() is None
    ttele.event('e', a=1)
    assert trace.start('id') is None
    assert not slo.enabled() and slo.note_request(1e9, error=True) is None
    assert not flight.enabled() and flight.dump('x') is None
    assert ttele.write_summary() is None
    assert ttele.snapshot() == {'counters': {}, 'gauges': {},
                                'histograms': {}}
    assert tserve.port() is None
    assert not os.path.exists(tmp_path / 'off.jsonl')


def test_spans_events_and_summary(tele):
    with ttele.span('outer', 'serve'):
        with ttele.span('inner'):
            assert ttele.current_span_path() == 'outer/inner'
        assert ttele.current_span_path() == 'outer'
    assert ttele.current_span_path() is None
    ttele.counter('serve.requests').inc(3)
    ttele.event('note', value=7)
    table = ttele.write_summary(log=False)
    assert 'serve.requests' in table and 'inner' in table
    assert ttele.summary().splitlines()[1:] == table.splitlines()[1:]
    snap = ttele.snapshot()
    assert snap['histograms']['inner']['count'] == 1
    ttele.shutdown()
    recs = _records(tele / 't.jsonl')
    kinds = [r['type'] for r in recs]
    assert kinds[0] == 'start' and kinds[-1] == 'summary'
    spans = {r['path'] for r in recs if r['type'] == 'span'}
    assert spans == {'outer', 'outer/inner'}
    assert all(r['host'] == 0 and 't' in r for r in recs)
    assert {'type': 'event', 'name': 'note', 'value': 7} == \
        {k: v for k, v in recs[kinds.index('event')].items()
         if k not in ('t', 'host')}


def test_sink_size_cap(tele, monkeypatch):
    monkeypatch.setenv('MXTPU_TELEMETRY_MAX_MB', str(2000 / 2**20))
    _reset_both()
    for i in range(200):
        ttele.event('filler', i=i, pad='x' * 40)
    ttele.shutdown()
    size = os.path.getsize(tele / 't.jsonl')
    assert 0 < size <= 2000
    assert ttele.snapshot()['counters']['telemetry.dropped_records'] > 100


def test_flight_recorder(tele, monkeypatch):
    from mxnet_tpu_torch.telemetry import flight
    monkeypatch.setenv('MXTPU_FLIGHT_RECORDER', '8')
    _reset_both()
    for i in range(20):
        ttele.event('e', i=i)
    ring = flight.snapshot_flight()
    assert [r['i'] for r in ring] == list(range(12, 20))
    paths = [flight.dump('test', extra={'why': 'x'}) for _ in range(7)]
    assert paths[:5] == [str(tele / 'flight-test.jsonl')] * 5
    assert paths[5:] == [None, None]            # five dumps per reason
    recs = _records(tele / 'flight-test.jsonl')
    assert recs[0]['type'] == 'flight' and recs[0]['why'] == 'x'
    assert recs[0]['records'] == 8 and len(recs) == 9


def test_watchdog_stall_flips_healthz(tele, monkeypatch):
    from mxnet_tpu_torch.telemetry import watchdog
    monkeypatch.setenv('MXTPU_WATCHDOG_SECS', '0.2')
    _reset_both()
    assert tserve.healthz_payload()[0]
    watchdog.note_progress('serve.dispatch')
    deadline = time.monotonic() + 20
    while watchdog.hang_info() is None and time.monotonic() < deadline:
        time.sleep(0.05)
    ok, body = tserve.healthz_payload()
    assert not ok and body['status'] == 'hung'
    assert body['hang']['last_progress'] == 'serve.dispatch'
    assert os.path.exists(tele / 'flight-hang.jsonl')
    assert any(r['type'] == 'hang' for r in _records(tele / 't.jsonl'))
    watchdog.note_progress('serve.dispatch')        # progress: recovered
    assert tserve.healthz_payload()[0]
    assert watchdog.snapshot_watchdog()['active'] is False


def _get(port, path):
    try:
        with urllib.request.urlopen('http://127.0.0.1:%d%s' % (port, path),
                                    timeout=10) as r:
            return r.status, r.read().decode('utf-8')
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode('utf-8')


def test_live_endpoint(tele, monkeypatch):
    monkeypatch.setenv('MXTPU_TELEMETRY_PORT', '0')
    _reset_both()
    try:
        assert ttele.enabled()
        port = tserve.port()
        assert port
        ttele.counter('serve.requests').inc(2)
        code, body = _get(port, '/metrics')
        assert code == 200
        assert 'mxtpu_serve_requests_total{host="0"} 2' in body
        code, body = _get(port, '/healthz')
        assert code == 200 and json.loads(body)['status'] == 'ok'
        code, body = _get(port, '/summary')
        assert code == 200 and 'serve.requests' in json.loads(body)['table']
        assert _get(port, '/nope')[0] == 404
    finally:
        tserve.stop()
    assert tserve.port() is None


@pytest.mark.parametrize('name', ['xla', 'programs', 'health', 'roofline',
                                  'memory', 'dynamics', 'ledger'])
def test_unported_planes_raise(name):
    """The planes still to port raise naming their ROADMAP.md item; the
    health and dynamics planes, which raised until they were ported, are
    the JAX package's by their public names."""
    if name in ('health', 'dynamics'):
        assert getattr(ttele, name).__all__ == getattr(jtele, name).__all__
        assert name in ttele.__all__
    else:
        with pytest.raises(NotImplementedError, match='item 13'):
            getattr(ttele, name)
    with pytest.raises(AttributeError):
        getattr(ttele, 'no_such_plane')


def test_cluster_keeps_host_index_only():
    assert ttele.cluster.host_index() == 0
    with pytest.raises(NotImplementedError, match='item 13'):
        ttele.cluster.snapshot_cluster()
