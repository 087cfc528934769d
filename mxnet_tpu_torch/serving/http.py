"""HTTP front end of the serving plane, the counterpart of
``mxnet_tpu/serving/http.py``: /predict, /models, /metrics, /healthz.

The same transport as ``telemetry/serve.py`` (stdlib ThreadingHTTPServer
on a daemon thread, loopback bind by default via ``MXTPU_SERVE_BIND``,
handler errors answer 5xx instead of killing the process). Every ``POST
/predict`` submits into the :class:`~.batcher.DynamicBatcher`, so
concurrent HTTP clients coalesce into shared padded device dispatches
(each handler runs on its own thread; the batcher queue is the meeting
point).

Endpoints:

- ``POST /predict`` — body either JSON (``{"data": [[...], ...]}`` for
  the single-input case, or ``{"inputs": {"<name>": [[...]], ...}}``)
  or a raw ``.npy`` payload (Content-Type ``application/x-npy`` or
  ``application/octet-stream``, single input). Answers JSON
  ``{"outputs": [...], "rows": N}`` with one nested list per graph
  output, pad rows already stripped — or, with ``Accept:
  application/x-npy``, the FIRST graph output as a raw ``.npy`` body
  (headers ``X-Rows`` and ``X-Outputs`` carry the row/output counts). A
  client-supplied ``X-Request-Id`` (or W3C ``traceparent``) becomes the
  request's trace id (telemetry/trace.py) and is echoed back as
  ``X-Request-Id``; with telemetry on and no client id, a minted id is
  echoed instead;
- ``GET /models`` — the engine description (name, bucket ladder,
  input/output signature, warm state);
- ``GET /metrics`` — Prometheus text exposition of the telemetry
  registry (``telemetry/serve.py``'s renderer), so the ``serve.*``
  family is scrapeable from the serving port;
- ``GET /healthz`` — a small JSON digest (requests served, queue depth,
  SLO state): 200 while healthy, 503 with status ``slo_degraded`` while
  the SLO plane reports the error budget burning.
"""
import io
import json
import logging
import threading

import numpy as np

__all__ = ['start_server', 'ServingServer']

_NPY_TYPES = ('application/x-npy', 'application/octet-stream')


def _parse_predict_body(body, ctype, data_names):
    """The request's input arrays, in the engine's data-name order."""
    if (ctype or '').split(';', 1)[0].strip().lower() in _NPY_TYPES:
        return [np.load(io.BytesIO(body), allow_pickle=False)]
    payload = json.loads(body.decode('utf-8'))
    if not isinstance(payload, dict):
        raise ValueError('JSON body must be an object')
    if 'inputs' in payload:
        inputs = payload['inputs']
        missing = [n for n in data_names if n not in inputs]
        if missing:
            raise ValueError('missing inputs: %s' % missing)
        return [np.asarray(inputs[n]) for n in data_names]
    if 'data' in payload:
        if len(data_names) != 1:
            raise ValueError('model takes %d inputs (%s) — use the '
                             '"inputs" form'
                             % (len(data_names), ', '.join(data_names)))
        return [np.asarray(payload['data'])]
    raise ValueError('JSON body needs a "data" or "inputs" key')


class ServingServer:
    """One engine + batcher behind a ThreadingHTTPServer."""

    def __init__(self, engine, batcher, logger=logging):
        self.engine = engine
        self.batcher = batcher
        self.logger = logger
        self._server = None
        self._thread = None

    # -- request handling (pure-ish: tested without sockets too) -----------
    def predict_arrays(self, body, ctype, trace_id=None):
        """(code, output-arrays-or-error-dict): the parse + batcher
        round, shared by the JSON and npy answer paths. Client-side
        rejects answer 400 (counted, but NOT against the SLO error
        budget — the service was fine); server-side failures propagate
        to the handler's 500 (and the batcher already charged them to
        the budget)."""
        from .. import telemetry as _tele
        try:
            arrays = _parse_predict_body(body, ctype,
                                         self.engine._data_names)
            outs = self.batcher.predict(arrays, trace_id=trace_id)
        except (ValueError, json.JSONDecodeError) as e:
            _tele.counter('serve.errors').inc()
            return 400, {'error': str(e)}
        return 200, outs

    def predict_payload(self, body, ctype, trace_id=None):
        code, res = self.predict_arrays(body, ctype, trace_id=trace_id)
        if code != 200:
            return code, res
        payload = {'outputs': [o.tolist() for o in res],
                   'rows': int(res[0].shape[0])}
        if trace_id:
            payload['trace_id'] = trace_id
        return 200, payload

    def healthz_payload(self):
        from .. import telemetry as _tele
        from ..telemetry import slo as _slo
        snap = _tele.snapshot() if _tele.enabled() else {}
        c = snap.get('counters', {})
        g = snap.get('gauges', {})
        slo_bad = _slo.degraded()
        body = {'status': 'slo_degraded' if slo_bad is not None
                else 'ok',
                'model': self.engine.name,
                'warmed': bool(self.engine.warmed),
                'requests': int(c.get('serve.requests', 0)),
                'errors': int(c.get('serve.errors', 0)),
                'queue_depth': int(g.get('serve.queue_depth', 0) or 0)}
        slo_snap = _slo.snapshot_slo()
        if slo_snap is not None:
            body['slo'] = slo_snap
        return body

    def _make_handler(self):
        from http.server import BaseHTTPRequestHandler
        outer = self

        class Handler(BaseHTTPRequestHandler):
            server_version = 'mxtpu-serving'

            def log_message(self, fmt, *args):
                logging.debug('serving.http: ' + fmt, *args)

            def _send(self, code, body, ctype='application/json',
                      headers=None):
                data = body if isinstance(body, bytes) \
                    else body.encode('utf-8')
                self.send_response(code)
                self.send_header('Content-Type', ctype)
                self.send_header('Content-Length', str(len(data)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def _guarded(self, fn):
                try:
                    fn()
                except Exception as e:  # noqa: BLE001 — a request must
                    logging.debug('serving.http: handler failed: %s', e)
                    try:                # not kill the server
                        self._send(500, json.dumps(
                            {'error': 'internal error'}) + '\n')
                    except Exception:  # noqa: BLE001
                        pass

            def do_GET(self):
                path = self.path.split('?', 1)[0].rstrip('/') or '/'

                def run():
                    if path == '/models':
                        self._send(200, json.dumps(
                            {'models': [outer.engine.describe()]},
                            indent=2) + '\n')
                    elif path == '/metrics':
                        from .. import telemetry as _tele
                        from ..telemetry import serve as _tserve
                        from ..telemetry import cluster as _cluster
                        body = _tserve.render_prometheus(
                            _tele.snapshot(),
                            host=_cluster.host_index())
                        self._send(200, body, _tserve._CONTENT_PROM)
                    elif path == '/healthz':
                        payload = outer.healthz_payload()
                        self._send(200 if payload['status'] == 'ok'
                                   else 503,
                                   json.dumps(payload, indent=2) + '\n')
                    elif path == '/':
                        self._send(200, 'mxnet_tpu serving endpoints: '
                                   'POST /predict, GET /models /metrics '
                                   '/healthz\n', 'text/plain')
                    else:
                        self._send(404, json.dumps(
                            {'error': 'not found'}) + '\n')
                self._guarded(run)

            def do_POST(self):
                path = self.path.split('?', 1)[0].rstrip('/')

                def run():
                    if path != '/predict':
                        self._send(404, json.dumps(
                            {'error': 'not found'}) + '\n')
                        return
                    from ..telemetry import trace as _trace
                    n = int(self.headers.get('Content-Length') or 0)
                    body = self.rfile.read(n)
                    # the client's X-Request-Id / traceparent names the
                    # request end to end; with telemetry on and no
                    # client id, mint one so the echoed header still
                    # links to the trace JSONL record
                    trace_id = _trace.from_headers(self.headers) \
                        or (_trace.new_trace_id() if _trace.enabled()
                            else None)
                    hdrs = {'X-Request-Id': trace_id} if trace_id \
                        else None
                    accept = (self.headers.get('Accept') or '') \
                        .split(';', 1)[0].strip().lower()
                    if accept in _NPY_TYPES:
                        code, res = outer.predict_arrays(
                            body, self.headers.get('Content-Type'),
                            trace_id=trace_id)
                        if code != 200:
                            self._send(code, json.dumps(res) + '\n',
                                       headers=hdrs)
                            return
                        buf = io.BytesIO()
                        np.save(buf, res[0], allow_pickle=False)
                        hdrs = dict(hdrs or {})
                        hdrs['X-Rows'] = str(int(res[0].shape[0]))
                        hdrs['X-Outputs'] = str(len(res))
                        self._send(200, buf.getvalue(),
                                   'application/x-npy', headers=hdrs)
                        return
                    code, payload = outer.predict_payload(
                        body, self.headers.get('Content-Type'),
                        trace_id=trace_id)
                    self._send(code, json.dumps(payload) + '\n',
                               headers=hdrs)
                self._guarded(run)

        return Handler

    # -- lifecycle ---------------------------------------------------------
    def start(self, port=0):
        """Bind (``port=0`` = OS-assigned ephemeral) and serve on a
        daemon thread; also starts the batcher. Returns the bound
        port."""
        from http.server import ThreadingHTTPServer
        from ..telemetry.serve import bind_address
        assert self._server is None, 'already started'
        self.batcher.start()
        self._server = ThreadingHTTPServer(
            (bind_address('MXTPU_SERVE_BIND'), int(port)),
            self._make_handler())
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name='mxtt-serving-http',
                                        daemon=True)
        self._thread.start()
        bound = self._server.server_address[1]
        self.logger.info('serving %s on :%d (POST /predict, GET /models '
                         '/metrics /healthz)', self.engine.name, bound)
        return bound

    @property
    def port(self):
        return self._server.server_address[1] if self._server else None

    def stop(self):
        srv, th = self._server, self._thread
        self._server = self._thread = None
        if srv is not None:
            try:
                srv.shutdown()
                srv.server_close()
            except Exception:  # noqa: BLE001
                pass
        if th is not None:
            th.join(timeout=5)
        self.batcher.close()


def start_server(engine, batcher=None, port=0, logger=logging):
    """Engine (+ optional pre-built batcher) -> running ServingServer.
    Returns the server; read the bound port off ``server.port``."""
    from .batcher import DynamicBatcher
    server = ServingServer(engine, batcher or DynamicBatcher(engine),
                           logger=logger)
    server.start(port)
    return server
