"""The port's HTTP front end (``mxnet_tpu_torch/serving/http.py``) and its
command line (``python -m mxnet_tpu_torch.serving.serve_model``) against
the JAX package's (``mxnet_tpu/serving/http.py``) on the CPU.

Both servers run in this process, on loopback port 0, over the same
JAX-written checkpoint of the JAX serving tests' 10-16-4 MLP, with
telemetry on, and get the same requests: ``/predict`` with a JSON body,
a ``.npy`` body answered as JSON or as ``.npy``, bodies they must reject,
unknown paths, ``/models``, ``/healthz``, ``/metrics`` and the index.
Status codes, headers and payloads agree; floats within rtol 1e-5 /
atol 1e-6 (the same f32 arithmetic, sums in another order). Every
request, wait and subprocess carries a timeout, and every server is
stopped in a ``finally``.
"""
import io
import json
import os
import queue
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import telemetry as jtele
from mxnet_tpu.serving import DynamicBatcher as JBatcher
from mxnet_tpu.serving import ServingEngine as JEngine
from mxnet_tpu.serving.http import start_server as jstart
from mxnet_tpu_torch import telemetry as ttele
from mxnet_tpu_torch.serving import DynamicBatcher, ServingEngine
from mxnet_tpu_torch.serving.http import start_server

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6
TIMEOUT = 30
NPY = 'application/x-npy'


def _mlp(pkg):
    S = pkg.sym
    h = S.FullyConnected(S.Variable('data'), num_hidden=16, name='fc1')
    h = S.Activation(h, act_type='relu', name='relu1')
    h = S.FullyConnected(h, num_hidden=4, name='fc2')
    return S.SoftmaxOutput(h, name='softmax')


@pytest.fixture(scope='module')
def ckpt(tmp_path_factory):
    mx.random.seed(7)
    mod = mx.mod.Module(_mlp(mx), context=mx.cpu())
    mod.bind(data_shapes=[('data', (8, 10))], for_training=False)
    mod.init_params(mx.init.Uniform(0.5))
    prefix = str(tmp_path_factory.mktemp('http') / 'mlp')
    mod.save_checkpoint(prefix, 1)
    return prefix


@pytest.fixture(scope='module')
def servers(ckpt, tmp_path_factory):
    """(JAX server port, port server port), both warm, telemetry on."""
    path = str(tmp_path_factory.mktemp('tele') / 't.jsonl')
    with pytest.MonkeyPatch.context() as mp:
        for name in ('MXTPU_SLO_LATENCY_MS', 'MXTPU_SLO_ERROR_PCT',
                     'MXTPU_SERVE_BIND', 'MXTPU_TELEMETRY_PORT'):
            mp.delenv(name, raising=False)
        mp.setenv('MXTPU_TELEMETRY', '1')
        mp.setenv('MXTPU_TELEMETRY_PATH', path)
        mx.config.flags.reload()
        mt.config.flags.reload()
        jtele._reset_for_tests()
        ttele._reset_for_tests()
        jeng = JEngine.from_checkpoint(ckpt, 1, [('data', (10,))],
                                       max_batch=4)
        teng = ServingEngine.from_checkpoint(ckpt, 1, [('data', (10,))],
                                             max_batch=4, context=mt.cpu())
        jeng.warmup()
        teng.warmup()
        started = []
        try:
            started.append(jstart(jeng, JBatcher(jeng, max_wait_ms=2)))
            started.append(start_server(teng,
                                        DynamicBatcher(teng, max_wait_ms=2)))
            yield tuple(s.port for s in started)
        finally:
            for s in started:
                s.stop()
            jtele._reset_for_tests()
            ttele._reset_for_tests()
        mx.config.flags.reload()
        mt.config.flags.reload()


def _call(port, path, body=None, headers=None):
    """(status, headers, body bytes) of one request."""
    req = urllib.request.Request('http://127.0.0.1:%d%s' % (port, path),
                                 data=body, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _both(servers, path, body=None, headers=None):
    return [_call(p, path, body, headers) for p in servers]


def _npy(a):
    buf = io.BytesIO()
    np.save(buf, a, allow_pickle=False)
    return buf.getvalue()


def _assert_payloads_alike(got, want):
    """JSON payloads equal, but their float lists within the tolerance and
    the trace ids each server minted (16 hex digits) apart."""
    assert set(got) == set(want)
    for k in want:
        if k == 'trace_id' and got[k] != want[k]:
            assert all(len(v) == 16 and int(v, 16) >= 0
                       for v in (got[k], want[k]))
        elif k == 'outputs':
            assert len(got[k]) == len(want[k])
            for g, w in zip(got[k], want[k]):
                np.testing.assert_allclose(np.asarray(g, np.float32),
                                           np.asarray(w, np.float32),
                                           rtol=RTOL, atol=ATOL)
        else:
            assert got[k] == want[k], k


X = np.random.RandomState(1).randn(6, 10).astype(np.float32)
JSON = {'Content-Type': 'application/json'}


@pytest.mark.parametrize('rows', [1, 3, 6])
def test_predict_json(servers, rows):
    body = json.dumps({'data': X[:rows].tolist()}).encode()
    (jc, jh, jb), (tc, th, tb) = _both(servers, '/predict', body, JSON)
    assert tc == jc == 200
    assert th['Content-Type'] == 'application/json'
    want, got = json.loads(jb), json.loads(tb)
    # telemetry on and no client id: each server mints one and echoes it
    assert th['X-Request-Id'] == got['trace_id']
    assert jh['X-Request-Id'] == want['trace_id']
    assert got['rows'] == rows and np.asarray(got['outputs'][0]).shape == \
        (rows, 4)
    _assert_payloads_alike(got, want)


def test_predict_inputs_form_and_request_id(servers):
    body = json.dumps({'inputs': {'data': X[:2].tolist()}}).encode()
    hdrs = dict(JSON, **{'X-Request-Id': 'client id/42'})
    (jc, jh, jb), (tc, th, tb) = _both(servers, '/predict', body, hdrs)
    assert tc == jc == 200
    assert th['X-Request-Id'] == jh['X-Request-Id'] == 'client_id_42'
    _assert_payloads_alike(json.loads(tb), json.loads(jb))
    assert json.loads(tb)['trace_id'] == 'client_id_42'


@pytest.mark.parametrize('accept', [None, NPY])
def test_predict_npy(servers, accept):
    hdrs = {'Content-Type': NPY}
    if accept:
        hdrs['Accept'] = accept
    (jc, jh, jb), (tc, th, tb) = _both(servers, '/predict', _npy(X[:5]),
                                       hdrs)
    assert tc == jc == 200
    if accept:
        assert th['Content-Type'] == jh['Content-Type'] == NPY
        assert (th['X-Rows'], th['X-Outputs']) == \
            (jh['X-Rows'], jh['X-Outputs']) == ('5', '1')
        got = np.load(io.BytesIO(tb), allow_pickle=False)
        want = np.load(io.BytesIO(jb), allow_pickle=False)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        _assert_payloads_alike(json.loads(tb), json.loads(jb))


@pytest.mark.parametrize('path,body,ctype', [
    ('/predict', b'not json', 'application/json'),
    ('/predict', b'[1, 2]', 'application/json'),
    ('/predict', b'{"neither": 1}', 'application/json'),
    ('/predict', b'{"inputs": {"x": [[1]]}}', 'application/json'),
    ('/predict', json.dumps({'data': np.zeros((2, 9)).tolist()}).encode(),
     'application/json'),
    ('/predict', json.dumps({'data': []}).encode(), 'application/json'),
    ('/predict', b'\x93NUMPY garbage', NPY),
    ('/nope', b'{}', 'application/json'),
])
def test_rejected_posts(servers, path, body, ctype):
    (jc, _, jb), (tc, _, tb) = _both(servers, path, body,
                                     {'Content-Type': ctype})
    assert tc == jc and tc in (400, 404, 500)
    assert json.loads(tb) == json.loads(jb)


@pytest.mark.parametrize('path', ['/models', '/healthz', '/', '/nope'])
def test_gets(servers, path):
    (jc, jh, jb), (tc, th, tb) = _both(servers, path)
    assert tc == jc
    assert th['Content-Type'] == jh['Content-Type']
    if th['Content-Type'] == 'application/json':
        assert json.loads(tb) == json.loads(jb)
    else:
        assert tb == jb


def test_metrics(servers):
    (jc, _, jb), (tc, th, tb) = _both(servers, '/metrics')
    assert tc == jc == 200
    assert th['Content-Type'].startswith('text/plain; version=0.0.4')

    def serve_types(text):
        return {ln for ln in text.decode().splitlines()
                if ln.startswith('# TYPE mxtpu_serve_')}
    assert serve_types(tb) == serve_types(jb)
    text = tb.decode()
    for line in ('# TYPE mxtpu_serve_requests_total counter',
                 'mxtpu_serve_request_latency_ms{host="0",quantile="0.5"}'):
        assert line in text


def _read_line(stream, q):
    for line in iter(stream.readline, ''):
        q.put(line)


def test_serve_model_command_line(ckpt, tmp_path):
    """The port's serve_model in a subprocess on the CPU answers one
    request as the JAX engine does."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    for name in ('MXTPU_TELEMETRY', 'MXTPU_SERVE_BIND'):
        env.pop(name, None)
    err = open(tmp_path / 'stderr.txt', 'w')
    proc = subprocess.Popen(
        [sys.executable, '-m', 'mxnet_tpu_torch.serving.serve_model', ckpt,
         '--epoch', '1', '--data-shape', '10', '--port', '0',
         '--context', 'cpu', '--max-batch', '4'],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=err, text=True)
    try:
        q = queue.Queue()
        threading.Thread(target=_read_line, args=(proc.stdout, q),
                         daemon=True).start()
        try:
            line = q.get(timeout=120)
        except queue.Empty:
            pytest.fail('serve_model printed nothing in 120 s')
        assert line.startswith('serving softmax on port '), line
        port = int(line.split('on port ')[1].split()[0])
        code, _, body = _call(port, '/predict',
                              json.dumps({'data': X[:3].tolist()}).encode(),
                              JSON)
        assert code == 200
        want = JEngine.from_checkpoint(ckpt, 1, [('data', (10,))],
                                       max_batch=4).infer([X[:3]])[0]
        np.testing.assert_allclose(
            np.asarray(json.loads(body)['outputs'][0], np.float32), want,
            rtol=RTOL, atol=ATOL)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=TIMEOUT)
        err.close()
    assert proc.returncode == 0, (tmp_path / 'stderr.txt').read_text()
