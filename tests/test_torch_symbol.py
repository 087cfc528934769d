"""The port's Symbol graph, shape/type inference and executor
(mxnet_tpu_torch.symbol, .symbol.infer, .executor) against the JAX
package's on the same graphs and numpy inputs, on the CPU.

Covered: composition with auto-created parameter variables (named by the
same counters), the list_* methods, get_internals, attrs, the operator
dunders, ``tojson`` (the same JSON text as the JAX package's) and
``load_json``; ``infer_shape``/``infer_shape_partial``/``infer_type``;
``bind`` and ``simple_bind`` forward (train and predict) and backward
with head gradients, ``grad_req`` write/add/null, the new BatchNorm
statistics, ``copy_params_from``, ``reshape``, ``eval``;
``MXTPU_BACKWARD_DO_MIRROR`` ('1' and 'dots') giving the same gradients;
and the pieces left for later raising NotImplementedError.

Tolerances: f32 values and gradients rtol 1e-5, atol 1e-5 (the same
arithmetic, sums in another order); shapes, types, names and JSON exact;
the mirrored gradients equal the unmirrored ones bit for bit (the same ops
run again on the same inputs).
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import nd

TOL = dict(rtol=1e-5, atol=1e-5)
DATA = (4, 3, 8, 8)


def _net(S):
    """A small conv net in either package's sym namespace."""
    x = S.var('data')
    c = S.Convolution(x, kernel=(3, 3), num_filter=4, pad=(1, 1))
    b = S.BatchNorm(c, fix_gamma=False)
    a = S.Activation(b, act_type='relu')
    p = S.Pooling(a, kernel=(2, 2), stride=(2, 2), pool_type='max',
                  pooling_convention='full')
    f = S.FullyConnected(p, num_hidden=5)
    d = S.Dropout(f, p=0.0)
    return S.SoftmaxOutput(d * 2 + 1, name='out')


def _both_nets():
    with mx.name.NameManager():
        js = _net(mx.sym)
    with mt.name.NameManager():
        ts = _net(mt.sym)
    return js, ts


def test_compose_names_and_json_match_jax():
    js, ts = _both_nets()
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_auxiliary_states() == js.list_auxiliary_states()
    assert ts.list_outputs() == js.list_outputs()
    assert ts.get_internals().list_outputs() == js.get_internals().list_outputs()
    assert ts.tojson() == js.tojson()
    back = mt.sym.load_json(js.tojson())
    assert back.tojson() == ts.tojson()


def test_attrs_and_group():
    with mt.AttrScope(ctx_group='dev1'):
        v = mt.sym.var('w', lr_mult=2.0, shape=(3,))
    assert v.attr('ctx_group') == 'dev1' and v.attr('__lr_mult__') == '2.0'
    g = mt.sym.Group([v * 2, mt.sym.var('u') + 1])
    assert len(g) == 2 and g.list_arguments() == ['w', 'u']
    with pytest.raises(mt.sym.symbol.NotImplementedForSymbol):
        v.asnumpy()


def test_infer_shape_and_type_match_jax():
    js, ts = _both_nets()
    assert ts.infer_shape(data=DATA) == js.infer_shape(data=DATA)
    jp, tp = js.infer_shape_partial(), ts.infer_shape_partial()
    assert tp == jp
    for kw in ({'data': 'float32'}, {'data': 'float16'}):
        assert [str(t) for ts_ in ts.infer_type(**kw) for t in ts_] == \
            [str(t) for js_ in js.infer_type(**kw) for t in js_]
    with pytest.raises(mt.MXNetError):
        ts.infer_shape()


def _values(sym, seed=0):
    """numpy values for every argument and aux state of ``sym``."""
    arg_shapes, _, aux_shapes = sym.infer_shape(data=DATA)
    r = np.random.RandomState(seed)
    args = {n: r.randn(*s).astype(np.float32) * 0.5
            for n, s in zip(sym.list_arguments(), arg_shapes)}
    args['out_label'] = r.randint(0, 5, DATA[0]).astype(np.float32)
    aux = {n: (np.abs(r.randn(*s)) + 0.5 if 'var' in n else r.randn(*s))
           .astype(np.float32) for n, s in zip(sym.list_auxiliary_states(),
                                               aux_shapes)}
    return args, aux


def _bind(lib, sym, args, aux, req):
    ctx = mx.cpu() if lib is mx else mt.cpu()
    arr = (lambda a: lib.nd.array(a, ctx=ctx))
    grads = {n: arr(np.zeros_like(v)) for n, v in args.items()}
    return sym.bind(ctx, {n: arr(v) for n, v in args.items()},
                    args_grad=grads, grad_req=req,
                    aux_states={n: arr(v) for n, v in aux.items()})


@pytest.mark.parametrize('req', ['write', 'add', 'data-null'])
def test_bind_forward_backward_match_jax(req):
    js, ts = _both_nets()
    args, aux = _values(ts)
    if req == 'data-null':
        req = {n: 'null' if n == 'data' else 'write' for n in args}
    res = []
    for lib, sym in ((mx, js), (mt, ts)):
        ex = _bind(lib, sym, args, aux, req)
        for _ in range(2):          # twice: 'add' accumulates
            ex.forward(is_train=True)
            ex.backward()
            # read after the backward: the JAX executor runs its deferred
            # training forward again for outputs read before it, and so
            # updates the moving statistics twice (the port, as the
            # reference, once)
            outs = [o.asnumpy() for o in ex.outputs]
        pred = ex.forward(is_train=False)[0].asnumpy()
        res.append((outs, {n: g.asnumpy() for n, g in ex.grad_dict.items()
                           if g is not None},
                    {n: a.asnumpy() for n, a in ex.aux_dict.items()}, pred))
    (jo, jg, ja, jp), (to, tg, ta, tp) = res
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a, b, **TOL)
    np.testing.assert_allclose(tp, jp, **TOL)
    assert sorted(tg) == sorted(jg)
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], err_msg=n, **TOL)
    for n in ja:
        np.testing.assert_allclose(ta[n], ja[n], err_msg=n, **TOL)
    if isinstance(req, dict):
        assert not tg['data'].any()


def test_head_gradients_and_outputs_match_jax():
    with mx.name.NameManager():
        jx = mx.sym.var('x')
        js = mx.sym.Group([mx.sym.tanh(jx) * 3, mx.sym.sum(jx * jx)])
    with mt.name.NameManager():
        tx = mt.sym.var('x')
        ts = mt.sym.Group([mt.sym.tanh(tx) * 3, mt.sym.sum(tx * tx)])
    x = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    heads = [np.random.RandomState(2).randn(3, 4).astype(np.float32),
             np.array([0.5], np.float32)]
    res = []
    for lib, sym in ((mx, js), (mt, ts)):
        ctx = mx.cpu() if lib is mx else mt.cpu()
        ex = sym.simple_bind(ctx, x=(3, 4))
        ex.arg_dict['x'][:] = x
        ex.forward(is_train=True)
        ex.backward([lib.nd.array(h, ctx=ctx) for h in heads])
        ex.outputs
        res.append((ex.grad_dict['x'].asnumpy(),
                    [o.asnumpy() for o in ex.outputs],
                    sorted(ex.output_dict)))
    np.testing.assert_allclose(res[1][0], res[0][0], **TOL)
    for a, b in zip(res[1][1], res[0][1]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **TOL)
    assert res[1][2] == res[0][2]


def test_simple_bind_copy_params_reshape_eval():
    _, ts = _both_nets()
    ex = ts.simple_bind(mt.cpu(), data=DATA)
    assert ex.arg_dict['data'].shape == DATA
    assert ex.grad_dict['convolution0_weight'].shape == (4, 3, 3, 3)
    args, aux = _values(ts)
    ex.copy_params_from({n: nd.array(v, ctx=mt.cpu()) for n, v in args.items()},
                        {n: nd.array(v, ctx=mt.cpu()) for n, v in aux.items()})
    np.testing.assert_array_equal(ex.arg_dict['fullyconnected0_weight']
                                  .asnumpy(), args['fullyconnected0_weight'])
    with pytest.raises(ValueError):
        ex.copy_params_from({'nope': nd.zeros((1,), ctx=mt.cpu())})
    out = ex.forward()[0].asnumpy()
    small = ex.reshape(data=(2,) + DATA[1:])
    assert small.arg_dict['data'].shape == (2,) + DATA[1:]
    assert small.arg_dict['convolution0_weight'] is \
        ex.arg_dict['convolution0_weight']
    small.arg_dict['data'][:] = args['data'][:2]
    np.testing.assert_allclose(small.forward()[0].asnumpy(), out[:2], **TOL)
    v = mt.sym.var('a') * 2 + mt.sym.var('b')
    got = v.eval(mt.cpu(), a=nd.ones((2,), ctx=mt.cpu()),
                 b=nd.ones((2,), ctx=mt.cpu()))[0]
    np.testing.assert_array_equal(got.asnumpy(), [3, 3])


@pytest.fixture
def mirror_env(monkeypatch):
    """Sets (or, given None, removes) an environment variable and reloads
    the port's cached mirror flag; reloads it again once the environment
    is restored."""
    from mxnet_tpu_torch.config import flags

    def set_env(name, value):
        if value is None:
            monkeypatch.delenv(name)
        else:
            monkeypatch.setenv(name, value)
        flags.reload('MXTPU_BACKWARD_DO_MIRROR')
        return flags.get('MXTPU_BACKWARD_DO_MIRROR')
    yield set_env
    monkeypatch.undo()
    flags.reload('MXTPU_BACKWARD_DO_MIRROR')


@pytest.mark.parametrize('mirror', ['1', 'dots'])
def test_mirror_gives_the_same_gradients(mirror, mirror_env):
    _, ts = _both_nets()
    args, aux = _values(ts)
    res = []
    for flag in ('0', mirror):
        mirror_env('MXTPU_BACKWARD_DO_MIRROR', flag)
        ex = _bind(mt, ts, args, aux, 'write')
        ex.forward(is_train=True)
        ex.backward()
        res.append({n: g.asnumpy() for n, g in ex.grad_dict.items()})
    for n in res[0]:
        np.testing.assert_array_equal(res[1][n], res[0][n], err_msg=n)
    mirror_env('MXTPU_BACKWARD_DO_MIRROR', '0')
    assert mirror_env('MXNET_BACKWARD_DO_MIRROR', mirror) == '0'
    assert mirror_env('MXTPU_BACKWARD_DO_MIRROR', None) == mirror


def test_mirror_recomputes_in_the_backward(mirror_env):
    """With mirroring on, the backward runs the forward's ops again: the
    profiler sees each node's range twice."""
    mirror_env('MXTPU_BACKWARD_DO_MIRROR', '1')
    _, ts = _both_nets()
    args, aux = _values(ts)
    ex = _bind(mt, ts, args, aux, 'write')
    with torch.profiler.profile() as prof:
        ex.forward(is_train=True)
        ex.backward()
    names = [e.name for e in prof.events()]
    assert names.count('convolution0') == 2


def test_not_ported_pieces_raise():
    """The staged pieces that raised before they were ported now run
    (tests/test_torch_staged_executor.py holds them to the JAX package);
    an op that reads its data still raises at shape inference."""
    _, ts = _both_nets()
    ex = ts.simple_bind(mt.cpu(), data=DATA)
    assert ex.partial_forward(False, 0) == len(ts._topo()) - len(
        ts.list_arguments()) - len(ts.list_auxiliary_states()) - 1
    ex.set_monitor_callback(print)
    ex.set_monitor_callback(None)
    assert ex.first_nonfinite_node() is None
    ts.simple_bind(mt.cpu(), group2ctx={'a': mt.cpu()}, data=DATA)

    def reads_data(attrs, x):
        return x[:int(x.sum().item())]
    from mxnet_tpu_torch.ops import registry as treg
    treg.register('_test_reads_data')(reads_data)
    try:
        s = mt.sym.symbol.create('_test_reads_data', [mt.sym.var('x')], {})
        with pytest.raises(mt.MXNetError, match='meta'):
            s.infer_shape(x=(3,))   # an op that reads its data: no fallback
    finally:
        del treg._OPS['_test_reads_data']


def test_kernel_ops_through_simple_bind_match_jax(monkeypatch):
    """LayerNorm -> FullyConnected -> softmax_cross_entropy (chip_smoke's
    phase (k2) at a small width) through simple_bind on both packages,
    on the kernel branch (MXTPU_FORCE_PALLAS=1)."""
    monkeypatch.setenv('MXTPU_FORCE_PALLAS', '1')
    r = np.random.RandomState(3)
    x = r.randn(8, 16).astype(np.float32)
    vals = {'ln_gamma': 1 + 0.1 * r.randn(16), 'ln_beta': 0.1 * r.randn(16),
            'fc_weight': 0.3 * r.randn(32, 16)}
    lab = r.randint(0, 32, 8).astype(np.float32)
    res = []
    for lib in (mx, mt):
        S = lib.sym
        ctx = mx.cpu() if lib is mx else mt.cpu()
        y = S.softmax_cross_entropy(
            S.FullyConnected(S.LayerNorm(S.var('x'), name='ln'),
                             num_hidden=32, no_bias=True, name='fc'),
            S.var('label'))
        ex = y.simple_bind(ctx, x=(8, 16), label=(8,),
                           grad_req={'x': 'write', 'ln_gamma': 'write',
                                     'ln_beta': 'write', 'fc_weight': 'write'})
        ex.arg_dict['x'][:] = x
        ex.arg_dict['label'][:] = lab
        for n, v in vals.items():
            ex.arg_dict[n][:] = v.astype(np.float32)
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        res.append((out, {n: ex.grad_dict[n].asnumpy() for n in
                          ('x', 'ln_gamma', 'ln_beta', 'fc_weight')}))
    np.testing.assert_allclose(res[1][0], res[0][0], **TOL)
    for n in res[0][1]:
        np.testing.assert_allclose(res[1][1][n], res[0][1][n], err_msg=n,
                                   rtol=1e-4, atol=1e-5)


def test_sym_random_composes():
    s = mt.sym.random.normal(loc=0, scale=1, shape=(3, 2))
    assert s.infer_shape()[1] == [(3, 2)]
    u = mt.sym.random.uniform(mt.sym.var('lo'), mt.sym.var('hi'), shape=(4,))
    assert u.list_arguments() == ['lo', 'hi']
    out = u.eval(mt.cpu(), lo=nd.zeros((2,), ctx=mt.cpu()),
                 hi=nd.ones((2,), ctx=mt.cpu()))[0]
    assert out.shape == (2, 4) and (out.asnumpy() >= 0).all()
    j = json.loads(s.tojson())
    assert j['nodes'][-1]['op'] == '_random_normal'
