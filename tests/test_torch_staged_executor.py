"""The port's staged executor path (mxnet_tpu_torch.executor: the per-node
hooks of ``_GraphProgram.make_node_exec``, monitor callbacks, group2ctx,
``partial_forward``, ``first_nonfinite_node``) against the JAX package's
staged mode on the same graphs and seeded numpy values, on the CPU.

- monitor callbacks: the same names in the same order, values within
  rtol 1e-5, atol 1e-6 (f32, sums in another order);
- ``partial_forward``: the same steps-left counts, out-of-range and
  restarted passes, outputs within the same tolerance;
- group2ctx over cpu(0)/cpu(1) on the JAX package's test_model_parallel.py
  net: outputs and gradients within the same tolerance of the JAX split
  run, and bit for bit the port's single-device run;
- ``first_nonfinite_node``: the same (name, index) as the JAX package's;
- a monitored run of the port is its plain run bit for bit, Dropout and
  BatchNorm in training included;
- the Dropout case: the port's backward keeps the forward's graph, so the
  outputs read after backward are the forward's; the JAX package's staged
  backward runs the forward again under a fresh key
  (``mxnet_tpu/executor.py:_backward_staged``), so its outputs after
  backward differ from its forward's (ROADMAP.md §3).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's arrays default to the card: these tests make theirs on
    the CPU."""
    with mt.cpu():
        yield


def _mlp(S, dropout=0.0):
    x = S.var('data')
    h = S.FullyConnected(x, num_hidden=8, name='fc1')
    h = S.BatchNorm(h, fix_gamma=False, name='bn')
    h = S.Activation(h, act_type='relu', name='relu')
    if dropout:
        h = S.Dropout(h, p=dropout, name='drop')
    sl = S.SliceChannel(h, num_outputs=2, name='split')
    h = S.Concat(sl[0], sl[1], dim=1, name='cat')
    h = S.FullyConnected(h, num_hidden=4, name='fc2')
    return S.SoftmaxOutput(h, name='softmax')


def _values(sym, shapes, seed=0):
    r = np.random.RandomState(seed)
    args, _, aux = sym.infer_shape(**shapes)
    a = {n: (0.5 * r.randn(*s)).astype(np.float32)
         for n, s in zip(sym.list_arguments(), args)}
    a['softmax_label'] = r.randint(0, 4, shapes['data'][0]).astype(
        np.float32)
    x = {n: (np.abs(r.randn(*s)) + 0.5).astype(np.float32)
         for n, s in zip(sym.list_auxiliary_states(), aux)}
    return a, x


def _bind(lib, sym, args, aux, group2ctx=None):
    ctx = lib.cpu()
    nd = lib.nd
    grads = {n: nd.zeros(v.shape) for n, v in args.items()
             if n not in ('data', 'softmax_label')}
    return sym.bind(ctx, {n: nd.array(v) for n, v in args.items()},
                    args_grad=grads, grad_req='write',
                    aux_states={n: nd.array(v) for n, v in aux.items()},
                    group2ctx=group2ctx)


SHAPES = {'data': (6, 5)}


def _both(dropout=0.0):
    js, ts = _mlp(mx.sym, dropout), _mlp(mt.sym, dropout)
    args, aux = _values(ts, SHAPES)
    return js, ts, args, aux


def test_monitor_names_and_values_match_jax():
    js, ts, args, aux = _both()
    rows = {}
    for lib, sym in ((mx, js), (mt, ts)):
        ex = _bind(lib, sym, args, aux)
        seen = []
        ex.set_monitor_callback(lambda n, a, seen=seen:
                                seen.append((n, a.asnumpy())))
        ex.forward(is_train=True)
        ex.backward()
        rows[lib] = seen
    names = [n for n, _ in rows[mt]]
    assert names == [n for n, _ in rows[mx]]
    assert 'split_output0' in names and 'split_output1' in names
    assert 'softmax_output' in names and 'data' not in names
    for (n, t), (_, j) in zip(rows[mt], rows[mx]):
        np.testing.assert_allclose(t, j, err_msg=n, **TOL)


def test_monitor_values_are_detached():
    _, ts, args, aux = _both()
    ex = _bind(mt, ts, args, aux)
    seen = []
    ex.set_monitor_callback(lambda n, a: seen.append(a._data))
    ex.forward(is_train=True)
    assert seen and all(not t.requires_grad for t in seen)


def test_partial_forward_matches_jax():
    js, ts, args, aux = _both()
    res = {}
    for lib, sym in ((mx, js), (mt, ts)):
        ex = _bind(lib, sym, args, aux)
        lefts = [ex.partial_forward(False, 0), ex.partial_forward(False, 1)]
        # a restart at step 0 replays; a jump replays up to the step
        lefts.append(ex.partial_forward(False, 0))
        lefts.append(ex.partial_forward(False, 3))
        step = 4
        while lefts[-1]:
            lefts.append(ex.partial_forward(False, step))
            step += 1
        lefts += [ex.partial_forward(False, -1),
                  ex.partial_forward(False, 10 ** 6)]
        res[lib] = (lefts, ex.outputs[0].asnumpy(),
                    ex.forward(is_train=False)[0].asnumpy())
    assert res[mt][0] == res[mx][0]
    np.testing.assert_allclose(res[mt][1], res[mx][1], **TOL)
    np.testing.assert_array_equal(res[mt][1], res[mt][2])


def test_partial_forward_training_writes_aux_once():
    _, ts, args, aux = _both()
    a, b = _bind(mt, ts, args, aux), _bind(mt, ts, args, aux)
    step = 0
    while a.partial_forward(True, step):
        step += 1
    b.forward(is_train=True)
    for n in ts.list_auxiliary_states():
        np.testing.assert_array_equal(a.aux_dict[n].asnumpy(),
                                      b.aux_dict[n].asnumpy())
    np.testing.assert_array_equal(a.outputs[0].asnumpy(),
                                  b.outputs[0].asnumpy())


def _split_net(lib):
    S = lib.sym
    with lib.AttrScope(ctx_group='dev1'):
        data = S.Variable('data')
        fc1 = S.FullyConnected(data, name='fc1', num_hidden=8)
        act1 = S.Activation(fc1, name='act1', act_type='relu')
    with lib.AttrScope(ctx_group='dev2'):
        fc2 = S.FullyConnected(act1, name='fc2', num_hidden=4)
        out = S.LinearRegressionOutput(fc2, name='out')
    return out


def _split_bind(lib, net, group2ctx):
    rng = np.random.RandomState(0)
    arg_shapes, _, _ = net.infer_shape(data=(6, 10))
    args, grads = {}, {}
    for name, shape in zip(net.list_arguments(), arg_shapes):
        args[name] = lib.nd.array(rng.randn(*shape).astype(np.float32) * 0.1)
        grads[name] = lib.nd.zeros(shape)
    return net.bind(lib.cpu(), args, args_grad=grads, group2ctx=group2ctx)


def _split_run(lib, group2ctx):
    net = _split_net(lib)
    ex = _split_bind(lib, net, group2ctx)
    out = ex.forward(is_train=True)[0]
    ex.backward()
    return ex, out, {n: ex.grad_dict[n].asnumpy()
                     for n in net.list_arguments()}


def test_group2ctx_matches_jax_and_single_device():
    jex, jout, jgrads = _split_run(mx, {'dev1': mx.cpu(0),
                                        'dev2': mx.cpu(1)})
    tex, tout, tgrads = _split_run(mt, {'dev1': mt.cpu(0),
                                        'dev2': mt.cpu(1)})
    _, sout, sgrads = _split_run(mt, None)
    assert tex._use_staged() and jex._use_staged()
    assert tout.context == mt.cpu(1)        # fc2's group
    np.testing.assert_allclose(tout.asnumpy(), jout.asnumpy(), **TOL)
    np.testing.assert_array_equal(tout.asnumpy(), sout.asnumpy())
    for n in tgrads:
        np.testing.assert_allclose(tgrads[n], jgrads[n], err_msg=n, **TOL)
        np.testing.assert_array_equal(tgrads[n], sgrads[n])


@pytest.mark.parametrize('where', ['none', 'weight', 'data', 'override'])
def test_first_nonfinite_node_matches_jax(where):
    js, ts, args, aux = _both()
    args = dict(args)
    if where == 'weight':
        args['fc2_weight'] = args['fc2_weight'].copy()
        args['fc2_weight'][1, 2] = np.nan
    elif where == 'data':
        args['data'] = args['data'].copy()
        args['data'][0, 0] = np.inf
    found = {}
    for lib, sym in ((mx, js), (mt, ts)):
        ex = _bind(lib, sym, args, aux)
        seen = []
        ex.set_monitor_callback(lambda n, a, seen=seen: seen.append(n))
        over = None
        if where == 'override':
            w = args['fc1_weight'].copy()
            w[0, 0] = np.nan
            over = {'fc1_weight': lib.nd.array(w)._data
                    if lib is mx else w}
        found[lib] = ex.first_nonfinite_node(over)
        assert not seen             # no monitor calls during the replay
    assert found[mt] == found[mx]
    assert found[mt] == {'none': None, 'weight': ('fc2_weight', 0),
                         'data': ('data', 0),
                         'override': ('fc1_weight', 0)}[where]


def test_first_nonfinite_node_names_the_first_bad_op():
    """A finite input whose log is NaN: the op is named, not a variable."""
    for lib in (mx, mt):
        S = lib.sym
        y = S.sum(S.log(S.var('x') - 2.0, name='lg'), name='total')
        ex = y.bind(lib.cpu(), {'x': lib.nd.array(np.ones((2, 3),
                                                          np.float32))})
        assert ex.first_nonfinite_node(is_train=False) == ('lg', 0)


def test_monitored_run_is_the_plain_run_bit_for_bit():
    _, ts, args, aux = _both(dropout=0.5)
    res = []
    for monitored in (False, True):
        ex = _bind(mt, ts, args, aux)
        if monitored:
            ex.set_monitor_callback(lambda n, a: a.asnumpy())
        mt.random.seed(11)
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        res.append((out, {n: g.asnumpy() for n, g in ex.grad_dict.items()
                          if g is not None},
                    {n: a.asnumpy() for n, a in ex.aux_dict.items()}))
    (o0, g0, a0), (o1, g1, a1) = res
    np.testing.assert_array_equal(o0, o1)
    for n in g0:
        np.testing.assert_array_equal(g0[n], g1[n], err_msg=n)
    for n in a0:
        np.testing.assert_array_equal(a0[n], a1[n], err_msg=n)


def test_dropout_outputs_after_backward_keep_one_forward():
    """The port keeps the forward's graph for the backward; the JAX
    package's staged backward reruns the forward under a fresh key."""
    js, ts, args, aux = _both(dropout=0.5)
    same = {}
    for lib, sym in ((mx, js), (mt, ts)):
        ex = _bind(lib, sym, args, aux)
        ex.set_monitor_callback(lambda n, a: None)
        o_fwd = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        o_after = ex.outputs[0].asnumpy()
        same[lib] = np.allclose(o_fwd, o_after)
    assert same[mt]
    assert not same[mx]


def test_host_op_runs_in_the_graph_runner():
    """A graph holding a host op runs through registry.host_bridge in the
    executor's runner and in make_runner's (gluon, serving, graph_train)."""
    S = mt.sym
    y = S._internal._cvcopyMakeBorder(S.var('img'), top=1, bot=2, left=0,
                                      right=1, value=3.0)
    img = np.arange(12, dtype=np.float32).reshape(2, 3, 2)
    ex = y.bind(mt.cpu(), {'img': mt.nd.array(img)})
    want = np.pad(img, ((1, 2), (0, 1), (0, 0)), constant_values=3.0)
    np.testing.assert_array_equal(ex.forward()[0].asnumpy(), want)
    run = ex._prog.make_runner()
    outs, _ = run((torch.from_numpy(img),), (), 0, False)
    np.testing.assert_array_equal(outs[0].numpy(), want)
