"""The port's Python operators (mxnet_tpu_torch.operator, the callback ops
of ops/legacy_ops.py, registry.host_bridge) against the JAX package's on
the same seeded numpy inputs, on the CPU.

- ``nd.Custom`` under ``autograd.record()``: outputs and the input's
  gradient through the op's own backward;
- ``sym.Custom`` with keyword inputs and an auto-created label, through
  ``simple_bind``: forward and backward;
- ``Module.fit`` with examples/numpy-ops/custom_softmax.py's op: the
  parameters after two epochs (both packages take the per-batch loop: a
  graph with a host op declines the fused window);
- NumpyOp and NDArrayOp through ``simple_bind`` forward and backward, an
  NDArrayOp eagerly under ``autograd.record()``, and ``_CustomFunction``;
- a Custom node served by the port's ServingEngine (bit for bit its
  Module's predict; the JAX package's engine refuses a staged module),
  and a monitored module refused by both with the same message.

Tolerances: f32, rtol 1e-5, atol 1e-6 (the same arithmetic; sums in
another order); the op registries' names exact.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with mt.cpu():
        yield


def _softmax_op(lib, reg_name):
    """custom_softmax.py's Softmax and its prop, in ``lib``."""
    nd = lib.nd

    class Softmax(lib.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            y = np.exp(x - x.max(axis=1).reshape((x.shape[0], 1)))
            y /= y.sum(axis=1).reshape((x.shape[0], 1))
            self.assign(out_data[0], req[0], nd.array(y))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lab = in_data[1].asnumpy().ravel().astype(np.int64)
            y = out_data[0].asnumpy().copy()
            y[np.arange(lab.shape[0]), lab] -= 1.0
            self.assign(in_grad[0], req[0], nd.array(y))

    @lib.operator.register(reg_name)
    class SoftmaxProp(lib.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ['data', 'label']

        def list_outputs(self):
            return ['output']

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()
    return SoftmaxProp


def _scale_op(lib, reg_name):
    """y = 2 x + 1 with a backward that scales the head gradient by 2."""
    class Scale(lib.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * 2 + 1)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0] * 2)

    @lib.operator.register(reg_name)
    class ScaleProp(lib.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Scale()
    return ScaleProp


def test_registered_names_and_exports():
    for lib in (mx, mt):
        _scale_op(lib, 't_scale_names')
        assert 't_scale_names' in lib.operator.get_all_registered_operators()
        assert lib.CustomOp is lib.operator.CustomOp
    for name in ('Custom', '_Native', '_NDArray', '_CustomFunction'):
        jop = mx.ops.registry.get(name)
        top = mt.ops.registry.get(name)
        assert (top.host, top.variadic, top.differentiable) == \
            (jop.host, jop.variadic, jop.differentiable)
        assert hasattr(top, 'legacy_backward') == \
            hasattr(jop, 'legacy_backward')


def test_nd_custom_under_record_matches_jax():
    r = np.random.RandomState(0)
    x = r.randn(5, 4).astype(np.float32)
    head = r.randn(5, 4).astype(np.float32)
    res = {}
    for lib in (mx, mt):
        _scale_op(lib, 't_scale')
        a = lib.nd.array(x)
        a.attach_grad()
        with lib.autograd.record():
            y = lib.nd.Custom(a, op_type='t_scale')
            z = y * y
        z.backward(lib.nd.array(head))
        res[lib] = (y.asnumpy(), a.grad.asnumpy())
        # outside record: the same forward, nothing recorded
        np.testing.assert_array_equal(
            lib.nd.Custom(lib.nd.array(x), op_type='t_scale').asnumpy(),
            res[lib][0])
    np.testing.assert_allclose(res[mt][0], res[mx][0], **TOL)
    np.testing.assert_allclose(res[mt][1], res[mx][1], **TOL)
    np.testing.assert_allclose(res[mt][1], 2 * head * 2 * (2 * x + 1),
                               rtol=1e-5)


def _custom_net(lib, reg_name):
    S = lib.sym
    _softmax_op(lib, reg_name)
    d = S.var('data')
    fc = S.FullyConnected(d, num_hidden=6, name='fc')
    return S.Custom(data=fc, name='softmax', op_type=reg_name)


def test_sym_custom_through_simple_bind_matches_jax():
    r = np.random.RandomState(1)
    x = r.randn(8, 10).astype(np.float32)
    w = (0.3 * r.randn(6, 10)).astype(np.float32)
    b = (0.1 * r.randn(6)).astype(np.float32)
    lab = r.randint(0, 6, 8).astype(np.float32)
    res = {}
    for lib in (mx, mt):
        net = _custom_net(lib, 't_softmax_bind')
        assert net.list_arguments() == ['data', 'fc_weight', 'fc_bias',
                                        'softmax_label']
        ex = net.simple_bind(lib.cpu(), data=(8, 10),
                             softmax_label=(8,))
        for n, v in (('data', x), ('fc_weight', w), ('fc_bias', b),
                     ('softmax_label', lab)):
            ex.arg_dict[n][:] = lib.nd.array(v)
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        res[lib] = (out, ex.grad_dict['fc_weight'].asnumpy(),
                    ex.grad_dict['fc_bias'].asnumpy())
    for t, j in zip(res[mt], res[mx]):
        np.testing.assert_allclose(t, j, **TOL)


def test_module_fit_with_custom_softmax_matches_jax():
    r = np.random.RandomState(11)
    centers = (2 * r.randn(6, 10)).astype(np.float32)
    labels = r.randint(0, 6, 64)
    X = (centers[labels] + 0.4 * r.randn(64, 10)).astype(np.float32)
    Y = labels.astype(np.float32)
    w0 = (0.1 * r.randn(6, 10)).astype(np.float32)
    b0 = np.zeros(6, np.float32)
    res = {}
    for lib in (mx, mt):
        net = _custom_net(lib, 't_softmax_fit')
        it = lib.io.NDArrayIter(X, Y, batch_size=16,
                                label_name='softmax_label')
        mod = lib.mod.Module(net, context=lib.cpu())
        mod.fit(it, num_epoch=2, optimizer='sgd',
                optimizer_params={'learning_rate': 0.02},
                arg_params={'fc_weight': lib.nd.array(w0),
                            'fc_bias': lib.nd.array(b0)})
        assert mod.__dict__.get('_fused_fit_cache') is None
        args, _ = mod.get_params()
        res[lib] = {n: v.asnumpy() for n, v in args.items()}
    assert not np.allclose(res[mt]['fc_weight'], w0)
    for n in res[mx]:
        np.testing.assert_allclose(res[mt][n], res[mx][n], err_msg=n, **TOL)


def _legacy_ops(lib):
    class Scale3(lib.operator.NumpyOp):
        def forward(self, in_data, out_data):
            out_data[0][:] = in_data[0] * 3

        def backward(self, out_grad, in_data, out_data, in_grad):
            in_grad[0][:] = out_grad[0] * 3

    class Sq(lib.operator.NDArrayOp):
        def forward(self, in_data, out_data):
            out_data[0][:] = in_data[0] * in_data[0]

        def backward(self, out_grad, in_data, out_data, in_grad):
            in_grad[0][:] = 2 * in_data[0] * out_grad[0]
    return Scale3, Sq


@pytest.mark.parametrize('kind', ['numpy', 'ndarray'])
def test_legacy_op_through_simple_bind_matches_jax(kind):
    r = np.random.RandomState(2)
    x = r.randn(3, 4).astype(np.float32)
    head = r.randn(3, 4).astype(np.float32)
    res = {}
    for lib in (mx, mt):
        Scale3, Sq = _legacy_ops(lib)
        op = Scale3() if kind == 'numpy' else Sq()
        net = op(lib.sym.var('data'))
        ex = net.simple_bind(lib.cpu(), data=(3, 4))
        ex.arg_dict['data'][:] = lib.nd.array(x)
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward(lib.nd.array(head))
        res[lib] = (out, ex.grad_dict['data'].asnumpy())
    for t, j in zip(res[mt], res[mx]):
        np.testing.assert_allclose(t, j, **TOL)


def test_ndarray_op_imperative_autograd_matches_jax():
    x = np.array([1., 2., 3.], np.float32)
    res = {}
    for lib in (mx, mt):
        _, Sq = _legacy_ops(lib)
        from importlib import import_module
        legacy = import_module(lib.__name__ + '.ops.legacy_ops')
        a = lib.nd.array(x)
        a.attach_grad()
        with lib.autograd.record():
            y = lib.nd._internal._NDArray(
                a, info=legacy.register_legacy_callback(Sq()))
            loss = y.sum()
        loss.backward()
        res[lib] = (y.asnumpy(), a.grad.asnumpy())
    for t, j in zip(res[mt], res[mx]):
        np.testing.assert_allclose(t, j, **TOL)
    np.testing.assert_allclose(res[mt][1], 2 * x)


def test_custom_function_op_matches_jax():
    x = np.array([[-1., 0.5, 2.]], np.float32)
    res = {}
    for lib in (mx, mt):
        class Sigmoid(lib.autograd.Function):
            def forward(self, a):
                return 1 / (1 + lib.nd.exp(-a))

            def backward(self, dy):
                return dy
        from importlib import import_module
        legacy = import_module(lib.__name__ + '.ops.legacy_ops')
        y = lib.nd._internal._CustomFunction(
            lib.nd.array(x), info=legacy.register_legacy_callback(Sigmoid()))
        res[lib] = y.asnumpy()
    np.testing.assert_allclose(res[mt], res[mx], **TOL)
    np.testing.assert_allclose(res[mt], 1 / (1 + np.exp(-x)), rtol=1e-6)


def test_unknown_legacy_info_raises():
    with pytest.raises(mt.MXNetError, match='no live python operator'):
        mt.nd._internal._Native(mt.nd.ones((2,)), info='12345')


def _scale_module(lib):
    _scale_op(lib, 't_scale_serve')
    S = lib.sym
    net = S.Custom(S.FullyConnected(S.var('data'), num_hidden=3, name='fc'),
                   op_type='t_scale_serve', name='scaled')
    mod = lib.mod.Module(net, label_names=None, context=lib.cpu())
    mod.bind(data_shapes=[('data', (4, 5))], for_training=False)
    r = np.random.RandomState(4)
    mod.set_params({'fc_weight': lib.nd.array(r.randn(3, 5)),
                    'fc_bias': lib.nd.array(r.randn(3))}, {})
    return mod


def test_serving_engine_runs_a_custom_node():
    """The port's ServingEngine runs a graph with a host op through the
    runner's bridge (the JAX package's refuses a staged module); both
    refuse a monitored module with the same message."""
    from mxnet_tpu.serving import ServingEngine as JEngine
    from mxnet_tpu_torch.serving import ServingEngine
    x = np.random.RandomState(5).randn(4, 5).astype(np.float32)
    mod = _scale_module(mt)
    want = mod.predict(mt.io.NDArrayIter(x, batch_size=4)).asnumpy()
    got = ServingEngine(mod).infer([x])[0]
    np.testing.assert_array_equal(got, want)
    errs = []
    for lib, cls in ((mx, JEngine), (mt, ServingEngine)):
        mod = _scale_module(lib)
        mod.install_monitor(lib.mon.Monitor(1))
        with pytest.raises(ValueError) as err:
            cls(mod)
        errs.append(str(err.value))
    assert errs[0] == errs[1]
