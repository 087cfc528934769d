"""The port's SequentialModule, PythonModule and PythonLossModule
(mxnet_tpu_torch.module) against the JAX package's, on the CPU.

- A SequentialModule of two Modules (the second takes the labels, its
  data auto-wired to the first's outputs) through ``fit``: the parameters
  after one epoch, the metric, ``predict``; and the same chain closed by a
  PythonLossModule with a hand-written softmax cross-entropy gradient,
  batch by batch. f32 rtol 1e-5, atol 1e-6 (three SGD steps of the same f32
  arithmetic; the matmuls summed in another order).
- PythonLossModule's default and custom gradients, and a PythonModule
  written by a user (the same subclass over each package), exact.
- The chain's checks: unknown metadata, duplicated parameter names.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

N, D, K, BATCH = 24, 6, 3, 8
X = np.random.RandomState(0).randn(N, D).astype(np.float32)
Y = np.random.RandomState(1).randint(0, K, N).astype(np.float32)


def _ctx(pkg):
    return pkg.cpu()


def _first(pkg):
    data = pkg.sym.Variable('data')
    fc = pkg.sym.FullyConnected(data, num_hidden=5, name='fc1')
    return pkg.mod.Module(pkg.sym.Activation(fc, act_type='relu',
                                             name='relu1'),
                          label_names=[], context=_ctx(pkg))


def _second(pkg, loss=True):
    data = pkg.sym.Variable('data')
    fc = pkg.sym.FullyConnected(data, num_hidden=K, name='fc2')
    if not loss:
        return pkg.mod.Module(fc, label_names=[], context=_ctx(pkg))
    return pkg.mod.Module(pkg.sym.SoftmaxOutput(fc, name='softmax'),
                          context=_ctx(pkg))


def _init_weights():
    rng = np.random.RandomState(2)
    return {'fc1_weight': rng.randn(5, D).astype(np.float32) * 0.5,
            'fc1_bias': rng.randn(5).astype(np.float32) * 0.1,
            'fc2_weight': rng.randn(K, 5).astype(np.float32) * 0.5,
            'fc2_bias': rng.randn(K).astype(np.float32) * 0.1}


def _fit_chain(pkg):
    seq = pkg.mod.SequentialModule()
    seq.add(_first(pkg)).add(_second(pkg), take_labels=True,
                             auto_wiring=True)
    it = pkg.io.NDArrayIter(X, Y, batch_size=BATCH)
    metric = pkg.metric.Accuracy()
    w = {k: pkg.nd.array(v, ctx=pkg.cpu())
         for k, v in _init_weights().items()}
    seq.fit(it, num_epoch=1, eval_metric=metric, optimizer='sgd',
            optimizer_params={'learning_rate': 0.5}, arg_params=w)
    params = {k: v.asnumpy() for k, v in seq.get_params()[0].items()}
    it.reset()
    pred = seq.predict(it).asnumpy()
    return params, metric.get(), pred, seq


def test_sequential_fit_matches_jax():
    want, wmetric, wpred, _ = _fit_chain(mx)
    got, gmetric, gpred, seq = _fit_chain(mt)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert gmetric == wmetric
    np.testing.assert_allclose(gpred, wpred, rtol=1e-5, atol=1e-6)
    assert seq.output_shapes == [('softmax_output', (BATCH, K))]
    assert seq.data_names == ['data'] and seq.output_names == \
        ['softmax_output']


def _ce_grad(pkg):
    def grad(scores, labels):
        return pkg.nd.softmax(scores) - pkg.nd.one_hot(labels, K)
    return grad


def _loss_chain(pkg):
    seq = pkg.mod.SequentialModule()
    seq.add(_first(pkg)).add(_second(pkg, loss=False), auto_wiring=True)
    seq.add(pkg.mod.PythonLossModule(grad_func=_ce_grad(pkg)),
            take_labels=True, auto_wiring=True)
    seq.bind(data_shapes=[('data', (BATCH, D))],
             label_shapes=[('softmax_label', (BATCH,))])
    seq.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                for k, v in _init_weights().items()})
    seq.init_optimizer(optimizer='sgd',
                       optimizer_params={'learning_rate': 0.1,
                                         'rescale_grad': 1.0 / BATCH})
    outs = []
    for i in range(0, N, BATCH):
        batch = pkg.io.DataBatch(
            data=[pkg.nd.array(X[i:i + BATCH], ctx=pkg.cpu())],
            label=[pkg.nd.array(Y[i:i + BATCH], ctx=pkg.cpu())])
        seq.forward(batch, is_train=True)
        outs.append(seq.get_outputs()[0].asnumpy())
        seq.backward()
        seq.update()
    return {k: v.asnumpy() for k, v in seq.get_params()[0].items()}, outs


def test_chain_closed_by_a_python_loss_module_matches_jax():
    want, wouts = _loss_chain(mx)
    got, gouts = _loss_chain(mt)
    for g, w in zip(gouts, wouts):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize('custom', [False, True])
def test_python_loss_module_matches_jax(custom):
    scores = np.array([[2.0, 1.0, 0.0], [0.0, 1.0, 2.0]], np.float32)
    labels = np.array([0, 2], np.float32)
    res = []
    for pkg in (mx, mt):
        mod = pkg.mod.PythonLossModule(
            name='l', grad_func=_ce_grad(pkg) if custom else None)
        mod.bind(data_shapes=[('data', (2, 3))],
                 label_shapes=[('softmax_label', (2,))])
        mod.init_params()
        batch = pkg.io.DataBatch(data=[pkg.nd.array(scores, ctx=pkg.cpu())],
                                 label=[pkg.nd.array(labels, ctx=pkg.cpu())])
        mod.forward(batch, is_train=True)
        mod.backward()
        res.append((mod.output_shapes, mod.get_params(),
                    mod.get_outputs()[0].asnumpy(),
                    mod.get_input_grads()[0].asnumpy()))
        with pytest.raises(ValueError):
            mod.backward(out_grads=[pkg.nd.ones((2, 3), ctx=pkg.cpu())])
    (jshape, jparams, jout, jgrad), (tshape, tparams, tout, tgrad) = res
    assert tshape == jshape == [('l_output', (2, 3))]
    assert tparams == jparams == ({}, {})
    np.testing.assert_array_equal(tout, jout)
    np.testing.assert_allclose(tgrad, jgrad, rtol=1e-6, atol=1e-7)


def _scaler(pkg):
    class Scale(pkg.mod.PythonModule):
        """A user's parameter-free module: y = 3 x, dy/dx = 3."""

        def __init__(self):
            super().__init__(['data'], ['softmax_label'], ['scale_output'])

        def _compute_output_shapes(self):
            return [('scale_output', self._data_shapes[0][1])]

        def forward(self, data_batch, is_train=None):
            self._x = data_batch.data[0]
            self._y = self._x * 3

        def get_outputs(self, merge_multi_context=True):
            return [self._y]

        def backward(self, out_grads=None):
            self._g = out_grads[0] * 3

        def get_input_grads(self, merge_multi_context=True):
            return [self._g]
    return Scale()


def test_python_module_matches_jax():
    res = []
    for pkg in (mx, mt):
        mod = _scaler(pkg)
        mod.bind(data_shapes=[('data', (4, 2))],
                 label_shapes=[('softmax_label', (4,))])
        mod.init_params()
        mod.init_optimizer()
        x = pkg.nd.array(X[:4, :2], ctx=pkg.cpu())
        mod.forward(pkg.io.DataBatch(data=[x], label=None))
        mod.backward([pkg.nd.ones((4, 2), ctx=pkg.cpu())])
        mod.update()
        metric = pkg.metric.MSE()
        mod.update_metric(metric, [pkg.nd.zeros((4, 2), ctx=pkg.cpu())])
        res.append((mod.output_shapes, mod.get_outputs()[0].asnumpy(),
                    mod.get_input_grads()[0].asnumpy(), metric.get(),
                    mod.optimizer_initialized, mod.params_initialized))
    for t, j in zip(res[1], res[0]):
        if isinstance(j, np.ndarray):
            np.testing.assert_array_equal(t, j)
        elif isinstance(j, tuple) and isinstance(j[1], float):
            assert t[0] == j[0]
            np.testing.assert_allclose(t[1], j[1], rtol=1e-6)
        else:
            assert t == j


def test_chain_checks_match_jax():
    for pkg in (mx, mt):
        seq = pkg.mod.SequentialModule()
        with pytest.raises(AssertionError, match='Unknown meta'):
            seq.add(_first(pkg), take_label=True)
        seq = pkg.mod.SequentialModule()
        seq.add(_first(pkg)).add(_first(pkg), auto_wiring=True)
        seq.bind(data_shapes=[('data', (BATCH, D))])
        with pytest.raises(AssertionError, match='Duplicated parameter'):
            seq.init_params()
