"""The port's autograd (mxnet_tpu_torch.autograd with NDArray's
attach_grad/grad/backward and recording in ``invoke``) against the JAX
package's, on the same numpy inputs, on the CPU.

Covered: record/pause and the train/predict flag apart from recording
(BatchNorm reads it), backward with head gradients and several heads,
``retain_graph``, ``grad_req`` 'write' (the first backward after
attach_grad writes, later ones add, as in the JAX tape), 'add' and
'null', ``grad``/``grad_and_loss``, a user ``Function``, indexing under
record, writes (``x[:] = ...``, ``out=``, an optimizer update) into arrays
the graph holds, ``get_symbol``, and the kernel ops LayerNorm, softmax and
softmax_cross_entropy on both of their branches (``MXTPU_FORCE_PALLAS``:
the kernel wrappers' autograd Functions, plain versions on the CPU).

Tolerances: f32 gradients rtol 1e-5, atol 1e-6 (the same f32 arithmetic in
another order: a few ulps); exact where both sides compute one rounding of
the same values (the elementwise chains, the grad_req bookkeeping).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd, nd

TOL = dict(rtol=1e-5, atol=1e-6)
R = np.random.RandomState(0)
X = R.randn(3, 4).astype(np.float32)
Y = R.randn(3, 4).astype(np.float32)


def _pair(a):
    return mx.nd.array(a), nd.array(a, ctx=mt.cpu())


def _both(fn, arrays, head=None, reqs=None):
    """Run fn(F, *arrays) under record on both sides, backward (with
    ``head`` as the head gradient), and return both sides' output and
    gradients."""
    res = []
    for F, lib in ((mx.nd, mx), (nd, mt)):
        xs = [F.array(a) if F is mx.nd else F.array(a, ctx=mt.cpu())
              for a in arrays]
        for i, x in enumerate(xs):
            x.attach_grad(reqs[i] if reqs else 'write')
        with lib.autograd.record():
            y = fn(F, *xs)
        if head is None:
            y.backward()
        else:
            y.backward(F.array(head) if F is mx.nd else
                       F.array(head, ctx=mt.cpu()))
        res.append((y.asnumpy(), [x.grad.asnumpy() for x in xs]))
    return res


def _close(a, b):
    np.testing.assert_allclose(a, b, **TOL)


def test_elementwise_chain_matches_jax():
    (wy, wg), (gy, gg) = _both(
        lambda F, x, y: F.sum(F.sin(x) * y + x * x / (1 + F.exp(y))),
        [X, Y])
    _close(gy, wy)
    for a, b in zip(gg, wg):
        _close(a, b)


def test_head_gradient_and_broadcast_match_jax():
    head = R.randn(3, 4).astype(np.float32)
    (wy, wg), (gy, gg) = _both(
        lambda F, x, b: F.broadcast_mul(x, b) - F.relu(x), [X, Y[:1]],
        head=head)
    for a, b in zip(gg, wg):
        _close(a, b)


def test_indexing_under_record_matches_jax():
    (wy, wg), (gy, gg) = _both(lambda F, x: (x[1:, ::2] * 3).sum(), [X])
    np.testing.assert_array_equal(gg[0], wg[0])


def test_several_heads_and_retain_graph():
    x = nd.array(X, ctx=mt.cpu())
    x.attach_grad()
    with autograd.record():
        a = x * 2
        b = (x * x).sum()
    autograd.backward([a, b], retain_graph=True)
    np.testing.assert_allclose(x.grad.asnumpy(), 2 + 2 * X, rtol=1e-6)
    b.backward()                    # the graph was kept: adds to 'write'
    np.testing.assert_allclose(x.grad.asnumpy(), 2 + 4 * X, rtol=1e-6)
    with pytest.raises(ValueError):
        nd.array(X, ctx=mt.cpu()).backward()   # outside any graph


@pytest.mark.parametrize('req', ['write', 'add', 'null'])
def test_grad_req_over_two_backwards_matches_jax(req):
    """'write' writes the first gradient after attach_grad and adds the
    later ones (the JAX tape's bookkeeping); 'add' adds; 'null' keeps
    zeros."""
    got = []
    for F, lib in ((mx.nd, mx), (nd, mt)):
        x = F.array(X) if F is mx.nd else F.array(X, ctx=mt.cpu())
        x.attach_grad(req)
        grads = []
        for k in range(2):
            with lib.autograd.record():
                y = (x * (k + 1.0)).sum()
            y.backward()
            grads.append(x.grad.asnumpy().copy())
        got.append(grads)
    for a, b in zip(got[1], got[0]):
        np.testing.assert_array_equal(a, b)


def test_grad_and_loss_and_grad_match_jax():
    def f(x, y):
        return (x * y).sum() + (x * x).sum()
    outs = []
    for F, lib in ((mx.nd, mx), (nd, mt)):
        args = [F.array(a) if F is mx.nd else F.array(a, ctx=mt.cpu())
                for a in (X, Y)]
        grads, loss = lib.autograd.grad_and_loss(f)(*args)
        g1 = lib.autograd.grad(f, argnum=1)(*[a.copy() for a in args])
        outs.append((loss.asnumpy(), [g.asnumpy() for g in grads],
                     g1[0].asnumpy()))
    _close(outs[1][0], outs[0][0])
    for a, b in zip(outs[1][1], outs[0][1]):
        _close(a, b)
    _close(outs[1][2], outs[0][2])


def _sigmoid_function(lib):
    class Sigmoid(lib.autograd.Function):
        def forward(self, x):
            y = 1 / (1 + lib.nd.exp(-x))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            y, = self.saved_tensors
            return dy * y * (1 - y) * 2     # twice the true gradient
    return Sigmoid


def test_function_matches_jax():
    (wy, wg), (gy, gg) = _both(
        lambda F, x: (_sigmoid_function(mx if F is mx.nd else mt)()(x)
                      * 3).sum(), [X])
    _close(gy, wy)
    _close(gg[0], wg[0])
    s = 1 / (1 + np.exp(-X))
    _close(gg[0], 6 * s * (1 - s))


def test_pause_and_train_mode_are_separate():
    x = nd.array(X, ctx=mt.cpu())
    x.attach_grad()
    with autograd.record():
        assert autograd.is_recording() and autograd.is_training()
        with autograd.pause():
            assert not autograd.is_recording() and not autograd.is_training()
            z = x * 5                       # not recorded
        y = (x * 2).sum() + (z * 0).sum()
    assert z._data.grad_fn is None
    y.backward()
    np.testing.assert_array_equal(x.grad.asnumpy(), np.full_like(X, 2))
    with autograd.record(train_mode=False):
        assert autograd.is_recording() and not autograd.is_training()
    with autograd.train_mode():
        assert autograd.is_training() and not autograd.is_recording()
    with autograd.predict_mode():
        assert not autograd.is_training()


@pytest.mark.parametrize('train', [True, False])
def test_batchnorm_reads_the_train_flag_not_recording(train):
    """Under record(train_mode=False) BatchNorm normalises by its moving
    statistics and leaves them, as the JAX op does; in training it updates
    them. Values and gradients match the JAX package's."""
    data = R.randn(4, 3, 2, 2).astype(np.float32) + 1
    res = []
    for F, lib in ((mx.nd, mx), (nd, mt)):
        arr = (lambda a: F.array(a)) if F is mx.nd else \
            (lambda a: F.array(a, ctx=mt.cpu()))
        x, g, b = arr(data), arr(np.ones(3) * 1.5), arr(np.zeros(3) + 0.1)
        mm, mv = arr(np.zeros(3) + 0.2), arr(np.ones(3) * 2)
        for v in (x, g, b):
            v.attach_grad()
        with lib.autograd.record(train_mode=train):
            y = F.BatchNorm(x, g, b, mm, mv, fix_gamma=False)
            loss = (y * y).sum()
        loss.backward()
        res.append([y.asnumpy(), mm.asnumpy(), mv.asnumpy()] +
                   [v.grad.asnumpy() for v in (x, g, b)])
    for a, b in zip(res[1], res[0]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    if not train:
        np.testing.assert_array_equal(res[1][1], np.full(3, 0.2, np.float32))


def test_writes_into_arrays_the_graph_holds():
    """``x[:] = ...`` and ``out=`` rebind an array to a new tensor (no
    in-place write reaches a tensor the graph saved), a marked variable
    stays a leaf through them, and an optimizer's ``out=weight`` update
    keeps the weight a variable."""
    x = nd.array(X, ctx=mt.cpu())
    x.attach_grad()
    with autograd.record():
        y = x * x
        z = y * 2
        y[:] = 0                        # y leaves the graph; z keeps it
        nd.relu(z, out=y)               # y now holds relu(z)
        loss = (y + z).sum()
    loss.backward()
    want = np.where(X * X > 0, 4 * X, 0) + 4 * X
    np.testing.assert_allclose(x.grad.asnumpy(), want, rtol=1e-6)
    x[:] = 1.0                          # still a variable
    nd.sgd_update(x, nd.ones_like(x), lr=0.5, out=x)
    with autograd.record():
        loss = (x * 3).sum()
    loss.backward()
    assert x._data.is_leaf and x._data.requires_grad
    # 'write': the second backward since attach_grad adds to the first
    np.testing.assert_allclose(x.grad.asnumpy(), want + 3, rtol=1e-6)


@pytest.mark.parametrize('force', ['0', '1'])
def test_kernel_ops_under_record_match_jax(force, monkeypatch):
    """LayerNorm, softmax and softmax_cross_entropy under record, on the
    plain branch and (MXTPU_FORCE_PALLAS=1) the kernel branch: the kernel
    wrappers' autograd Functions here, the Pallas kernels in interpret mode
    in the JAX package."""
    monkeypatch.setenv('MXTPU_FORCE_PALLAS', force)
    x = R.randn(4, 16).astype(np.float32)
    gamma = 1 + 0.1 * R.randn(16).astype(np.float32)
    beta = 0.1 * R.randn(16).astype(np.float32)
    lab = np.array([1, 15, 0, 7], np.float32)
    head = R.randn(4, 16).astype(np.float32)

    def f(F, x, g, b, s):
        h = F.LayerNorm(x, g, b)
        p = F.softmax(h * s)
        return F.softmax_cross_entropy(h + p, F.array(lab) if F is mx.nd
                                       else F.array(lab, ctx=mt.cpu()))
    (wy, wg), (gy, gg) = _both(f, [x, gamma, beta, head])
    np.testing.assert_allclose(gy, wy, rtol=1e-5)
    for a, b in zip(gg, wg):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_get_symbol_matches_jax():
    syms = []
    for F, lib in ((mx.nd, mx), (nd, mt)):
        x = F.array(X) if F is mx.nd else F.array(X, ctx=mt.cpu())
        x.attach_grad()
        with lib.autograd.record():
            y = F.relu(F.FullyConnected(x, F.ones((2, 4)) if F is mx.nd
                                        else F.ones((2, 4), ctx=mt.cpu()),
                                        no_bias=True, num_hidden=2)) * 2
        syms.append(lib.autograd.get_symbol(y))
    assert syms[1].list_arguments() == syms[0].list_arguments()
    assert [n['op'] for n in __import__('json').loads(syms[1].tojson())
            ['nodes']] == [n['op'] for n in __import__('json').loads(
                syms[0].tojson())['nodes']]
