"""The port's CTC loss (mxnet_tpu_torch.ops.contrib_ops: _contrib_CTCLoss
and its names ctc_loss and _contrib_ctc_loss) and gluon.loss.CTCLoss
against the JAX package's, on the CPU.

Cases: blank 'first' and 'last', label lengths from the blank convention,
``padding_mask``, ``use_label_lengths``, ``use_data_lengths``, a repeated
label, and the two behaviours of the JAX recursion that the port keeps
(ROADMAP.md §3): an empty label's loss is the true loss less ln 2 (9.4110
on ``RandomState(0).randn(4, 2, 5)``), and an alignment that cannot fit
gives 1e10. Values and the gradient of the data for one cotangent, against
the JAX op and its ``jax.vjp`` (every case in one jitted program).

Tolerances (|port - jax| <= atol + rtol * |jax|): f32 loss rtol 1e-5; the
gradient rtol 1e-5, atol 1e-5 x the case's largest |jax| value (both
sides run the same log-space recursion in f32, the log-sum-exps in
another order). The infeasible case's gradient is held finite only: every
alpha there sits beside -1e10, where an f32 ulp is 1024, so its gradient
is the rounding of log-sum-exps of equal values, which the two autograds
weigh differently (1 against 1/2); it has no meaning in either package.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.ops import registry as treg


def _case(cid, data, label, attrs, extra=()):
    rng = np.random.RandomState(len(cid))
    return dict(id=cid, inputs=[data, label] + list(extra), attrs=attrs,
                cot=rng.randn(data.shape[1]).astype(np.float32))


R = np.random.RandomState(1)
D45 = R.randn(7, 3, 5).astype(np.float32)
CASES = [
    _case('blank-first', D45,
          np.array([[1, 2, 2], [3, 0, 0], [4, 1, 3]], np.float32), {}),
    _case('blank-last', D45,
          np.array([[0, 1, 1], [3, 4, 4], [2, 0, 3]], np.float32),
          {'blank_label': 'last'}),
    _case('padding-mask', D45,
          np.array([[1, 2, -1], [3, -1, -1], [4, 1, 3]], np.float32),
          {'padding_mask': -1}),
    _case('label-lengths', D45,
          np.array([[1, 2, 2], [3, 3, 0], [4, 1, 3]], np.float32),
          {'use_label_lengths': True},
          [np.array([2, 2, 3], np.float32)]),
    _case('data-lengths', D45,
          np.array([[1, 2, 0], [3, 0, 0], [4, 1, 3]], np.float32),
          {'use_data_lengths': True}, [np.array([5, 7, 6], np.float32)]),
    _case('both-lengths', D45,
          np.array([[1, 2, 2], [3, 3, 0], [4, 1, 3]], np.float32),
          {'use_data_lengths': True, 'use_label_lengths': True},
          [np.array([4, 7, 6], np.float32), np.array([2, 1, 3], np.float32)]),
    # the issue's case: an empty label (the true loss less ln 2)
    _case('empty-label', np.random.RandomState(0).randn(4, 2, 5)
          .astype(np.float32), np.array([[0, 0], [1, 2]], np.float32), {}),
    # 5 labels cannot fit 3 steps: 1e10
    _case('infeasible', np.random.RandomState(0).randn(3, 1, 6)
          .astype(np.float32), np.array([[1, 2, 3, 4, 5]], np.float32), {}),
]


@pytest.fixture(scope='module')
def jax_results():
    fn = jreg.get('_contrib_CTCLoss').fn

    def one(case, inputs, cot):
        def f(data):
            return fn(case['attrs'], data, *inputs[1:])
        loss, vjp = jax.vjp(f, inputs[0])
        return loss, vjp(cot)[0]

    def all_cases(inputs, cots):
        return [one(c, i, k) for c, i, k in zip(CASES, inputs, cots)]
    res = jax.jit(all_cases)([c['inputs'] for c in CASES],
                             [c['cot'] for c in CASES])
    return {c['id']: (np.asarray(l), np.asarray(g))
            for c, (l, g) in zip(CASES, res)}


def _port(case, name='_contrib_CTCLoss'):
    data = torch.tensor(case['inputs'][0], requires_grad=True)
    rest = [torch.from_numpy(a) for a in case['inputs'][1:]]
    loss = treg.get(name).fn(case['attrs'], data, *rest)
    loss.backward(torch.from_numpy(case['cot']))
    return loss.detach().numpy(), data.grad.numpy()


@pytest.mark.parametrize('case', CASES, ids=[c['id'] for c in CASES])
def test_ctc_matches_jax(case, jax_results):
    loss, grad = _port(case)
    want_loss, want_grad = jax_results[case['id']]
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5, atol=0)
    if case['id'] == 'infeasible':
        assert np.isfinite(grad).all() and np.isfinite(want_grad).all()
        return
    atol = 1e-5 * float(np.abs(want_grad).max())
    np.testing.assert_allclose(grad, want_grad, rtol=1e-5, atol=atol)


def test_kept_quirks_values(jax_results):
    """The values ROADMAP.md §3 names, in both packages."""
    loss, _ = _port(CASES[6])
    np.testing.assert_allclose(loss[0], 9.4110, atol=1e-4)
    np.testing.assert_allclose(jax_results['empty-label'][0][0], 9.4110,
                               atol=1e-4)
    # F.ctc_loss, the true loss, is ln 2 more
    x = torch.from_numpy(CASES[6]['inputs'][0])
    true = torch.nn.functional.ctc_loss(
        x.log_softmax(-1), torch.tensor([[0, 0], [1, 2]]),
        torch.tensor([4, 4]), torch.tensor([0, 2]), reduction='none')
    np.testing.assert_allclose(true[0].item() - loss[0], np.log(2),
                               atol=1e-4)
    loss, _ = _port(CASES[7])
    assert loss[0] == np.float32(1e10)
    assert jax_results['infeasible'][0][0] == np.float32(1e10)


@pytest.mark.parametrize('name', ['ctc_loss', '_contrib_ctc_loss'])
def test_aliases_are_the_op(name, jax_results):
    assert treg.get(name) is treg.get('_contrib_CTCLoss')
    assert jreg.get(name) is jreg.get('_contrib_CTCLoss')
    loss, grad = _port(CASES[0], name)
    np.testing.assert_allclose(loss, jax_results['blank-first'][0],
                               rtol=1e-5)


def test_nd_contrib_namespace_and_autograd(jax_results):
    """nd.contrib.CTCLoss with a label-lengths input, recorded: the
    gradient reaches the data. (The optional input goes positionally, as
    gluon's CTCLoss passes it: by keyword, the nd frontend of both packages
    stops at the first missing input, data_lengths, and drops it.)"""
    case = CASES[3]
    with mt.cpu():
        x = nd.array(case['inputs'][0])
        x.attach_grad()
        with autograd.record():
            loss = nd.contrib.CTCLoss(x, nd.array(case['inputs'][1]),
                                      nd.array(case['inputs'][2]),
                                      use_label_lengths=True)
        loss.backward(nd.array(case['cot']))
    want_loss, want_grad = jax_results['label-lengths']
    np.testing.assert_allclose(loss.asnumpy(), want_loss, rtol=1e-5)
    np.testing.assert_allclose(x.grad.asnumpy(), want_grad, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want_grad).max()))
    assert set(n for n in dir(mt.sym.contrib) if not n.startswith('_')) == \
        set(n for n in dir(nd.contrib) if not n.startswith('_'))


@pytest.mark.parametrize('layout,label_layout',
                         [('NTC', 'NT'), ('TNC', 'TN')])
@pytest.mark.parametrize('hybrid', [False, True])
def test_gluon_ctc_loss_matches_jax(layout, label_layout, hybrid):
    rng = np.random.RandomState(4)
    data = rng.randn(8, 2, 6).astype(np.float32)        # TNC
    label = np.array([[1, 3, 3, -1], [2, 5, -1, -1]], np.float32)
    if layout == 'NTC':
        data = data.transpose(1, 0, 2)
    if label_layout == 'TN':
        label = label.T
    jl = mx.gluon.loss.CTCLoss(layout=layout, label_layout=label_layout)
    want = jl(mx.nd.array(data), mx.nd.array(label)).asnumpy()
    tl = gluon.loss.CTCLoss(layout=layout, label_layout=label_layout)
    if hybrid:
        tl.hybridize()
    with mt.cpu():
        x = nd.array(data)
        x.attach_grad()
        with autograd.record():
            got = tl(x, nd.array(label))
        got.backward()
    np.testing.assert_allclose(got.asnumpy(), want, rtol=1e-5)
    assert np.isfinite(x.grad.asnumpy()).all()
