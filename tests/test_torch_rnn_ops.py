"""The port's fused RNN op (mxnet_tpu_torch.ops.rnn_ops) against the JAX
package's on the same numpy inputs, on the CPU.

- ``RNN`` for lstm, gru, rnn_tanh and rnn_relu, one and two directions,
  one and two layers, with and without ``state_outputs``: outputs and the
  gradients of data, parameters and states for one cotangent, against the
  JAX op's function and its ``jax.vjp`` (every case in one jitted program).
- ``rnn_param_size`` and the Symbol side (argument names, the shape hook)
  equal to the JAX package's.
- The fused body (torch's recurrent entries) against the per-step plain
  version ``_rnn_plain``, as ``chip_smoke.py`` holds them on the card.
- Dropout between layers by rate (the two packages' generators differ).

Tolerances (|port - jax| <= atol + rtol * |jax|, elementwise): f32 values
and gradients rtol 1e-5, atol 1e-5 x the case's largest |jax| value (both
in f32, the gate matmuls summed in another order); the fused body against
the plain version likewise.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.ops import rnn_ops as jrnn
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.ops import rnn_ops as trnn

T, N, I, H = 6, 3, 5, 4
MODES = ('lstm', 'gru', 'rnn_tanh', 'rnn_relu')


def _case(mode, bidir, layers, state_outputs, seed):
    rng = np.random.RandomState(seed)
    dirs = 2 if bidir else 1
    size = jrnn.rnn_param_size(layers, H, I, bidir, mode)
    inputs = [rng.randn(T, N, I).astype(np.float32),
              rng.uniform(-0.5, 0.5, size).astype(np.float32),
              rng.randn(layers * dirs, N, H).astype(np.float32)]
    if mode == 'lstm':
        inputs.append(rng.randn(layers * dirs, N, H).astype(np.float32))
    attrs = {'state_size': H, 'num_layers': layers, 'bidirectional': bidir,
             'mode': mode, 'state_outputs': state_outputs, 'p': 0.0}
    n_states = 2 if mode == 'lstm' else 1
    out_shapes = [(T, N, dirs * H)] + [(layers * dirs, N, H)] * n_states
    cots = [rng.randn(*s).astype(np.float32) for s in out_shapes]
    if not state_outputs:
        cots = cots[:1]
    return dict(id='%s-%s-l%d-%s' % (mode, 'bi' if bidir else 'uni', layers,
                                     'states' if state_outputs else 'out'),
                attrs=attrs, inputs=inputs, cots=cots)


# every combination, held to the plain version (with and without state
# outputs on the same inputs)
ALL = [_case(m, b, l, so, seed)
       for seed, (m, b, l) in enumerate(
           (m, b, l) for m in MODES for b in (False, True) for l in (1, 2))
       for so in (False, True)]
# held to the JAX op: each mode one direction at one layer and two
# directions at two layers (the second layer reads both directions), with
# and without state outputs (one JAX program: the outputs-only case is the
# same vjp with zero cotangents for the states)
CASES = [c for c in ALL if (c['attrs']['num_layers'] == 2)
         == c['attrs']['bidirectional']]


@pytest.fixture(scope='module')
def jax_results():
    """Outputs and input gradients of every case, one jitted program."""
    full = [c for c in CASES if c['attrs']['state_outputs']]

    def one(case, inputs, cots):
        attrs = dict(case['attrs'], __is_train__=False)
        fn = jreg.get('RNN').fn

        def f(*xs):
            return fn(attrs, *xs, jax.random.PRNGKey(0))
        outs, vjp = jax.vjp(f, *inputs)
        zero_states = (cots[0],) + tuple(jnp.zeros_like(c) for c in cots[1:])
        return outs, vjp(tuple(cots)), vjp(zero_states)

    def all_cases(inputs, cots):
        return [one(c, i, k) for c, i, k in zip(full, inputs, cots)]
    res = jax.jit(all_cases)([c['inputs'] for c in full],
                             [c['cots'] for c in full])
    out = {}
    for c, (outs, grads, grads0) in zip(full, res):
        outs = [np.asarray(o) for o in outs]
        out[c['id']] = (outs, [np.asarray(g) for g in grads])
        out[c['id'].replace('-states', '-out')] = (
            outs[:1], [np.asarray(g) for g in grads0])
    return out


def _port(case, fn=None):
    fn = fn or treg.get('RNN').fn
    xs = [torch.tensor(a, requires_grad=True) for a in case['inputs']]
    attrs = dict(case['attrs'], __is_train__=False)
    out = fn(attrs, *xs, None)
    outs = out if isinstance(out, tuple) else (out,)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in case['cots']])
    return ([o.detach().numpy() for o in outs],
            [x.grad.numpy() for x in xs])


def _close(got, want, what):
    atol = 1e-5 * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol, err_msg=what)


@pytest.mark.parametrize('case', CASES, ids=[c['id'] for c in CASES])
def test_rnn_matches_jax(case, jax_results):
    outs, grads = _port(case)
    want_outs, want_grads = jax_results[case['id']]
    assert len(outs) == len(want_outs)
    for i, (g, w) in enumerate(zip(outs, want_outs)):
        assert g.shape == w.shape
        _close(g, w, 'output %d' % i)
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        _close(g, w, 'gradient of input %d' % i)


@pytest.mark.parametrize('case', ALL, ids=[c['id'] for c in ALL])
def test_fused_body_matches_plain(case):
    outs, grads = _port(case)
    p_outs, p_grads = _port(case, trnn._rnn_plain)
    for g, w in zip(outs + grads, p_outs + p_grads):
        _close(g, w, 'fused against plain')


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('bidir', [False, True])
def test_param_size_and_symbol_match_jax(mode, bidir):
    for layers in (1, 3):
        assert trnn.rnn_param_size(layers, 7, 11, bidir, mode) == \
            jrnn.rnn_param_size(layers, 7, 11, bidir, mode)
    kw = dict(state_size=H, num_layers=2, bidirectional=bidir, mode=mode,
              state_outputs=True, name='rnn')
    js = mx.sym.RNN(mx.sym.Variable('data'), **kw)
    ts = mt.sym.RNN(mt.sym.Variable('data'), **kw)
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_outputs() == js.list_outputs()
    assert ts.infer_shape(data=(T, N, I)) == js.infer_shape(data=(T, N, I))


def test_registration_matches_jax():
    jop, top = jreg.get('RNN'), treg.get('RNN')
    assert top.input_names == jop.input_names
    assert top.param_defaults == jop.param_defaults
    assert top.needs_rng and top.train_aware
    for mode in MODES:
        for so in (False, True):
            attrs = {'mode': mode, 'state_outputs': so}
            assert top.n_outputs(attrs) == jop.n_outputs(attrs)


def test_nd_rnn_through_autograd():
    """nd.RNN records like any op: the gradient of the parameters reaches
    the NDArray, and equals the op's own."""
    case = ALL[3]
    with mt.cpu():
        xs = [nd.array(a) for a in case['inputs']]
        for x in xs:
            x.attach_grad()
        with autograd.record():
            outs = nd.RNN(*xs, **case['attrs'])
            outs = outs if isinstance(outs, list) else [outs]
        autograd.backward(outs, [nd.array(c) for c in case['cots']])
    _, grads = _port(case)
    for x, g in zip(xs, grads):
        np.testing.assert_array_equal(x.grad.asnumpy(), g)


def test_dropout_between_layers_by_rate():
    """p = 0.5 in training: the second layer sees the first's output kept
    at rate 1 - p and scaled by 1 / (1 - p); prediction is deterministic."""
    L, Hd, n, t = 2, 64, 16, 4
    size = trnn.rnn_param_size(L, Hd, Hd, False, 'rnn_relu')
    rng = np.random.RandomState(3)
    x = torch.from_numpy(np.abs(rng.randn(t, n, Hd)).astype(np.float32))
    params = torch.from_numpy(np.zeros(size, np.float32))
    ws, _ = trnn._unpack(params, L, Hd, Hd, 1, 'rnn_relu')
    # identity input weights, no recurrence: each layer is relu(x)
    ws[0][0][0].copy_(torch.eye(Hd))
    ws[1][0][0].copy_(torch.eye(Hd))
    h0 = torch.zeros(L, n, Hd)
    attrs = {'state_size': Hd, 'num_layers': L, 'mode': 'rnn_relu',
             'p': 0.5, '__is_train__': True}
    gen = torch.Generator().manual_seed(0)
    y = treg.get('RNN').fn(attrs, x, params, h0, gen)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.5) < 0.05
    nz = y[y != 0]
    torch.testing.assert_close(nz, 2 * x[y != 0])
    y_pred = treg.get('RNN').fn(dict(attrs, __is_train__=False), x, params,
                                h0, gen)
    torch.testing.assert_close(y_pred, x)
