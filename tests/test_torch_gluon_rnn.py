"""The port's gluon.rnn (mxnet_tpu_torch.gluon.rnn: the recurrent cells
and the fused RNN, LSTM and GRU layers) against the JAX package's on the
same weights (carried across by ``params_from_numpy``) and inputs, on the
CPU, in the cases of ``tests/unittest/test_gluon_rnn.py``.

Each case: the outputs and final states of a cell unrolled (or a layer
called) in both packages, and the gradients of the input and of every
parameter of the sum of the outputs weighted by a fixed cotangent, under
``autograd.record()``; hybridized blocks against the JAX package's too.
Tolerance: f32 rtol 1e-5, atol 1e-5 x the largest |jax| value of the
array (the same f32 ops; the fused layer runs torch's LSTM/GRU against
the JAX package's scan, the matmuls summed in another order).
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

B, T, D, H = 3, 4, 5, 6


def _close(got, want, what):
    atol = 1e-5 * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol, err_msg=what)


def _run(pkg, block, x, states, weights, call, hybridize=False):
    """Initialise ``block`` in ``pkg``, set ``weights`` (the JAX block's
    when None), run ``call`` under autograd against a fixed cotangent and
    return (outputs, grads by name, weights)."""
    ctx = pkg.cpu()
    with ctx:
        return _run_on(pkg, ctx, block, x, states, weights, call, hybridize)


def _run_on(pkg, ctx, block, x, states, weights, call, hybridize):
    block.initialize(ctx=ctx)
    if weights is None:
        rng = np.random.RandomState(1)
        weights = {}
        for n, p in block.collect_params().items():
            try:
                shape = p.data(ctx).shape
            except Exception:        # deferred: shapes from a first call
                call(block, pkg.nd.array(x, ctx=ctx), None)
                shape = p.data(ctx).shape
            weights[n] = rng.uniform(-0.4, 0.4, shape).astype(np.float32)
        for n, v in weights.items():
            block.collect_params()[n].set_data(pkg.nd.array(v, ctx=ctx))
    elif pkg is mx:
        for n, v in weights.items():
            block.collect_params()[n].set_data(pkg.nd.array(v, ctx=ctx))
    else:
        try:
            mt.gluon.params_from_numpy(block, weights)
        except mt.gluon.DeferredInitializationError:
            call(block, pkg.nd.array(x, ctx=ctx), None)
            mt.gluon.params_from_numpy(block, weights)
    if hybridize:
        block.hybridize()
    xx = pkg.nd.array(x, ctx=ctx)
    xx.attach_grad()
    st = None if states is None else [pkg.nd.array(s, ctx=ctx)
                                      for s in states]
    with pkg.autograd.record():
        outs = call(block, xx, st)
        flat = []
        for o in outs:
            flat += o if isinstance(o, list) else [o]
        rng = np.random.RandomState(2)
        loss = None
        for o in flat:
            c = pkg.nd.array(rng.randn(*o.shape).astype(np.float32), ctx=ctx)
            term = pkg.nd.sum(o * c)
            loss = term if loss is None else loss + term
    loss.backward()
    grads = {'x': xx.grad.asnumpy()}
    grads.update({n: p.grad(ctx).asnumpy()
                  for n, p in block.collect_params().items()})
    return [o.asnumpy() for o in flat], grads, weights


def _unroll_call(layout='NTC', merge=True):
    def call(block, x, states):
        outs, st = block.unroll(T, x, begin_state=states, layout=layout,
                                merge_outputs=merge)
        return (outs if isinstance(outs, list) else [outs]) + list(st)
    return call


def _layer_call(block, x, states):
    if states is None:
        return [block(x)]
    out, st = block(x, states)
    return [out] + list(st)


def _seq(p):
    s = p.gluon.rnn.SequentialRNNCell(prefix='seq_')
    with s.name_scope():
        s.add(p.gluon.rnn.LSTMCell(H, input_size=D))
        s.add(p.gluon.rnn.DropoutCell(0.0))
        s.add(p.gluon.rnn.GRUCell(H, input_size=H))
    return s


def _xs(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


CASES = {
    # cells, unrolled
    'lstm-cell': (lambda p: p.gluon.rnn.LSTMCell(H, input_size=D,
                                                 prefix='lstm_'),
                  (B, T, D), None, _unroll_call()),
    'gru-cell-tnc': (lambda p: p.gluon.rnn.GRUCell(H, input_size=D,
                                                   prefix='gru_'),
                     (T, B, D), None, _unroll_call('TNC')),
    'rnn-cell-list': (lambda p: p.gluon.rnn.RNNCell(H, activation='relu',
                                                    input_size=D,
                                                    prefix='rnn_'),
                      (B, T, D), None, _unroll_call(merge=False)),
    'sequential': (_seq, (B, T, D), None, _unroll_call()),
    'bidirectional': (lambda p: p.gluon.rnn.BidirectionalCell(
        p.gluon.rnn.LSTMCell(H, input_size=D, prefix='l_'),
        p.gluon.rnn.LSTMCell(H, input_size=D, prefix='r_')),
        (B, T, D), None, _unroll_call()),
    'residual': (lambda p: p.gluon.rnn.ResidualCell(
        p.gluon.rnn.GRUCell(D, input_size=D, prefix='res_')),
        (B, T, D), None, _unroll_call()),
    # explicit zero begin states: the JAX package's ZoneoutCell cannot
    # make its own (test_zoneout_makes_its_begin_state)
    'zoneout': (lambda p: p.gluon.rnn.ZoneoutCell(
        p.gluon.rnn.RNNCell(H, input_size=D, prefix='z_')),
        (B, T, D), [np.zeros((B, H), np.float32)], _unroll_call()),
    # layers
    'lstm-layer-ntc': (lambda p: p.gluon.rnn.LSTM(H, num_layers=2,
                                                  layout='NTC',
                                                  input_size=D,
                                                  prefix='lstm_'),
                       (B, T, D), None, _layer_call),
    'lstm-layer-states': (lambda p: p.gluon.rnn.LSTM(H, num_layers=1,
                                                     input_size=D,
                                                     prefix='lstm_'),
                          (T, B, D), [_xs((1, B, H), 3), _xs((1, B, H), 4)],
                          _layer_call),
    'gru-layer-bi': (lambda p: p.gluon.rnn.GRU(H, num_layers=2,
                                               bidirectional=True,
                                               layout='NTC', input_size=D,
                                               prefix='gru_'),
                     (B, T, D), None, _layer_call),
    'rnn-layer-tnc': (lambda p: p.gluon.rnn.RNN(H, num_layers=1,
                                                layout='TNC', input_size=D,
                                                prefix='rnn_'),
                      (T, B, D), [_xs((1, B, H), 5)], _layer_call),
    'lstm-layer-deferred': (lambda p: p.gluon.rnn.LSTM(H, num_layers=2,
                                                       prefix='lstmd_'),
                            (T, B, D), None, _layer_call),
}


@pytest.mark.parametrize('name', sorted(CASES))
def test_matches_jax(name):
    make, shape, states, call = CASES[name]
    x = _xs(shape)
    with mx.name.NameManager():
        want, wgrads, weights = _run(mx, make(mx), x, states, None, call)
    with mt.name.NameManager():
        got, grads, _ = _run(mt, make(mt), x, states, weights, call)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        _close(g, w, 'output %d' % i)
    assert sorted(grads) == sorted(wgrads)
    for n in wgrads:
        _close(grads[n], wgrads[n], 'gradient of %s' % n)


def test_hybridized_cell_matches_eager_and_jax():
    """A hybridized GRUCell step against its imperative step and the JAX
    package's hybridized step."""
    x = _xs((B, D), 5)
    states = [_xs((B, H), 6)]

    def step(block, xx, st):
        out, new = block(xx, st if st is not None
                         else block.begin_state(batch_size=B))
        return [out] + list(new)
    with mx.name.NameManager():
        jcell = mx.gluon.rnn.GRUCell(H, input_size=D, prefix='g_')
        # the JAX block keeps its first call's train flag (ROADMAP.md §3):
        # a first call in training, then hybridize
        want, wgrads, weights = _run(mx, jcell, x, states, None, step)
        want_h, _, _ = _run(mx, jcell, x, states, weights, step,
                            hybridize=True)
    outs = {}
    for hybrid in (False, True):
        with mt.name.NameManager():
            tcell = mt.gluon.rnn.GRUCell(H, input_size=D, prefix='g_')
            outs[hybrid] = _run(mt, tcell, x, states, weights, step,
                                hybridize=hybrid)
    for g, w in zip(outs[False][0], want):
        _close(g, w, 'imperative')
    for g, w in zip(outs[True][0], want_h):
        _close(g, w, 'hybridized')
    for n in wgrads:
        _close(outs[True][1][n], wgrads[n], 'hybridized gradient of %s' % n)


def test_layer_equals_its_cell_on_packed_weights():
    """An LSTM layer equals its cell unrolled on the same weights packed
    into the layer's flat vector (the fused op's layout)."""
    x = _xs((B, T, D), 1)
    with mt.name.NameManager(), mt.cpu():
        cell = mt.gluon.rnn.LSTMCell(H, input_size=D, prefix='c_')
        layer = mt.gluon.rnn.LSTM(H, num_layers=1, layout='NTC',
                                  input_size=D, prefix='l_')
        cell.initialize(mt.init.Xavier())
        layer.initialize()
        cp = {k[len('c_'):]: v.data().asnumpy()
              for k, v in cell.collect_params().items()}
        flat = np.concatenate([cp['i2h_weight'].ravel(),
                               cp['h2h_weight'].ravel(),
                               cp['i2h_bias'], cp['h2h_bias']])
        mt.gluon.params_from_numpy(layer, {'l_parameters': flat})
        xx = mt.nd.array(x)
        out_cell, _ = cell.unroll(T, xx, layout='NTC', merge_outputs=True)
        _close(layer(xx).asnumpy(), out_cell.asnumpy(), 'layer against cell')
    assert repr(layer) == repr(mx.gluon.rnn.LSTM(H, num_layers=1,
                                                 layout='NTC',
                                                 input_size=D))


def test_zoneout_makes_its_begin_state():
    """The port's ZoneoutCell (and ResidualCell) unroll without begin
    states, from zeros; the JAX package's ZoneoutCell raises there."""
    x = _xs((B, T, D), 7)
    with mx.name.NameManager():
        jcell = mx.gluon.rnn.ZoneoutCell(
            mx.gluon.rnn.RNNCell(H, input_size=D, prefix='z_'))
    jcell.initialize()
    with pytest.raises(TypeError):
        jcell.unroll(T, mx.nd.array(x), layout='NTC', merge_outputs=True)
    with mt.name.NameManager(), mt.cpu():
        for make in (lambda: mt.gluon.rnn.ZoneoutCell(
                         mt.gluon.rnn.RNNCell(H, input_size=D, prefix='z_')),
                     lambda: mt.gluon.rnn.ResidualCell(
                         mt.gluon.rnn.RNNCell(D, input_size=D,
                                              prefix='r_'))):
            cell = make()
            cell.initialize()
            xx = mt.nd.array(x)
            own, _ = cell.unroll(T, xx, layout='NTC', merge_outputs=True)
            zeros = [mt.nd.zeros(s['shape'])
                     for s in cell.state_info(B)]
            given, _ = cell.unroll(T, xx, begin_state=zeros, layout='NTC',
                                   merge_outputs=True)
            np.testing.assert_array_equal(own.asnumpy(), given.asnumpy())
