"""The port's symbolic RNN stack (mxnet_tpu_torch.rnn: the cells,
BucketSentenceIter, the rnn checkpoints; mod.BucketingModule;
FeedForward over a sym_gen) against the JAX package's, on the CPU.

- Each cell of ``tests/unittest/test_rnn.py`` unrolled in both packages on
  the same weights and inputs (the convolutional cells too): the Symbols'
  arguments and outputs, and the forward, f32 rtol 1e-5 / atol 1e-6 (the
  same graph of f32 ops, the matmuls summed in another order).
- FusedRNNCell against its ``unfuse()`` cells on the same weights (the
  reference's unpack/pack layout; the JAX package's FusedRNNCell cannot
  unpack, ROADMAP.md §3), and the pack/unpack round trips, exact.
- BucketSentenceIter: the same batches in the same order for one
  ``random.seed``, exact.
- BucketingModule.fit over lstm_bucketing's model, cut to a vocabulary of
  20 and widths of 8, against the JAX package's BucketingModule driven
  batch by batch (f32, rtol 1e-4 / atol 1e-6: nine SGD steps of the same
  f32 arithmetic in another order). The driver syncs the default bucket
  after each update, as the reference shares its arrays; the JAX
  package's own fit loses the default bucket's updates (held as such
  below), the port's does not. No fused window is built for it, as in the
  JAX package. FeedForward over a sym_gen trains the same.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

B, T, D, H = 4, 5, 6, 7


def _unroll(pkg, cell, args_np=None, seed=0, merge=True, shape=None):
    """Bind the unrolled cell in ``pkg`` with random (or given) weights and
    return (outputs, weights, symbol)."""
    cell.reset()
    data = pkg.sym.Variable('data')
    shape = shape or (B, D)
    inputs = [pkg.sym.slice_axis(data, axis=1, begin=i, end=i + 1)
              .reshape(shape) for i in range(T)]
    outputs, _ = cell.unroll(T, inputs=inputs, merge_outputs=merge)
    out = outputs if merge else pkg.sym.Group(outputs)
    rng = np.random.RandomState(seed)
    dshape = (shape[0], T) + tuple(shape[1:])
    x = rng.randn(*dshape).astype(np.float32)
    arg_shapes, _, _ = out.infer_shape(data=dshape)
    if args_np is None:
        args_np = {n: rng.uniform(-0.3, 0.3, s).astype(np.float32)
                   for n, s in zip(out.list_arguments(), arg_shapes)
                   if n != 'data'}
    args = {n: pkg.nd.array(v, ctx=pkg.cpu()) for n, v in args_np.items()}
    args['data'] = pkg.nd.array(x, ctx=pkg.cpu())
    ex = out.bind(pkg.cpu(), args)
    return [o.asnumpy() for o in ex.forward()], args_np, out


CELLS = {
    'rnn': lambda p: p.rnn.RNNCell(H, prefix='rnn_'),
    'rnn-relu': lambda p: p.rnn.RNNCell(H, activation='relu', prefix='rr_'),
    'lstm': lambda p: p.rnn.LSTMCell(H, prefix='lstm_', forget_bias=0.0),
    'gru': lambda p: p.rnn.GRUCell(H, prefix='gru_'),
    'sequential': lambda p: _stack(p, [p.rnn.LSTMCell(H, prefix='l0_'),
                                       p.rnn.LSTMCell(H, prefix='l1_')]),
    'bidirectional': lambda p: p.rnn.BidirectionalCell(
        p.rnn.LSTMCell(H, prefix='l_'), p.rnn.LSTMCell(H, prefix='r_')),
    'residual': lambda p: p.rnn.ResidualCell(p.rnn.RNNCell(D, prefix='res_')),
    'zoneout': lambda p: p.rnn.ZoneoutCell(p.rnn.RNNCell(H, prefix='z_'),
                                           zoneout_outputs=0.0,
                                           zoneout_states=0.0),
    'dropout': lambda p: _stack(p, [p.rnn.RNNCell(H, prefix='d0_'),
                                    p.rnn.DropoutCell(0.5)]),
    'fused-lstm': lambda p: p.rnn.FusedRNNCell(H, num_layers=2, mode='lstm',
                                               prefix='f_'),
    'fused-gru-bi': lambda p: p.rnn.FusedRNNCell(H, num_layers=2, mode='gru',
                                                 bidirectional=True,
                                                 prefix='g_'),
}


def _stack(pkg, cells):
    stack = pkg.rnn.SequentialRNNCell()
    for c in cells:
        stack.add(c)
    return stack


@pytest.mark.parametrize('merge', [True, False])
@pytest.mark.parametrize('name', sorted(CELLS))
def test_cell_unroll_matches_jax(name, merge):
    want, args, jsym = _unroll(mx, CELLS[name](mx), merge=merge)
    got, _, tsym = _unroll(mt, CELLS[name](mt), args, merge=merge)
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_outputs() == jsym.list_outputs()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('kind', ['ConvRNNCell', 'ConvLSTMCell',
                                  'ConvGRUCell'])
def test_conv_cells_match_jax(kind):
    shape = (2, 3, 5, 5)

    def make(p):
        return getattr(p.rnn, kind)(input_shape=shape, num_hidden=4,
                                    prefix='c_')
    want, args, _ = _unroll(mx, make(mx), shape=shape)
    got, _, _ = _unroll(mt, make(mt), args, shape=shape)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('mode,bidir', [('lstm', False), ('gru', True),
                                        ('rnn_tanh', True),
                                        ('rnn_relu', False)])
def test_fused_cell_matches_unfused(mode, bidir):
    """The port's FusedRNNCell against its unfuse() cells in both packages,
    on one set of weights given by the unfused cells' names (packed into
    ``parameters`` by unfuse().unpack_weights and pack_weights)."""
    fused = mt.rnn.FusedRNNCell(H, num_layers=2, mode=mode,
                                bidirectional=bidir, prefix='f_')
    want, unfused_np, _ = _unroll(mx, _jax_unfused(mode, bidir))
    packed = _pack(fused, unfused_np)
    assert sorted(packed) == ['f_parameters']
    got, _, _ = _unroll(mt, fused, {k: v.asnumpy()
                                    for k, v in packed.items()})
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    got_u, _, _ = _unroll(mt, fused.unfuse(), unfused_np)
    np.testing.assert_allclose(got_u[0], want[0], rtol=1e-5, atol=1e-6)


def _pack(fused, unfused_np):
    """The fused cell's ``parameters`` from its unfuse() cells' weights."""
    return fused.pack_weights(fused.unfuse().unpack_weights(
        {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in unfused_np.items()}))


def _jax_unfused(mode, bidir):
    """The JAX package's unfuse() of the same fused cell."""
    return mx.rnn.FusedRNNCell(H, num_layers=2, mode=mode,
                               bidirectional=bidir, prefix='f_').unfuse()


def test_pack_unpack_roundtrips():
    rng = np.random.RandomState(3)
    for pkg in (mx, mt):
        cell = pkg.rnn.LSTMCell(H, prefix='p_')
        args = {'p_i2h_weight': rng.randn(4 * H, D), 'p_i2h_bias':
                rng.randn(4 * H), 'p_h2h_weight': rng.randn(4 * H, H),
                'p_h2h_bias': rng.randn(4 * H)}
        args = {k: pkg.nd.array(v.astype(np.float32), ctx=pkg.cpu())
                for k, v in args.items()}
        unpacked = cell.unpack_weights(args)
        assert unpacked['p_i2h_i_weight'].shape == (H, D)
        packed = cell.pack_weights(unpacked)
        for k in args:
            np.testing.assert_array_equal(packed[k].asnumpy(),
                                          args[k].asnumpy())
    jnames = sorted(mx.rnn.LSTMCell(H, prefix='p_').unpack_weights(
        {k: mx.nd.zeros((4 * H, 4)) for k in
         ('p_i2h_weight', 'p_i2h_bias', 'p_h2h_weight', 'p_h2h_bias')}))
    assert sorted(unpacked) == jnames
    fused = mt.rnn.FusedRNNCell(H, num_layers=2, mode='lstm',
                                bidirectional=True, prefix='f_')
    size = mt.ops.rnn_ops.rnn_param_size(2, H, D, True, 'lstm')
    flat = mt.nd.array(rng.randn(size).astype(np.float32), ctx=mt.cpu())
    per_gate = fused.unpack_weights({'f_parameters': flat})
    assert len(per_gate) == 2 * 2 * 2 * 4 * 2      # L, dirs, W/b, gates, i/h
    assert per_gate['f_r1_i2h_f_weight'].shape == (H, 2 * H)
    np.testing.assert_array_equal(
        fused.pack_weights(per_gate)['f_parameters'].asnumpy(),
        flat.asnumpy())


def test_begin_state_and_state_info_match_jax():
    for make in (lambda p: p.rnn.LSTMCell(H, prefix='s_'),
                 lambda p: p.rnn.FusedRNNCell(H, num_layers=3, mode='gru',
                                              bidirectional=True)):
        jc, tc = make(mx), make(mt)
        assert tc.state_info == jc.state_info
        assert [s.name for s in tc.begin_state()] == \
            [s.name for s in jc.begin_state()]


SENTENCES = [list(np.random.RandomState(i).randint(1, 20, size=n))
             for i, n in enumerate([3, 2, 6, 4, 7, 5, 2, 8, 3, 6, 4, 4, 9])]


@pytest.mark.parametrize('layout', ['NT', 'TN'])
def test_bucket_sentence_iter_matches_jax(layout):
    batches = {}
    for name, pkg in (('jax', mx), ('port', mt)):
        pkg.random.seed(7)
        it = pkg.rnn.BucketSentenceIter(SENTENCES, 2, buckets=[4, 8],
                                        invalid_label=0, layout=layout)
        batches[name] = [[(b.bucket_key, b.data[0].asnumpy(),
                           b.label[0].asnumpy()) for b in it]
                         for _ in range(2) if it.reset() is None]
        assert it.provide_data[0].shape == \
            ((2, 8) if layout == 'NT' else (8, 2))
    assert len(batches['port'][0]) == len(batches['jax'][0]) > 0
    for pe, je in zip(batches['port'], batches['jax']):
        for (pk, pd, pl), (jk, jd, jl) in zip(pe, je):
            assert pk == jk
            np.testing.assert_array_equal(pd, jd)
            np.testing.assert_array_equal(pl, jl)


def test_encode_sentences_matches_jax():
    sents = [['a', 'b', 'c'], ['b', 'd'], ['e', 'a']]
    assert mt.rnn.encode_sentences(sents, invalid_label=0, start_label=0) \
        == mx.rnn.encode_sentences(sents, invalid_label=0, start_label=0)


def test_rnn_checkpoint_roundtrip_across_packages(tmp_path):
    """A port rnn checkpoint of a fused cell is saved unpacked (per gate),
    loads packed again in the port, and unpacked in the JAX package."""
    cell = mt.rnn.FusedRNNCell(H, num_layers=1, mode='lstm', prefix='ck_')
    outputs, _ = cell.unroll(T, inputs=mt.sym.Variable('data'),
                             layout='TNC', merge_outputs=True)
    size = mt.ops.rnn_ops.rnn_param_size(1, H, D, False, 'lstm')
    flat = np.random.RandomState(5).randn(size).astype(np.float32)
    args = {'ck_parameters': mt.nd.array(flat, ctx=mt.cpu())}
    prefix = str(tmp_path / 'rnnmodel')
    mt.rnn.save_rnn_checkpoint(cell, prefix, 3, outputs, args, {})
    sym2, args2, _ = mt.rnn.load_rnn_checkpoint(cell, prefix, 3)
    np.testing.assert_array_equal(args2['ck_parameters'].asnumpy(), flat)
    assert sym2.list_outputs() == outputs.list_outputs()
    _, jargs, _ = mx.model.load_checkpoint(prefix, 3)
    assert sorted(jargs) == sorted(cell.unpack_weights(args))
    # a JAX LSTMCell checkpoint loads into the port's cell unchanged
    jcell = mx.rnn.LSTMCell(H, prefix='ck_')
    jout, _ = jcell.unroll(T, inputs=mx.sym.Variable('data'), layout='TNC',
                           merge_outputs=True)
    rng = np.random.RandomState(6)
    jp = {'ck_i2h_weight': rng.randn(4 * H, D), 'ck_i2h_bias':
          rng.randn(4 * H), 'ck_h2h_weight': rng.randn(4 * H, H),
          'ck_h2h_bias': rng.randn(4 * H)}
    jp = {k: mx.nd.array(v.astype(np.float32)) for k, v in jp.items()}
    mx.rnn.save_rnn_checkpoint(jcell, prefix + '-jax', 1, jout, jp, {})
    _, targs, _ = mt.rnn.load_rnn_checkpoint(
        mt.rnn.LSTMCell(H, prefix='ck_'), prefix + '-jax', 1)
    for k in jp:
        np.testing.assert_array_equal(targs[k].asnumpy(), jp[k].asnumpy())


# -- BucketingModule: lstm_bucketing's model, cut small ---------------------
V, E, HID, BATCH, BUCKETS = 20, 8, 8, 4, [4, 8]
LM_SENTENCES = [list(np.random.RandomState(0).randint(1, V, size=n))
                for n in np.random.RandomState(1).randint(2, 9, size=40)]
LR = 0.5


def _sym_gen(pkg, fused=False):
    if fused:
        stack = pkg.rnn.FusedRNNCell(HID, num_layers=2, mode='lstm',
                                     prefix='lstm_')
    else:
        stack = pkg.rnn.SequentialRNNCell()
        for i in range(2):
            stack.add(pkg.rnn.LSTMCell(num_hidden=HID,
                                       prefix='lstm_l%d_' % i))

    def sym_gen(seq_len):
        data = pkg.sym.Variable('data')
        label = pkg.sym.Variable('softmax_label')
        embed = pkg.sym.Embedding(data=data, input_dim=V, output_dim=E,
                                  name='embed')
        stack.reset()
        outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = pkg.sym.Reshape(outputs, shape=(-1, HID))
        pred = pkg.sym.FullyConnected(data=pred, num_hidden=V, name='pred')
        label = pkg.sym.Reshape(label, shape=(-1,))
        pred = pkg.sym.SoftmaxOutput(data=pred, label=label, name='softmax')
        return pred, ('data',), ('softmax_label',)
    return sym_gen


def _lm_iter(pkg):
    pkg.random.seed(3)
    return pkg.rnn.BucketSentenceIter(LM_SENTENCES, BATCH, buckets=BUCKETS,
                                      invalid_label=0)


@pytest.fixture(scope='module')
def lm():
    """The initial weights (the JAX package's Xavier), the JAX package's
    fit, and its batch-by-batch drive with the default bucket synced."""
    mx.random.seed(5)
    jm = mx.mod.BucketingModule(_sym_gen(mx), default_bucket_key=8)
    jm.bind([('data', (BATCH, 8))], [('softmax_label', (BATCH, 8))])
    jm.init_params(mx.init.Xavier(factor_type='in', magnitude=2.34))
    init = {k: v.asnumpy() for k, v in jm.get_params()[0].items()}

    jfit = mx.mod.BucketingModule(_sym_gen(mx), default_bucket_key=8)
    jfit.fit(_lm_iter(mx), num_epoch=1, optimizer='sgd',
             optimizer_params={'learning_rate': LR},
             arg_params={k: mx.nd.array(v) for k, v in init.items()},
             eval_metric=mx.metric.Perplexity(None))

    it = _lm_iter(mx)
    js = mx.mod.BucketingModule(_sym_gen(mx), default_bucket_key=8)
    js.bind(it.provide_data, it.provide_label)
    js.init_params(arg_params={k: mx.nd.array(v) for k, v in init.items()})
    js.init_optimizer(optimizer='sgd',
                      optimizer_params={'learning_rate': LR})
    keys = []
    for batch in it:
        js.forward_backward(batch)
        js.update()
        keys.append(batch.bucket_key)
        master = js._buckets[8]
        if master._params_dirty:
            master._sync_params_from_devices()

    def _np(mod):
        return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    return dict(init=init, jax_fit=_np(jfit), jax_synced=_np(js), keys=keys)


def _close_params(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_bucketing_fit_matches_jax_without_a_window(lm, monkeypatch):
    from mxnet_tpu_torch.module import fused_fit
    built = []
    real_build = fused_fit.FusedFitLoop.build

    def spy(module, *a, **k):
        loop = real_build(module, *a, **k)
        built.append((type(module).__name__, loop))
        return loop
    monkeypatch.setattr(fused_fit.FusedFitLoop, 'build', staticmethod(spy))
    keys = []
    mod = mt.mod.BucketingModule(_sym_gen(mt), default_bucket_key=8,
                                 context=mt.cpu())
    mod.fit(_lm_iter(mt), num_epoch=1, optimizer='sgd',
            optimizer_params={'learning_rate': LR},
            arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                        for k, v in lm['init'].items()},
            eval_metric=mt.metric.Perplexity(None),
            batch_end_callback=lambda p: keys.append(mod._curr_bucket_key))
    assert built == [('BucketingModule', None)]
    assert all('_fused_fit_cache' not in m.__dict__
               for m in mod._buckets.values())
    assert keys == lm['keys'] and set(keys) == set(BUCKETS)
    got = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    _close_params(got, lm['jax_synced'])


def test_jax_bucketing_fit_loses_the_default_buckets_updates(lm):
    """The JAX package's fit differs from the synced drive (ROADMAP.md §3):
    its default bucket's updates are overwritten at the next batch."""
    diff = max(np.abs(lm['jax_fit'][k] - lm['jax_synced'][k]).max()
               for k in lm['init'])
    assert diff > 1e-2


def test_feedforward_over_a_sym_gen(lm):
    gen = _sym_gen(mt)
    # FeedForward's sym_gen returns the symbol alone (reference model.py)
    ff = mt.model.FeedForward(lambda key: gen(key)[0], ctx=mt.cpu(),
                              num_epoch=1,
                              optimizer='sgd', learning_rate=LR,
                              arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                                          for k, v in lm['init'].items()},
                              aux_params={})
    ff.fit(_lm_iter(mt), eval_metric=mt.metric.Perplexity(None))
    assert isinstance(ff._module, mt.mod.BucketingModule)
    assert ff.symbol.list_arguments() == \
        _sym_gen(mx)(8)[0].list_arguments()
    _close_params({k: v.asnumpy() for k, v in ff.arg_params.items()},
                  lm['jax_synced'])


def test_fused_language_model_matches_unrolled(lm):
    """(r2)'s model on the CPU: the FusedRNNCell sym_gen through
    BucketingModule forwards as the unrolled LSTMCells on the same
    weights (packed by unfuse().unpack_weights and pack_weights)."""
    it = _lm_iter(mt)
    batch = next(iter(it))
    outs = []
    for fused in (False, True):
        mod = mt.mod.BucketingModule(_sym_gen(mt, fused), default_bucket_key=8,
                                     context=mt.cpu())
        mod.bind(it.provide_data, it.provide_label, for_training=False)
        mod.init_params()
        weights = dict(lm['init'])
        if fused:
            cell = mt.rnn.FusedRNNCell(HID, num_layers=2, mode='lstm',
                                       prefix='lstm_')
            lstm = {k: weights.pop(k) for k in list(weights)
                    if k.startswith('lstm_')}
            packed = _pack(cell, lstm)
            weights.update({k: v.asnumpy() for k, v in packed.items()})
        mod.set_params({k: mt.nd.array(v, ctx=mt.cpu())
                        for k, v in weights.items()}, {})
        mod.forward(batch, is_train=False)
        outs.append(mod.get_outputs()[0].asnumpy())
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-6)
