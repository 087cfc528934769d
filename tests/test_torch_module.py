"""The port's Module (``mxnet_tpu_torch.mod``) against the JAX package's.

Each net is trained from the same parameters (the JAX package's Xavier
draw, carried across by ``set_params`` from numpy) over the same
NDArrayIter batches, for 2 epochs of 3 batches with sgd (lr 0.1,
momentum 0.9, wd 1e-4), under SoftmaxOutput: an MLP with BatchNorm (batch
4), and the narrow bottleneck ResNet of ``tests/test_torch_resnet_step.py``
(bench's ResNet with one bottleneck a stage, widths 8-64; batch 16 of
3 x 32 x 32). With 3 batches an epoch, fewer than the fused window's W = 4
(``module/fused_fit.py``, the default in both packages), both packages'
``Module.fit`` build their window loop and run every batch through its
per-batch tail; ``tests/test_torch_fused_fit.py`` holds the windows. The
port's ``Module.fit`` on the CPU is held:

- against the JAX package's ``Module.fit`` as it runs on the CPU: the
  batch-end callback's ``(epoch, nbatch)`` sequence equal; the MLP's
  parameters and aux states (1e-5, absolute and relative) and its metric
  at every batch end (1e-5 relative) along the whole trajectory; the
  ResNet's metric at the first batch end (1e-5) and all its parameters and
  aux states together after 6 steps to a relative RMS error of 1e-4. The
  ResNet's trajectory cannot be held tighter: its BatchNorms normalise
  over 16 values at 1 x 1, and 6 steps at lr 0.1 carry the f32 rounding of
  another summation order (oneDNN's convolutions against XLA's) from
  1e-7 after step 1 to 1.1e-5 relative RMS after step 6 (1.2e-5 with one
  thread), a few parameters to 6e-5 absolute;
- against the JAX package's own per-batch calls (``forward_backward``,
  ``update``, ``update_metric``) from the port's state before each batch
  (its parameters, aux states and momentum states): each step's
  parameters and aux states to 1e-5 (absolute and relative), and the
  metric at each batch end to 1e-5 relative, for both nets.

Then ``score``, ``predict`` and ``iter_predict`` on a padded iterator, the
optimizer states' save and load, the kvstore update path, two contexts,
checkpoints in both directions, phase (l2)'s head of ``chip_smoke.py`` at
narrow widths (with and without ``MXTPU_FORCE_PALLAS``, which puts the JAX
side on its Pallas kernels in interpret mode and the port on the kernels'
plain versions), and the unported branches' errors.
"""
import pickle

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

TOL = 1e-5
RESNET_FIT_REL_RMS = 1e-4
EPOCHS, BATCHES = 2, 3
NETS = {'mlp_bn': (4, 10), 'narrow_resnet': (16, 3, 32, 32)}
OPT = {'learning_rate': 0.1, 'momentum': 0.9, 'wd': 1e-4}
# the flags of the unported paths, each with a value that turns its path on
UNPORTED = {'MXTPU_CKPT_DIR': 'x', 'MXTPU_FAULT_INJECT': 'x',
            'MXTPU_HEALTH': '1', 'MXTPU_DYNAMICS': '1',
            'MXTPU_SHARDED_UPDATE': '1', 'MXTPU_GRAD_COMPRESS': 'int8'}
WINDOW_FLAGS = ('MXTPU_FUSED_FIT', 'MXTPU_FUSED_EVAL',
                'MXTPU_FIT_STEPS_PER_CALL', 'MXTPU_EVAL_STEPS_PER_CALL')


@pytest.fixture(autouse=True)
def _clean_flags(monkeypatch):
    """Both packages' fit and eval run as they do by default; the port's
    flags for its unported paths are unset."""
    for name in list(UNPORTED) + list(WINDOW_FLAGS):
        monkeypatch.delenv(name, raising=False)
    mt.config.flags.reload()
    yield
    mt.config.flags.reload()


def _symbol(pkg, net):
    S = pkg.sym
    if net == 'mlp_bn':
        h = S.FullyConnected(S.var('data'), num_hidden=16, name='fc1')
        h = S.Activation(S.BatchNorm(h, name='bn1'), act_type='relu')
        out = S.FullyConnected(h, num_hidden=5, name='fc2')
    else:
        from_ = pkg.gluon.model_zoo.vision.resnet
        with pkg.name.NameManager():
            block = from_.ResNetV1(from_.BottleneckV1, [1, 1, 1, 1],
                                   [8, 8, 16, 32, 64], classes=5)
        block.hybridize()
        _, out = block._get_graph(type('P', (), {'shape': NETS[net],
                                                 'context': None})())
    return S.SoftmaxOutput(out, name='softmax')


def _data(net, n=None, seed=0):
    batch = NETS[net][0]
    n = n or batch * BATCHES
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n,) + NETS[net][1:]).astype(np.float32)
    y = rng.randint(0, 5, n).astype(np.float32)
    return X, y


def _iter(pkg, net, n=None, seed=0):
    X, y = _data(net, n, seed)
    return pkg.io.NDArrayIter(X, y, batch_size=NETS[net][0])


def _init_values(net):
    """The JAX package's Xavier draw of the net's parameters."""
    it = _iter(mx, net)
    mod = mx.mod.Module(_symbol(mx, net), context=mx.cpu())
    mod.bind(it.provide_data, it.provide_label)
    mx.random.seed(7)
    mod.init_params(mx.init.Xavier(magnitude=2))
    return _params_split(mod)


def _params_split(mod):
    args, aux = mod.get_params()
    return ({k: v.asnumpy() for k, v in args.items()},
            {k: v.asnumpy() for k, v in aux.items()})


def _params(mod):
    args, aux = _params_split(mod)
    return {**args, **aux}


def _module(pkg, net, values):
    it = _iter(pkg, net)
    mod = pkg.mod.Module(_symbol(pkg, net), context=pkg.cpu())
    mod.bind(it.provide_data, it.provide_label)
    _set(pkg, mod, values)
    return mod, it


def _set(pkg, mod, values):
    args, aux = values
    mod.set_params({k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in args.items()},
                   {k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in aux.items()})


def _fit(pkg, net, values, kvstore='local'):
    """fit, with the batch-end callback's (epoch, nbatch), the metric, and
    (the port) the state after each batch."""
    mod, it = _module(pkg, net, values)
    seen, states = [], []
    metric = pkg.metric.create(['acc', 'ce'])

    def cb(param):
        seen.append((param.epoch, param.nbatch,
                     tuple(param.eval_metric.get()[1])))
        if pkg is mt and mod._updater is not None:
            states.append((_params_split(mod), {
                k: v.asnumpy() for k, v in mod._updater.states.items()}))
    mod.fit(it, num_epoch=EPOCHS, optimizer='sgd', optimizer_params=OPT,
            eval_metric=metric, kvstore=kvstore, batch_end_callback=cb)
    return mod, seen, metric.get_name_value(), states


def _per_batch(net, values, port_states):
    """The JAX package's per-batch calls over the same batches, each from
    the port's state before it: ``(params after each step, metric at each
    batch end)``."""
    mod, it = _module(mx, net, values)
    mod.init_optimizer(optimizer='sgd', optimizer_params=OPT)
    metric = mx.metric.create(['acc', 'ce'])
    before = (values, {})
    after, seen = [], []
    for epoch in range(EPOCHS):
        metric.reset()
        for batch in it:
            _set(mx, mod, before[0])
            for k, v in before[1].items():
                mod._updater.states[k] = mx.nd.array(v, ctx=mx.cpu())
            mod.forward_backward(batch)
            mod.update()
            mod.update_metric(metric, batch.label)
            after.append(_params(mod))
            seen.append(tuple(metric.get()[1]))
            before = port_states[len(after) - 1]
        it.reset()
    return mod, after, seen


@pytest.fixture(scope='module', params=sorted(NETS))
def fits(request):
    net = request.param
    values = _init_values(net)
    port = _fit(mt, net, values)
    return net, values, {'jax_fit': _fit(mx, net, values),
                         'jax_per_batch': _per_batch(net, values, port[3]),
                         'port': port}


def _assert_params_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL,
                                   err_msg=k)


def _rel_rms(got, want):
    keys = sorted(want)
    a = np.concatenate([got[k].ravel() for k in keys])
    b = np.concatenate([want[k].ravel() for k in keys])
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


def test_fit_matches_jax_fit(fits):
    net, _, runs = fits
    jmod, jseen, jmetric, _ = runs['jax_fit']
    tmod, tseen, tmetric, _ = runs['port']
    # both packages built their fit window here, and ran every batch
    # through its per-batch tail (3 batches an epoch, W = 4)
    assert '_fused_fit_cache' in jmod.__dict__
    loop = tmod.__dict__['_fused_fit_cache'][1]
    assert (loop.windows, loop.tail_batches) == (0, EPOCHS * BATCHES)
    assert [s[:2] for s in tseen] == [s[:2] for s in jseen] == \
        [(e, b) for e in range(EPOCHS) for b in range(BATCHES)]
    assert [n for n, _ in tmetric] == [n for n, _ in jmetric]
    if net == 'mlp_bn':
        _assert_params_close(_params(tmod), _params(jmod))
        np.testing.assert_allclose([s[2] for s in tseen],
                                   [s[2] for s in jseen], rtol=TOL)
        np.testing.assert_allclose([v for _, v in tmetric],
                                   [v for _, v in jmetric], rtol=TOL)
    else:
        np.testing.assert_allclose(tseen[0][2], jseen[0][2], rtol=TOL)
        assert _rel_rms(_params(tmod), _params(jmod)) <= RESNET_FIT_REL_RMS


def test_each_step_matches_jax_per_batch_calls(fits):
    net, _, runs = fits
    _, after, jseen = runs['jax_per_batch']
    _, tseen, _, states = runs['port']
    assert len(after) == len(states) == EPOCHS * BATCHES
    for want, (got, _) in zip(after, states):
        _assert_params_close({**got[0], **got[1]}, want)
    np.testing.assert_allclose([s[2] for s in tseen], jseen, rtol=TOL)


def test_score_predict_and_iter_predict_match_jax(fits):
    net, _, runs = fits
    jmod, tmod = runs['jax_per_batch'][0], runs['port'][0]
    _set(mx, jmod, _params_split(tmod))
    batch = NETS[net][0]
    n = 2 * batch + batch // 2              # 3 batches, the last one padded
    its = [_iter(pkg, net, n, seed=1) for pkg in (mx, mt)]
    jscore = jmod.score(its[0], ['acc', 'ce'])
    tscore = tmod.score(its[1], ['acc', 'ce'])
    assert [n for n, _ in tscore] == [n for n, _ in jscore]
    np.testing.assert_allclose([v for _, v in tscore],
                               [v for _, v in jscore], rtol=TOL)
    jpred, tpred = jmod.predict(its[0]), tmod.predict(its[1])
    assert tpred.shape == jpred.shape == (n, 5)
    np.testing.assert_allclose(tpred.asnumpy(), jpred.asnumpy(), rtol=TOL,
                               atol=TOL)
    got = [(o[0].asnumpy(), i, b.pad) for o, i, b in tmod.iter_predict(its[1])]
    assert [(i, pad) for _, i, pad in got] == \
        [(0, 0), (1, 0), (2, batch - batch // 2)]
    np.testing.assert_allclose(np.concatenate([o for o, _, _ in got]),
                               tpred.asnumpy(), rtol=0, atol=0)


def test_optimizer_states_save_and_load(fits, tmp_path):
    """The momentum states pickle in the JAX package's form, match the JAX
    per-batch module's, and a module that loads them trains on as the one
    that saved them."""
    net, values, runs = fits
    tmod = runs['port'][0]
    fname = str(tmp_path / 'opt.states')
    tmod.save_optimizer_states(fname)
    states = pickle.load(open(fname, 'rb'))
    jstates = runs['jax_per_batch'][0]._updater.states
    assert sorted(states) == sorted(jstates)
    for k in jstates:
        np.testing.assert_allclose(states[k].asnumpy(),
                                   jstates[k].asnumpy(), rtol=TOL, atol=TOL)
    batch = next(iter(_iter(mt, net, seed=2)))
    out = []
    for load in (False, True):
        mod, _ = _module(mt, net, _params_split(tmod))
        mod.init_optimizer(optimizer='sgd', optimizer_params=OPT)
        mod.load_optimizer_states(fname)
        if not load:
            mod._updater.states = pickle.loads(pickle.dumps(
                tmod._updater.states))
        mod.forward_backward(batch)
        mod.update()
        out.append(_params(mod))
    _assert_params_close(out[1], out[0])


def test_update_on_a_kvstore_matches_jax():
    """A KVStore object makes the updates run on the store (push the
    gradients, pull the weights), in both packages."""
    values = _init_values('mlp_bn')
    jmod, jseen, _, _ = _fit(mx, 'mlp_bn', values,
                             kvstore=mx.kv.create('local'))
    tmod, tseen, _, _ = _fit(mt, 'mlp_bn', values,
                             kvstore=mt.kv.create('local'))
    assert tmod._update_on_kvstore and jmod._update_on_kvstore
    _assert_params_close(_params(tmod), _params(jmod))
    np.testing.assert_allclose([s[2] for s in tseen], [s[2] for s in jseen],
                               rtol=TOL)


def test_two_contexts_split_the_batch():
    """Two CPU contexts: each executor takes half the batch, the gradients
    are summed on the 'device' store; without BatchNorm the fit equals one
    context's."""
    S = mt.sym
    sym = S.SoftmaxOutput(S.FullyConnected(S.var('data'), num_hidden=5,
                                           name='fc'), name='softmax')
    X, y = _data('mlp_bn')
    rng = np.random.RandomState(3)
    w = {'fc_weight': mt.nd.array(rng.standard_normal((5, 10)).astype(
        np.float32), ctx=mt.cpu()), 'fc_bias': mt.nd.zeros((5,), ctx=mt.cpu())}
    out = []
    for ctxs in ([mt.cpu(0)], [mt.cpu(0), mt.cpu(1)]):
        mod = mt.mod.Module(sym, context=ctxs)
        mod.fit(mt.io.NDArrayIter(X, y, batch_size=NETS['mlp_bn'][0]),
                num_epoch=1,
                arg_params=w, optimizer_params=OPT, kvstore='device')
        out.append(_params(mod))
        assert len(mod._exec_group.execs) == len(ctxs)
    assert mod._update_on_kvstore
    _assert_params_close(out[1], out[0])


@pytest.mark.parametrize('writer,reader', [(mx, mt), (mt, mx)],
                         ids=['jax-to-port', 'port-to-jax'])
def test_checkpoints_cross_between_the_packages(fits, tmp_path, writer,
                                                reader):
    net, _, runs = fits
    src = runs['jax_per_batch' if writer is mx else 'port'][0]
    prefix = str(tmp_path / 'ck')
    src.save_checkpoint(prefix, 2)
    loaded = reader.mod.Module.load(prefix, 2, context=reader.cpu())
    it = _iter(reader, net, seed=4)
    loaded.bind(it.provide_data, it.provide_label, for_training=False)
    want = src.predict(_iter(writer, net, seed=4))
    np.testing.assert_allclose(loaded.predict(it).asnumpy(), want.asnumpy(),
                               rtol=TOL, atol=TOL)
    _assert_params_close(_params(loaded), _params(src))


def _head(pkg):
    S = pkg.sym
    logits = S.Cast(S.FullyConnected(S.LayerNorm(S.var('x'), name='ln'),
                                     num_hidden=64, no_bias=True,
                                     name='head'), dtype='float32')
    return S.MakeLoss(S.softmax_cross_entropy(logits, S.var('label')))


@pytest.mark.parametrize('kernels', ['plain', 'force_pallas'])
def test_kernel_head_through_fit_matches_jax(monkeypatch, kernels):
    """chip_smoke.py phase (l2)'s head at narrow widths (16 rows of 32,
    64 classes) through fit and score, with eval_metric 'loss'."""
    if kernels == 'force_pallas':
        monkeypatch.setenv('MXTPU_FORCE_PALLAS', '1')
        mt.config.flags.reload('MXTPU_FORCE_PALLAS')
    rng = np.random.RandomState(5)
    X = rng.standard_normal((48, 32)).astype(np.float32)
    y = rng.randint(0, 64, 48).astype(np.int32)
    out = []
    for pkg in (mx, mt):
        it = pkg.io.NDArrayIter({'x': X}, {'label': y}, batch_size=16)
        mod = pkg.mod.Module(_head(pkg), data_names=('x',),
                             label_names=('label',), context=pkg.cpu())
        mod.bind(it.provide_data, it.provide_label)
        if pkg is mx:
            mx.random.seed(9)
            mod.init_params(mx.init.Xavier())
            init = _params_split(mod)
        else:
            mod.init_params(arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                                        for k, v in init[0].items()})
        losses = []
        mod.fit(it, num_epoch=1, optimizer='sgd', optimizer_params=OPT,
                eval_metric='loss', batch_end_callback=lambda p: losses.append(
                    p.eval_metric.get()[1]))
        score = mod.score(it, 'loss')[0][1]
        out.append((losses, score, _params(mod)))
    (jl, js, jp), (tl, ts, tp) = out
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    np.testing.assert_allclose(ts, js, rtol=TOL)
    _assert_params_close(tp, jp)
    monkeypatch.delenv('MXTPU_FORCE_PALLAS', raising=False)
    mt.config.flags.reload('MXTPU_FORCE_PALLAS')


@pytest.mark.parametrize('flag', sorted(UNPORTED))
def test_unported_paths_raise(monkeypatch, flag):
    mod, it = _module(mt, 'mlp_bn', _init_values('mlp_bn'))
    monkeypatch.setenv(flag, UNPORTED[flag])
    with pytest.raises(NotImplementedError, match='ROADMAP.md'):
        mod.fit(it, num_epoch=1)
    with pytest.raises(NotImplementedError, match='ROADMAP.md'):
        mod.score(it, 'acc')


def test_monitor_and_sym_gen_raise():
    """install_monitor hooks a Monitor into a Module's executors, and a
    BucketingModule's (FeedForward's module over a sym_gen, which is
    ported: tests/test_torch_rnn.py); tests/test_torch_monitor.py holds
    their rows to the JAX package's. Nothing raises any more."""
    mod, _ = _module(mt, 'mlp_bn', _init_values('mlp_bn'))
    mod.install_monitor(mt.mon.Monitor(1))
    assert all(e._monitor is not None for e in mod._exec_group.execs)
    sym = mod.symbol
    ff = mt.model.FeedForward(lambda key: sym)
    assert ff.symbol is None and ff._sym_gen is not None
    bm = mt.mod.BucketingModule(lambda key: (sym, ('data',),
                                             ('softmax_label',)),
                                default_bucket_key=4, context=mt.cpu())
    bm.bind([('data', (4, 5))], [('softmax_label', (4,))])
    bm.install_monitor(mt.mon.Monitor(1))
    assert bm._curr_module._exec_group.execs[0]._monitor is not None


def _logged_fit(pkg, tmp_path, caplog):
    """fit with every callback of callback.py, and a validation set."""
    import logging
    values = _init_values('mlp_bn')
    mod, it = _module(pkg, 'mlp_bn', values)
    prefix = str(tmp_path / pkg.__name__)
    caplog.clear()
    with caplog.at_level(logging.INFO):
        mod.fit(it, eval_data=_iter(pkg, 'mlp_bn', seed=1), num_epoch=2,
                optimizer_params=OPT, eval_metric='acc',
                batch_end_callback=[pkg.callback.log_train_metric(1),
                                    pkg.callback.ProgressBar(BATCHES),
                                    pkg.callback.Speedometer(4, 2)],
                epoch_end_callback=[
                    pkg.callback.do_checkpoint(prefix + '-do'),
                    pkg.callback.module_checkpoint(mod, prefix + '-mod', 2,
                                                   True)],
                eval_end_callback=pkg.callback.LogValidationMetricsCallback())
    # the callbacks' and the epoch-end lines (both packages also log their
    # fused windows)
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith(('Iter[', 'Epoch['))
             and 'Speed' not in r.getMessage()
             and 'Time cost' not in r.getMessage()]
    speeds = [r.getMessage().split('\tSpeed')[0] for r in caplog.records
              if 'Speed' in r.getMessage()]
    return lines, speeds, prefix


def test_callbacks_log_and_checkpoint_as_jax(tmp_path, caplog):
    """Every callback of callback.py through fit: the same log lines
    (values to the printed digits), the Speedometer lines at the same
    batches, and do_checkpoint's and module_checkpoint's files."""
    jlines, jspeeds, _ = _logged_fit(mx, tmp_path, caplog)
    tlines, tspeeds, prefix = _logged_fit(mt, tmp_path, caplog)
    assert tlines == jlines and tspeeds == jspeeds and tspeeds
    assert any('Validation-accuracy' in l for l in tlines)
    import os
    for name in ('-do-0001.params', '-do-0002.params', '-do-symbol.json',
                 '-mod-0002.params', '-mod-0002.states'):
        assert os.path.exists(prefix + name), name
    _, args, aux = mt.model.load_checkpoint(prefix + '-do', 2)
    _, margs, maux = mt.model.load_checkpoint(prefix + '-mod', 2)
    for k in args:
        np.testing.assert_array_equal(args[k].asnumpy(), margs[k].asnumpy())


def test_feedforward_matches_jax():
    """The legacy FeedForward over Module: seeded initialisation and
    shuffle, fit and predict."""
    X, y = _data('mlp_bn')
    out = []
    for pkg in (mx, mt):
        pkg.random.seed(11)
        ff = pkg.model.FeedForward(_symbol(pkg, 'mlp_bn'), ctx=pkg.cpu(),
                                   num_epoch=2, numpy_batch_size=4,
                                   learning_rate=0.1, momentum=0.9)
        ff.fit(X, y)
        out.append(ff.predict(X))
    np.testing.assert_allclose(out[1], out[0], rtol=TOL, atol=TOL)
