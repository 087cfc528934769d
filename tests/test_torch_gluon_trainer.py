"""The port's Gluon losses and Trainer (``mxnet_tpu_torch.gluon.loss``,
``gluon.Trainer``) against the JAX package's.

Every loss on the same outputs, labels and sample weights (from a numpy
seed), imperative and hybridized, equal to 1e-6 relative (the same f32
ops; log_softmax and the mean in another order). Then a Dense net trained
by ``autograd.record()``, a loss, ``backward`` and ``Trainer.step`` for
three steps from the same parameters in both packages: the loss at each
step and the parameters after each to 1e-5 (absolute and relative), with
sgd (momentum, wd) and adam; then ``set_learning_rate``, the stale
gradient check, ``save_states``/``load_states`` and the contexts check.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

RTOL = 1e-6
TOL = 1e-5
B, K = 6, 4

LOSSES = {
    'l2': ('L2Loss', {}, 'regress'),
    'l2_weighted': ('L2Loss', {'weight': 0.5}, 'regress'),
    'l1': ('L1Loss', {}, 'regress'),
    'sigmoid_bce': ('SigmoidBinaryCrossEntropyLoss', {}, 'binary'),
    'sigmoid_bce_from_sigmoid': ('SigmoidBCELoss', {'from_sigmoid': True},
                                 'prob'),
    'softmax_ce': ('SoftmaxCrossEntropyLoss', {}, 'sparse'),
    'softmax_ce_dense': ('SoftmaxCELoss', {'sparse_label': False}, 'dense'),
    'softmax_ce_from_logits': ('SoftmaxCrossEntropyLoss',
                               {'from_logits': True}, 'sparse_logp'),
    'kl_div': ('KLDivLoss', {}, 'dense_logp'),
    'kl_div_logits': ('KLDivLoss', {'from_logits': False}, 'dense'),
}


def _loss_inputs(kind, seed=0):
    rng = np.random.RandomState(seed)
    out = rng.standard_normal((B, K)).astype(np.float32)
    if kind == 'regress':
        return out, rng.standard_normal((B, K)).astype(np.float32)
    if kind == 'binary':
        return out, rng.randint(0, 2, (B, K)).astype(np.float32)
    if kind == 'prob':
        return 1 / (1 + np.exp(-out)), rng.randint(0, 2, (B, K)).astype(
            np.float32)
    if kind in ('sparse', 'sparse_logp'):
        if kind == 'sparse_logp':
            out = out - np.log(np.exp(out).sum(1, keepdims=True))
        return out, rng.randint(0, K, B).astype(np.float32)
    p = rng.rand(B, K).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    if kind == 'dense_logp':
        out = out - np.log(np.exp(out).sum(1, keepdims=True))
    return out, p


def _loss(pkg, case, hybridize):
    name, kwargs, kind = LOSSES[case]
    out, label = _loss_inputs(kind)
    weight = np.random.RandomState(1).rand(B, 1).astype(np.float32)
    fn = getattr(pkg.gluon.loss, name)(**kwargs)
    if hybridize:
        fn.hybridize()
    arr = lambda a: pkg.nd.array(a, ctx=pkg.cpu())     # noqa: E731
    return [fn(arr(out), arr(label)).asnumpy(),
            fn(arr(out), arr(label), arr(weight)).asnumpy()]


@pytest.mark.parametrize('hybridize', [False, True],
                         ids=['imperative', 'hybridized'])
@pytest.mark.parametrize('case', sorted(LOSSES))
def test_loss_matches_jax(case, hybridize):
    want = _loss(mx, case, hybridize)
    got = _loss(mt, case, hybridize)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (B,)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL)


def test_ctc_loss_raises():
    """CTCLoss is ported (tests/test_torch_ctc.py holds its values): it
    raises, as the JAX package's does, only on a layout it does not take."""
    for pkg in (mx, mt):
        with pytest.raises(AssertionError):
            pkg.gluon.loss.CTCLoss(layout='NCT')
        with pytest.raises(AssertionError):
            pkg.gluon.loss.CTCLoss(label_layout='NTC')
    assert mt.gluon.loss.CTCLoss()._batch_axis == 0


def _net(pkg):
    with pkg.name.NameManager():
        net = pkg.gluon.nn.HybridSequential(prefix='net_')
        with net.name_scope():
            net.add(pkg.gluon.nn.Dense(8, in_units=5, activation='relu'))
            net.add(pkg.gluon.nn.Dense(K, in_units=8))
    net.initialize(ctx=pkg.cpu())
    rng = np.random.RandomState(2)
    for p in net.collect_params().values():
        p.set_data(pkg.nd.array(
            rng.standard_normal(p.shape).astype(np.float32) * 0.5,
            ctx=pkg.cpu()))
    return net


def _train(pkg, optimizer, params, steps=3, hybridize=False):
    net = _net(pkg)
    if hybridize:
        net.hybridize()
    trainer = pkg.gluon.Trainer(net.collect_params(), optimizer, dict(params))
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    rng = np.random.RandomState(3)
    out = []
    for _ in range(steps):
        x = pkg.nd.array(rng.standard_normal((B, 5)).astype(np.float32),
                         ctx=pkg.cpu())
        y = pkg.nd.array(rng.randint(0, K, B).astype(np.float32),
                         ctx=pkg.cpu())
        with pkg.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(B)
        out.append((loss.asnumpy(), {n: p.data().asnumpy() for n, p in
                                     net.collect_params().items()}))
    return out, trainer, net


@pytest.mark.parametrize('optimizer,params', [
    ('sgd', {'learning_rate': 0.1, 'momentum': 0.9, 'wd': 1e-4}),
    ('adam', {'learning_rate': 0.01}),
], ids=['sgd', 'adam'])
@pytest.mark.parametrize('hybridize', [False, True],
                         ids=['imperative', 'hybridized'])
def test_trainer_steps_match_jax(optimizer, params, hybridize):
    want = _train(mx, optimizer, params, hybridize=hybridize)[0]
    got, trainer, _ = _train(mt, optimizer, params, hybridize=hybridize)
    for (gl, gp), (wl, wp) in zip(got, want):
        np.testing.assert_allclose(gl, wl, rtol=TOL, atol=TOL)
        assert sorted(gp) == sorted(wp)
        for n in wp:
            np.testing.assert_allclose(gp[n], wp[n], rtol=TOL, atol=TOL,
                                       err_msg=n)
    # one context and a 'device' kvstore: no store, per-context updaters
    assert trainer._kvstore is None and len(trainer._updaters) == 1


def test_trainer_learning_rate_states_and_checks(tmp_path):
    _, trainer, net = _train(mt, 'sgd', {'learning_rate': 0.1,
                                         'momentum': 0.9}, steps=1)
    trainer.set_learning_rate(0.05)
    assert trainer.learning_rate == 0.05
    fname = str(tmp_path / 'trainer.states')
    trainer.save_states(fname)
    before = {k: v.asnumpy() for k, v in trainer._updaters[0].states.items()}
    trainer._updaters[0].states = {}
    trainer.load_states(fname)
    assert trainer.learning_rate == 0.05
    for k, v in trainer._updaters[0].states.items():
        np.testing.assert_array_equal(v.asnumpy(), before[k])
    # no backward since the last step: the gradients are stale
    with pytest.raises(UserWarning, match='stale|updated by backward'):
        trainer.step(B)
    trainer.step(B, ignore_stale_grad=True)
    with pytest.raises(AssertionError):
        mt.gluon.Trainer(net.collect_params(), mt.optimizer.SGD(),
                         {'learning_rate': 0.1})
    other = mt.gluon.nn.Dense(2, in_units=2)
    other.initialize(ctx=mt.cpu(1))
    params = list(net.collect_params().values()) + \
        list(other.collect_params().values())
    with pytest.raises(AssertionError, match='same set of contexts'):
        mt.gluon.Trainer(params, 'sgd')
