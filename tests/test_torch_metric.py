"""The port's metrics (``mxnet_tpu_torch.metric``) against the JAX
package's: each metric, made by ``create`` from the same spec and updated
with the same labels and predictions (two updates, from a numpy seed),
gives the same ``get()``, names and values, to 1e-6 relative. Both compute
in numpy on the host from the arrays' values, so only the float sums'
order can differ.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

RTOL = 1e-6


def _inputs(kind, seed):
    rng = np.random.RandomState(seed)
    n, k = 12, 5
    if kind == 'class':
        p = rng.rand(n, k).astype(np.float32)
        p /= p.sum(1, keepdims=True)
        return rng.randint(0, k, n).astype(np.float32), p
    if kind == 'binary':
        p = rng.rand(n, 2).astype(np.float32)
        return rng.randint(0, 2, n).astype(np.float32), p / p.sum(1, keepdims=True)
    if kind == 'regress':
        return (rng.standard_normal(n).astype(np.float32),
                rng.standard_normal((n, 1)).astype(np.float32))
    if kind == 'loss':
        return (np.zeros(n, np.float32),
                rng.rand(n).astype(np.float32))
    raise ValueError(kind)


def _feval(label, pred):
    return float(np.abs(label.ravel() - pred.argmax(1)).sum()), len(label)


# (spec given to create, create's kwargs, inputs)
CASES = {
    'acc': ('acc', {}, 'class'),
    'accuracy_axis': ('accuracy', {'axis': 1}, 'class'),
    'top_k_acc': ('top_k_acc', {'top_k': 3}, 'class'),
    'f1': ('f1', {}, 'binary'),
    'perplexity': ('perplexity', {'ignore_label': None}, 'class'),
    'perplexity_ignore': ('perplexity', {'ignore_label': 2}, 'class'),
    'mae': ('mae', {}, 'regress'),
    'mse': ('mse', {}, 'regress'),
    'rmse': ('rmse', {}, 'regress'),
    'ce': ('ce', {}, 'class'),
    'nll_loss': ('nll_loss', {}, 'class'),
    'pearsonr': ('pearsonr', {}, 'regress'),
    'loss': ('loss', {}, 'loss'),
    'torch': ('torch', {}, 'loss'),
    'caffe': ('caffe', {}, 'loss'),
    'custom': (_feval, {}, 'class'),
    'composite': (['acc', 'ce', 'mae'], {}, 'class'),
}


def _run(pkg, case):
    spec, kwargs, kind = CASES[case]
    if case == 'composite':
        metric = pkg.metric.create(spec)
    else:
        metric = pkg.metric.create(spec, **kwargs)
    for seed in (0, 1):
        label, pred = _inputs(kind, seed)
        if kind == 'regress' and case == 'pearsonr':
            pred = pred.ravel()
        metric.update([pkg.nd.array(label, ctx=pkg.cpu())],
                      [pkg.nd.array(pred, ctx=pkg.cpu())])
    return metric


@pytest.mark.parametrize('case', sorted(CASES))
def test_metric_matches_jax(case):
    want = _run(mx, case).get_name_value()
    got = _run(mt, case).get_name_value()
    assert [n for n, _ in got] == [n for n, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=RTOL)


def test_np_adapter_reset_and_config():
    def diff(label, pred):
        return float(np.abs(label - pred.ravel()).mean())
    ms = [pkg.metric.np(diff) for pkg in (mx, mt)]
    label, pred = _inputs('regress', 3)
    for pkg, m in zip((mx, mt), ms):
        m.update([pkg.nd.array(label, ctx=pkg.cpu())],
                 [pkg.nd.array(pred, ctx=pkg.cpu())])
    assert ms[1].get() == pytest.approx(ms[0].get(), rel=RTOL)
    ms[1].reset()
    assert ms[1].num_inst == 0 and np.isnan(ms[1].get()[1])
    cfg = mt.metric.Accuracy(axis=1).get_config()
    assert cfg == mx.metric.Accuracy(axis=1).get_config()
    with pytest.raises(ValueError):
        mt.metric.Accuracy().update([mt.nd.zeros((2,), ctx=mt.cpu())], [])
