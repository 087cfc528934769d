"""The port's LibSVMIter (mxnet_tpu_torch.io) and the sparse linear
classifier of ``examples/sparse/linear_classification.py`` against the
JAX package's, on the CPU.

- The iterator on an Avazu-shaped file (10-30 nonzeros a row, the
  generator of ``tests/compat/test_reference_scripts.py``, at 2,000
  features): every CSR batch (data, indptr, indices), label and ``pad``,
  with and without ``round_batch``, ``label_libsvm`` labels, the names and
  shapes it provides, ``getpad()`` (0: the pad rides on each batch) and
  the too-few-rows error.
- The example's recipe for a few batches: ``nd.sparse.dot`` of the CSR
  batch, the logistic loss, the transposed sparse dot giving a row_sparse
  gradient, the dense update. The losses and weights of both packages.
- The reference script's Module form: a csr ``data`` Variable,
  ``sym.sparse.dot`` with a row_sparse ``weight``, a local kvstore with
  ``row_sparse_pull(row_ids=batch.data[0].indices)`` before each batch,
  ``forward_backward`` and ``update``; the outputs and parameters of both
  packages after each batch.

Tolerances: exact for indices, labels and pads; f32 values rtol 1e-5
(atol 1e-6).
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

NFEAT = 2000


def write_avazu_style(path, rows, nfeat=NFEAT, seed=3):
    rng = np.random.RandomState(seed)
    with open(path, 'w') as f:
        for _ in range(rows):
            nnz = rng.randint(10, 30)
            idx = np.sort(rng.choice(nfeat, size=nnz, replace=False))
            sig = (idx < nfeat // 2).sum() - nnz / 2.0
            label = 1 if sig + rng.randn() * 2 > 0 else 0
            f.write('%d %s\n' % (label, ' '.join(
                '%d:%.4f' % (j, rng.rand()) for j in idx)))


@pytest.fixture(scope='module')
def svm(tmp_path_factory):
    d = tmp_path_factory.mktemp('libsvm')
    path = str(d / 'train.libsvm')
    write_avazu_style(path, 70)
    lab = str(d / 'labels.libsvm')
    rng = np.random.RandomState(4)
    with open(lab, 'w') as f:
        for _ in range(70):
            f.write('%s\n' % ' '.join('%d:%.2f' % (j, rng.rand()) for j in
                                      sorted(rng.choice(3, 2, replace=False))))
    return path, lab


def _batches(p, it):
    out = []
    for b in it:
        d = b.data[0]
        out.append((d.stype, tuple(d.shape), d.data.asnumpy(),
                    d.indptr.asnumpy(), d.indices.asnumpy(),
                    b.label[0].asnumpy(), b.pad))
    return out


def _both_iters(**kw):
    j = mx.io.LibSVMIter(**kw)
    with mt.cpu():
        t = mt.io.LibSVMIter(**kw)
        tb = _batches(mt, t)
    return t, j, tb, _batches(mx, j)


@pytest.mark.parametrize('round_batch', [True, False])
@pytest.mark.parametrize('with_labels', [False, True])
def test_batches_match_jax(svm, round_batch, with_labels):
    kw = dict(data_libsvm=svm[0], data_shape=(NFEAT,), batch_size=16,
              round_batch=round_batch)
    if with_labels:
        kw.update(label_libsvm=svm[1], label_shape=(3,))
    t, j, tb, jb = _both_iters(**kw)
    assert len(tb) == len(jb) == (5 if round_batch else 4)
    for bt, bj in zip(tb, jb):
        assert bt[:2] == bj[:2] == ('csr', (16, NFEAT))
        for x, y in zip(bt[2:6], bj[2:6]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        assert bt[6] == bj[6]
    if round_batch:
        assert tb[-1][6] == 10          # 70 rows: the last batch wraps by 10
    assert [(d.name, d.shape) for d in t.provide_data] == \
        [(d.name, d.shape) for d in j.provide_data]
    assert [(d.name, d.shape) for d in t.provide_label] == \
        [(d.name, d.shape) for d in j.provide_label]
    # the pad rides on each batch; getpad() gives 0
    assert t.getpad() == j.getpad() == 0
    # a second epoch after reset gives the same batches
    t.reset()
    with mt.cpu():
        again = _batches(mt, t)
    np.testing.assert_array_equal(again[0][2], tb[0][2])


def test_names_and_errors(svm):
    with mt.cpu():
        it = mt.io.LibSVMIter(data_libsvm=svm[0], data_shape=NFEAT,
                              batch_size=8, data_name='x', label_name='y')
        assert it.provide_data[0].name == 'x'
        assert it.provide_label[0].name == 'y'
        assert mt.io.LibSVMIter(data_libsvm=svm[0], data_shape=(NFEAT,),
                                batch_size=8).provide_label[0].name == \
            'softmax_label'
        with pytest.raises(ValueError, match='fewer rows'):
            mt.io.LibSVMIter(data_libsvm=svm[0], data_shape=(NFEAT,),
                             batch_size=100)


def _linear_steps(p, path, steps=4, lr=1.0):
    """The example's loop: (losses, w, b) after ``steps`` batches."""
    it = p.io.LibSVMIter(data_libsvm=path, data_shape=(NFEAT,),
                         batch_size=16)
    w = p.nd.zeros((NFEAT, 1))
    b = p.nd.zeros((1,))
    losses = []
    for _, batch in zip(range(steps), it):
        data, lab = batch.data[0], batch.label[0]
        n = data.shape[0]
        z = p.nd.sparse.dot(data, w).reshape((-1,)) + b
        prob = 1.0 / (1.0 + (-z).exp())
        err = prob - lab
        gw = (1.0 / n) * p.nd.sparse.dot(data, err.reshape((-1, 1)),
                                         transpose_a=True)
        assert gw.stype == 'row_sparse'
        w = w - (lr * gw).tostype('default')
        b -= lr * err.mean()
        eps = 1e-7
        losses.append(float((-(lab * (prob + eps).log() + (1 - lab) *
                               (1 - prob + eps).log())).mean().asscalar()))
    return losses, w.asnumpy(), b.asnumpy()


def test_linear_classification_recipe(svm):
    want = _linear_steps(mx, svm[0])
    with mt.cpu():
        got = _linear_steps(mt, svm[0])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for g, w_ in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w_, rtol=1e-5, atol=1e-6)


def _module_steps(p, ctx, path, steps=3):
    data = p.sym.Variable('data', stype='csr')
    weight = p.sym.Variable('weight', shape=(NFEAT, 1), stype='row_sparse')
    bias = p.sym.Variable('bias', shape=(1,))
    pred = p.sym.broadcast_add(p.sym.sparse.dot(data, weight), bias)
    label = p.sym.Variable('softmax_label')
    net = p.sym.LinearRegressionOutput(data=pred.reshape((-1,)), label=label,
                                       name='out')
    it = p.io.LibSVMIter(data_libsvm=path, data_shape=(NFEAT,),
                         batch_size=16)
    mod = p.mod.Module(net, data_names=['data'], label_names=['softmax_label'],
                       context=ctx)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    rng = np.random.RandomState(5)
    mod.init_params(arg_params={
        'weight': p.nd.array(0.01 * rng.randn(NFEAT, 1).astype(np.float32)),
        'bias': p.nd.zeros((1,))})
    kv = p.kv.create('local')
    mod.init_optimizer(kvstore=kv, optimizer='sgd',
                       optimizer_params={'learning_rate': 0.1,
                                         'rescale_grad': 1.0 / 16})
    outs = []
    widx = mod._exec_group.param_names.index('weight')
    for _, batch in zip(range(steps), it):
        kv.row_sparse_pull('weight', mod._exec_group.param_arrays[widx],
                           row_ids=batch.data[0].indices)
        mod.forward_backward(batch)
        mod.update()
        outs.append(mod.get_outputs()[0].asnumpy())
    args, _ = mod.get_params()
    return outs, {k: v.asnumpy() for k, v in args.items()}


def test_module_form_with_row_sparse_pull(svm):
    want = _module_steps(mx, mx.cpu(), svm[0])
    with mt.cpu():
        got = _module_steps(mt, mt.cpu(), svm[0])
    for g, w_ in zip(got[0], want[0]):
        np.testing.assert_allclose(g, w_, rtol=1e-5, atol=1e-6)
    for k in want[1]:
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=1e-5,
                                   atol=1e-6)
