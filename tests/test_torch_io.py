"""The port's data iterators (``mxnet_tpu_torch.io``) against the JAX
package's (``mxnet_tpu.io``): the same arrays through NDArrayIter give the
same batches, pads, labels and descriptors in each ``last_batch_handle``
mode over two epochs, and a seeded shuffle (both packages' host streams
seeded alike) the same order. ResizeIter and PrefetchingIter wrap them
alike. Batches are compared exactly: both iterators index the same numpy
arrays.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

N, B = 23, 5


def _arrays(seed=0):
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((N, 3, 4)).astype(np.float32)
    y = rng.randint(0, 7, N).astype(np.int32)
    return X, y


def _drain(it, epochs=2):
    """Every batch of ``epochs`` epochs: (data, label, pad) as numpy."""
    out = []
    for _ in range(epochs):
        for batch in it:
            out.append(([d.asnumpy() for d in batch.data],
                        [l.asnumpy() for l in batch.label], batch.pad))
        it.reset()
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        for a, b in zip(gd + gl, wd + wl):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('handle', ['pad', 'discard', 'roll_over'])
def test_ndarrayiter_batches_match_jax(handle):
    X, y = _arrays()
    its = [pkg.io.NDArrayIter(X, y, batch_size=B, last_batch_handle=handle)
           for pkg in (mx, mt)]
    want, got = (_drain(it) for it in its)
    _assert_same(got, want)
    assert [tuple(d) for d in its[1].provide_data] == \
        [tuple(d) for d in its[0].provide_data]
    assert [tuple(d) for d in its[1].provide_label] == \
        [tuple(d) for d in its[0].provide_label]
    assert np.dtype(its[1].provide_label[0].dtype) == \
        np.dtype(its[0].provide_label[0].dtype)


def test_seeded_shuffle_matches_jax():
    X, y = _arrays(1)
    its = []
    for pkg in (mx, mt):
        pkg.random.seed(42)
        its.append(pkg.io.NDArrayIter({'a': X, 'b': X[:, 0]}, {'lab': y},
                                      batch_size=B, shuffle=True))
    _assert_same(_drain(its[1], 3), _drain(its[0], 3))
    assert [d.name for d in its[1].provide_data] == ['a', 'b']


def test_iterator_keeps_its_arrays_on_the_host():
    X, y = _arrays()
    batch = next(iter(mt.io.NDArrayIter(X, y, batch_size=B)))
    assert all(a.context == mt.cpu() for a in batch.data + batch.label)


def test_resize_and_prefetching_iters_match_jax():
    X, y = _arrays(2)
    outs = []
    for pkg in (mx, mt):
        base = pkg.io.NDArrayIter(X, y, batch_size=B)
        outs.append(_drain(pkg.io.ResizeIter(base, 7)))
        pre = pkg.io.PrefetchingIter(
            pkg.io.NDArrayIter(X, y, batch_size=B),
            rename_data=[{'data': 'x'}], rename_label=[{'softmax_label': 'l'}])
        outs.append(_drain(pre) + [([np.array(pre.provide_data[0].shape)],
                                    [], pre.provide_label[0].name)])
    _assert_same(outs[2], outs[0])
    _assert_same(outs[3], outs[1])


def test_datadesc_and_auto_shard(monkeypatch):
    d = mt.io.DataDesc('data', (4, 3), layout='TNC')
    assert mt.io.DataDesc.get_batch_axis(d.layout) == 1
    assert mt.io.DataDesc.get_batch_axis(None) == 0
    monkeypatch.setenv('MXTPU_NUM_HOSTS', '4')
    monkeypatch.setenv('MXTPU_HOST_ID', '6')
    assert mt.io.auto_shard() == {'num_parts': 4, 'part_index': 2}
