"""The port's Gluon data API (``mxnet_tpu_torch.gluon.data``: datasets,
samplers, the DataLoader, the vision datasets), ``gluon.utils`` and the
MNIST, CSV, LibSVM and handle iterators of ``mxnet_tpu_torch.io`` against
the JAX package's, on small arrays made with numpy from a seed.

- The random sampler shuffles with the host stream: after
  ``random.seed(s)`` in both packages the orders, and so the DataLoader's
  batches, are the JAX package's; the batches are CPU NDArrays.
- The vision datasets read local files only and otherwise make the JAX
  package's synthetic sets, array for array.
- ``download`` copies a file:// url, checks sha1 and leaves no partial
  file; with the host offline (``urlopen`` failing) it raises OSError as
  the JAX package's does. No test reaches the network.
"""
import gzip
import hashlib
import os
import struct
import urllib.request

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import gluon as jgluon
from mxnet_tpu_torch import gluon as tgluon

PKGS = ((mx, jgluon), (mt, tgluon))


def _np(x):
    """An NDArray, numpy value or scalar as numpy."""
    return x.asnumpy() if hasattr(x, 'asnumpy') else np.asarray(x)


def _eq(got, want):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            _eq(g, w)
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (g, w)
    np.testing.assert_array_equal(g, w)


def _arr(pkg, a):
    """``a`` as an NDArray on the package's host context (the port's
    default context is the card)."""
    return pkg.nd.array(a, ctx=pkg.cpu())


def _data(n=10, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((n, 3, 2)).astype(np.float32),
            rng.randint(0, 5, n).astype(np.int32))


def test_array_dataset_matches_jax():
    X, y = _data()
    for as_nd in (False, True):
        items = []
        for pkg, gl in PKGS:
            args = (_arr(pkg, X), _arr(pkg, y)) if as_nd else (X, y)
            ds = gl.data.ArrayDataset(*args)
            items.append([len(ds)] + [ds[i] for i in (0, 3, 9)])
        _eq(items[1], items[0])
    single = tgluon.data.ArrayDataset(X)
    _eq(single[4], X[4])
    with pytest.raises(AssertionError):
        tgluon.data.ArrayDataset(X, y[:3])


def test_transforms_match_jax():
    out = []
    for _, gl in PKGS:
        ds = gl.data.SimpleDataset(list(range(6)))
        pairs = gl.data.SimpleDataset([(i, 10 * i) for i in range(4)])
        out.append(([ds.transform(lambda x: 2 * x)[i] for i in range(6)],
                    list(ds.transform(lambda x: x + 1, lazy=False)._data),
                    [ds.transform_first(lambda x: x + 100)[i]
                     for i in range(6)],
                    [pairs.transform_first(lambda x: -x)[i]
                     for i in range(4)],
                    [pairs.transform(lambda a, b: a + b)[i]
                     for i in range(4)]))
    assert out[1] == out[0]


@pytest.mark.parametrize('last_batch', ['keep', 'discard', 'rollover'])
def test_samplers_match_jax(last_batch):
    out = []
    for pkg, gl in PKGS:
        pkg.random.seed(9)
        s = gl.data.RandomSampler(11)
        b = gl.data.BatchSampler(s, 4, last_batch)
        passes = [list(b), list(b)]
        out.append((passes, [len(b)], list(gl.data.SequentialSampler(5)),
                    len(s)))
    assert out[1] == out[0]
    if last_batch == 'keep':     # a pass covers every index once
        assert sorted(sum(out[1][0][0], [])) == list(range(11))


def test_batch_sampler_rejects_an_unknown_last_batch():
    b = tgluon.data.BatchSampler(tgluon.data.SequentialSampler(5), 2, 'x')
    with pytest.raises(ValueError):
        list(b)
    with pytest.raises(ValueError):
        len(b)


@pytest.mark.parametrize('kw', [dict(batch_size=4),
                                dict(batch_size=4, shuffle=True),
                                dict(batch_size=3, shuffle=True,
                                     last_batch='discard'),
                                dict(batch_size=4, last_batch='rollover')],
                         ids=['sequential', 'shuffle', 'discard', 'rollover'])
@pytest.mark.parametrize('kind', ['numpy', 'ndarray'])
def test_dataloader_matches_jax(kw, kind):
    X, y = _data(10)
    out = []
    for pkg, gl in PKGS:
        pkg.random.seed(4)
        if kind == 'numpy':
            ds = gl.data.ArrayDataset(X, y)
        else:
            ds = gl.data.SimpleDataset([_arr(pkg, x) for x in X])
        loader = gl.data.DataLoader(ds, **kw)
        batches = [b for _ in range(2) for b in loader]
        out.append((batches, len(loader)))
        if pkg is mt:
            for b in batches:
                for a in (b if isinstance(b, list) else [b]):
                    assert a.context == mt.cpu()
    _eq(out[1][0], out[0][0])
    assert out[1][1] == out[0][1]


def test_dataloader_rejects_conflicting_arguments():
    ds = tgluon.data.SimpleDataset(list(range(4)))
    sampler = tgluon.data.SequentialSampler(4)
    with pytest.raises(ValueError):
        tgluon.data.DataLoader(ds)
    with pytest.raises(ValueError):
        tgluon.data.DataLoader(ds, batch_size=2, shuffle=True,
                               sampler=sampler)
    with pytest.raises(ValueError):
        tgluon.data.DataLoader(ds, batch_size=2, batch_sampler=[[0, 1]])
    loader = tgluon.data.DataLoader(ds, batch_sampler=[[3, 0], [1]],
                                    batchify_fn=list)
    assert list(loader) == [[3, 0], [1]]


def test_record_file_dataset_matches_jax(tmp_path):
    rec, idx = str(tmp_path / 'd.rec'), str(tmp_path / 'd.idx')
    w = mt.recordio.MXIndexedRecordIO(idx, rec, 'w')
    payloads = [b'alpha', b'', b'gamma' * 9]
    for i, p in enumerate(payloads):
        w.write_idx(i, p)
    w.close()
    got = tgluon.data.RecordFileDataset(rec)
    want = jgluon.data.RecordFileDataset(rec)
    assert len(got) == len(want) == 3
    assert [got[i] for i in (2, 0, 1)] == [want[i] for i in (2, 0, 1)]


def _vision_items(ds):
    return [len(ds)] + [ds[i] for i in (0, 7, len(ds) - 1)]


@pytest.mark.parametrize('name', ['MNIST', 'FashionMNIST', 'CIFAR10'])
def test_synthetic_vision_sets_match_jax(tmp_path, name):
    out = [_vision_items(getattr(gl.data.vision, name)(
        root=str(tmp_path / 'none'), train=False)) for _, gl in PKGS]
    _eq(out[1], out[0])
    assert out[1][1][0].context == mt.cpu()
    assert str(out[1][1][0].dtype) == 'uint8'


def _mnist_files(root, n=12):
    rng = np.random.RandomState(1)
    imgs = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labs = rng.randint(0, 10, n).astype(np.uint8)
    os.makedirs(root, exist_ok=True)
    for name, head, body in (
            ('t10k-images-idx3-ubyte.gz', struct.pack('>IIII', 2051, n, 28, 28),
             imgs.tobytes()),
            ('t10k-labels-idx1-ubyte.gz', struct.pack('>II', 2049, n),
             labs.tobytes())):
        with gzip.open(os.path.join(root, name), 'wb') as f:
            f.write(head + body)
    return imgs, labs


def test_vision_sets_read_local_files_like_jax(tmp_path):
    root = str(tmp_path / 'mnist')
    imgs, labs = _mnist_files(root)
    out = [_vision_items(gl.data.vision.MNIST(root=root, train=False))
           for _, gl in PKGS]
    _eq(out[1], out[0])
    np.testing.assert_array_equal(out[1][1][0].asnumpy()[:, :, 0], imgs[0])
    assert out[1][1][1] == labs[0]
    croot = tmp_path / 'cifar'
    croot.mkdir()
    rng = np.random.RandomState(2)
    rows = rng.randint(0, 256, (9, 3073)).astype(np.uint8)
    rows[:, 0] %= 10
    (croot / 'test_batch.bin').write_bytes(rows.tobytes())
    out = [_vision_items(gl.data.vision.CIFAR10(root=str(croot), train=False))
           for _, gl in PKGS]
    _eq(out[1], out[0])
    # with transform: (data, label) -> the transform's pair
    ds = tgluon.data.vision.MNIST(root=root, train=False,
                                  transform=lambda d, l: (d.shape, l + 1))
    assert ds[0] == ((28, 28, 1), labs[0] + 1)


def test_image_folder_and_record_datasets_match_jax(tmp_path):
    pytest.importorskip('PIL')
    from PIL import Image
    rng = np.random.RandomState(3)
    root = tmp_path / 'folder'
    rec = mt.recordio.MXIndexedRecordIO(str(tmp_path / 'i.idx'),
                                        str(tmp_path / 'i.rec'), 'w')
    k = 0
    for cls in ('cat', 'dog'):
        (root / cls).mkdir(parents=True)
        for j in range(2):
            arr = rng.randint(0, 255, (6, 5, 3)).astype(np.uint8)
            Image.fromarray(arr).save(str(root / cls / ('%d.png' % j)))
            rec.write_idx(k, mt.recordio.pack_img(
                mt.recordio.IRHeader(0, float(k), k, 0), arr, img_fmt='.png'))
            k += 1
    (root / 'notes.txt').write_text('not a class')
    (root / 'cat' / 'x.txt').write_text('not an image')
    rec.close()
    out = []
    for _, gl in PKGS:
        folder = gl.data.vision.ImageFolderDataset(str(root))
        records = gl.data.vision.ImageRecordDataset(str(tmp_path / 'i.rec'))
        out.append((folder.synsets, [folder[i] for i in range(len(folder))],
                    [records[i] for i in range(len(records))]))
    assert out[1][0] == out[0][0] == ['cat', 'dog']
    _eq(out[1][1], out[0][1])
    _eq(out[1][2], out[0][2])


@pytest.mark.parametrize('axis,even', [(0, True), (0, False), (1, True),
                                       (1, False)])
def test_split_data_and_split_and_load_match_jax(axis, even):
    X = np.arange(72, dtype=np.float32).reshape(6, 12)
    n = 3 if even else 4
    out = []
    for pkg, gl in PKGS:
        parts = gl.utils.split_data(_arr(pkg, X), n, batch_axis=axis,
                                    even_split=even)
        ctx = [pkg.cpu(0)] * n
        loaded = gl.utils.split_and_load(X, ctx, batch_axis=axis,
                                         even_split=even)
        out.append((parts, loaded))
    _eq(out[1], out[0])
    one = tgluon.utils.split_and_load(mt.nd.array(X, ctx=mt.cpu()),
                                      [mt.cpu()])
    assert len(one) == 1 and one[0].context == mt.cpu()
    with pytest.raises(ValueError):
        tgluon.utils.split_data(mt.nd.array(X, ctx=mt.cpu()), 7)
    with pytest.raises(ValueError):
        tgluon.utils.split_data(mt.nd.array(X, ctx=mt.cpu()), 4)


@pytest.mark.parametrize('max_norm', [1.0, 1e3])
def test_clip_global_norm_matches_jax(max_norm):
    rng = np.random.RandomState(5)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((3, 4), (5,), (2, 2, 2))]
    out = []
    for pkg, gl in PKGS:
        nds = [_arr(pkg, a) for a in arrays]
        norm = gl.utils.clip_global_norm(nds, max_norm)
        out.append((norm, [a.asnumpy() for a in nds]))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-6)
    for g, w in zip(out[1][1], out[0][1]):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


def test_download_file_url_sha1_and_no_partial_file(tmp_path):
    src = tmp_path / 'payload.bin'
    src.write_bytes(b'mxnet-tpu-data')
    sha = hashlib.sha1(b'mxnet-tpu-data').hexdigest()
    dl, check = tgluon.utils.download, tgluon.utils.check_sha1
    dst = dl('file://%s' % src, path=str(tmp_path / 'out.bin'), sha1_hash=sha)
    assert check(dst, sha) and not check(dst, '0' * 40)
    assert dl('file://%s' % src, path=dst, sha1_hash=sha) == dst
    deep = tmp_path / 'sub' / 'dir' / 'dst.bin'
    with pytest.raises(OSError, match='sha1 mismatch'):
        dl('file://%s' % src, path=str(deep), sha1_hash='0' * 40)
    assert not deep.exists() and not (deep.parent / 'dst.bin.part').exists()
    assert open(dl('file://%s' % src, path=str(deep)), 'rb').read() == \
        b'mxnet-tpu-data'
    # into a directory: the url's file name
    (tmp_path / 'into').mkdir()
    got = dl('file://%s' % src, path=str(tmp_path / 'into'))
    assert got == str(tmp_path / 'into' / 'payload.bin')


def test_download_offline_raises_as_jax(tmp_path, monkeypatch):
    def offline(*args, **kwargs):
        raise OSError('network is unreachable')
    monkeypatch.setattr(urllib.request, 'urlopen', offline)
    url = 'http://127.0.0.1:9/missing.bin'
    msgs = []
    for _, gl in PKGS:
        with pytest.raises(OSError) as e:
            gl.utils.download(url, path=str(tmp_path / 'x.bin'))
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0] and 'offline environment' in msgs[1]
    assert not (tmp_path / 'x.bin').exists()


def _write_mnist(tmp_path, n=30, gz=False):
    rng = np.random.RandomState(7)
    imgs = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labs = rng.randint(0, 10, n).astype(np.uint8)
    sfx = '.gz' if gz else ''
    img = str(tmp_path / ('train-images-idx3-ubyte' + sfx))
    lab = str(tmp_path / ('train-labels-idx1-ubyte' + sfx))
    opener = gzip.open if gz else open
    with opener(img, 'wb') as f:
        f.write(struct.pack('>IIII', 2051, n, 28, 28) + imgs.tobytes())
    with opener(lab, 'wb') as f:
        f.write(struct.pack('>II', 2049, n) + labs.tobytes())
    return img, lab


@pytest.mark.parametrize('kw', [
    dict(files=True, batch_size=7, flat=True),
    dict(files=True, gz=True, batch_size=5, shuffle=False),
    dict(files=True, batch_size=4, num_parts=3, part_index=2, seed=3),
    dict(files=False, batch_size=100, flat=True, seed=2)],
    ids=['flat', 'gz', 'shard', 'synthetic'])
def test_mnist_iter_matches_jax(tmp_path, kw):
    kw = dict(kw)
    if kw.pop('files'):
        img, lab = _write_mnist(tmp_path, gz=kw.pop('gz', False))
    else:
        img = str(tmp_path / 'missing' / 't10k-images-idx3-ubyte')
        lab = str(tmp_path / 'missing' / 't10k-labels-idx1-ubyte')
    out = []
    for pkg, _ in PKGS:
        it = pkg.io.MNISTIter(image=img, label=lab, **kw)
        got = [[_np(b.data[0]), _np(b.label[0])] for _ in range(2)
               for b in it]
        it.reset()
        if kw.get('num_parts'):
            it.set_shard(0)
            got += [[_np(b.data[0])] for b in it]
            got.append(list(it.shard_info()))
        out.append(got)
    _eq(out[1], out[0])
    np.testing.assert_array_equal(
        mt.io.synthetic_mnist(50, seed=4)[0],
        mx.io.synthetic_mnist(50, seed=4)[0])


@pytest.mark.parametrize('round_batch', [True, False])
def test_csv_iter_matches_jax(tmp_path, round_batch):
    rng = np.random.RandomState(8)
    X = rng.standard_normal((11, 6)).astype(np.float32)
    y = rng.randint(0, 3, (11, 2)).astype(np.float32)
    xp, yp = str(tmp_path / 'x.csv'), str(tmp_path / 'y.csv')
    np.savetxt(xp, X, delimiter=',')
    np.savetxt(yp, y, delimiter=',')
    out = []
    for pkg, _ in PKGS:
        runs = []
        for label in ({}, dict(label_csv=yp, label_shape=(2,))):
            it = pkg.io.CSVIter(data_csv=xp, data_shape=(2, 3), batch_size=4,
                                round_batch=round_batch, **label)
            runs.append([[_np(b.data[0]), _np(b.label[0]), b.pad]
                         for b in it])
        out.append(runs)
    _eq(out[1], out[0])


def test_libsvm_iter_waits_for_sparse_storage(tmp_path):
    # sparse storage has come: the iterator yields the JAX package's CSR
    # batches (tests/test_torch_libsvm.py holds it at width)
    p = tmp_path / 'a.libsvm'
    p.write_text('1 0:1.5 3:2\n0 2:1\n')
    out = []
    for pkg, _ in PKGS:
        with pkg.cpu():
            b = next(iter(pkg.io.LibSVMIter(str(p), (4,), batch_size=2)))
            out.append([b.data[0].stype, b.data[0].asnumpy(),
                        _np(b.label[0]), b.pad])
    assert out[1][0] == 'csr'
    _eq(out[1], out[0])


def test_mx_data_iter_matches_jax():
    X, y = _data(9)
    out = []
    for pkg, _ in PKGS:
        it = pkg.io.MXDataIter(pkg.io.NDArrayIter(X, y, batch_size=4))
        got = [tuple(it.provide_data[0])[:2], tuple(it.provide_label[0])[:2]]
        while it.iter_next():
            got.append([_np(it.getdata()), _np(it.getlabel()), it.getpad()])
        it.reset()
        it.debug_skip_load()
        got.append([_np(it.next().data[0])])
        out.append(got)
    _eq(out[1], out[0])
    with pytest.raises(TypeError):
        mt.io.MXDataIter(object())
