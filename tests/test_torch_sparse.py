"""Sparse storage in the port (mxnet_tpu_torch.ndarray.sparse,
ops/sparse_ops.py, symbol/sparse.py, the sparse routes of nd, save/load and
the kvstore) against the JAX package's, on the CPU.

Both packages build the same arrays from seeded numpy inputs, and every
container method and op is compared: the constructors (dense, tuples,
scipy, zeros), the casts both ways, row slicing, copies, scalar and mixed
arithmetic, ``retain``, ``dot`` (csr x dense, csr.T x dense giving
row_sparse, a sparse rhs, ``nd.dot``'s routing with dense and sparse
``out=`` buffers and its errors), ``square_sum``, ``add``, the registry
ops (``cast_storage``, ``_sparse_retain`` with its gradient against
``jax.vjp``, ``_square_sum``) and their Symbol forms, sparse arrays in
``nd.save``/``nd.load`` across the packages (the bytes equal), the
kvstore's ``row_sparse_pull`` and sparse ``push``, and the native storage
pool. Index arrays are compared with the dtype the JAX NDArray reports
(int32 with x64 off).

Tolerances: exact for indices, index dtypes, shapes and file bytes; f32
values rtol 1e-5 (atol 1e-6); gradients rtol 1e-4.
"""
import ctypes

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _native
from mxnet_tpu_torch.base import MXNetError, NotSupportedForSparseNDArray
from mxnet_tpu_torch.ops import registry as treg

PKGS = ((mx, mx.cpu()), (mt, mt.cpu()))


def _dense(seed=0, shape=(6, 5), density=0.35):
    rng = np.random.RandomState(seed)
    d = rng.randn(*shape).astype(np.float32)
    d[rng.rand(*shape) > density] = 0
    d[2] = 0                        # an empty row
    return d


def _parts(a):
    """Every array of a container (or a dense NDArray) as numpy."""
    if a.stype == 'csr':
        return [a.data.asnumpy(), a.indptr.asnumpy(), a.indices.asnumpy()]
    if a.stype == 'row_sparse':
        return [a.data.asnumpy(), a.indices.asnumpy()]
    return [a.asnumpy()]


def _same(t, j, rtol=1e-5):
    assert type(t).__name__ == type(j).__name__
    assert t.stype == j.stype and tuple(t.shape) == tuple(j.shape)
    for pt, pj in zip(_parts(t), _parts(j)):
        assert pt.shape == pj.shape and pt.dtype == pj.dtype, (pt.dtype,
                                                               pj.dtype)
        if pj.dtype.kind in 'iu':
            np.testing.assert_array_equal(pt, pj)
        else:
            np.testing.assert_allclose(pt, pj, rtol=rtol, atol=1e-6)
    if t.stype != 'default':
        assert np.dtype(t.dtype) == np.dtype(j.dtype)


def both(fn):
    """fn(package, ctx) in the JAX package and the port: (port, jax)."""
    j = fn(mx, mx.cpu())
    with mt.cpu():
        t = fn(mt, mt.cpu())
    return t, j


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------

CONSTRUCTORS = {
    'csr-dense': lambda p, c: p.nd.sparse.csr_matrix(_dense(), ctx=c),
    'csr-nd': lambda p, c: p.nd.sparse.csr_matrix(p.nd.array(_dense(1),
                                                              ctx=c), ctx=c),
    'csr-tuple': lambda p, c: p.nd.sparse.csr_matrix(
        ([1.5, 2.0, -3.0], [4, 0, 2], [0, 1, 1, 3]), shape=(3, 5), ctx=c),
    'csr-scipy': lambda p, c: p.nd.sparse.array(
        sp.csr_matrix(_dense(2)), ctx=c),
    'csr-zeros': lambda p, c: p.nd.sparse.zeros('csr', (4, 3), ctx=c),
    'rsp-dense': lambda p, c: p.nd.sparse.row_sparse_array(_dense(3), ctx=c),
    'rsp-tuple': lambda p, c: p.nd.sparse.row_sparse_array(
        (np.ones((2, 3)), [1, 4]), shape=(6, 3), ctx=c),
    'rsp-tuple-noshape': lambda p, c: p.nd.sparse.row_sparse_array(
        (np.arange(6.0).reshape(2, 3), [0, 3]), ctx=c),
    'rsp-zeros': lambda p, c: p.nd.sparse.empty('row_sparse', (4, 3), ctx=c),
    'nd-csr_matrix': lambda p, c: p.nd.csr_matrix(_dense(4), ctx=c),
    'nd-row_sparse_array': lambda p, c: p.nd.row_sparse_array(_dense(5),
                                                              ctx=c),
}


@pytest.mark.parametrize('name', sorted(CONSTRUCTORS))
def test_constructors(name):
    t, j = both(CONSTRUCTORS[name])
    _same(t, j)
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    assert t.size == j.size and t.context == mt.cpu()


CASTS = [('default', 'csr'), ('default', 'row_sparse'), ('csr', 'default'),
         ('row_sparse', 'default'), ('csr', 'row_sparse'), ('csr', 'csr'),
         ('row_sparse', 'row_sparse'), ('default', 'default')]


@pytest.mark.parametrize('src,dst', CASTS)
def test_casts(src, dst):
    def fn(p, c):
        a = p.nd.array(_dense(6), ctx=c)
        if src != 'default':
            a = a.tostype(src)
        return [p.nd.cast_storage(a, dst), a.tostype(dst),
                p.nd.sparse.cast_storage(a, dst)]
    for t, j in zip(*both(fn)):
        _same(t, j)


def test_bf16_cast_takes_the_host_dtype():
    # the JAX package casts through asnumpy, which gives f32 for bfloat16
    t, j = both(lambda p, c: p.nd.array(_dense(7), ctx=c,
                                        dtype='bfloat16').tostype('csr'))
    _same(t, j)


def test_csr_slicing_and_copies():
    def fn(p, c):
        a = p.nd.sparse.csr_matrix(_dense(8), ctx=c)
        dst = p.nd.zeros(a.shape, ctx=c)
        a.copyto(dst)
        return [a[1:4], a[3], a[:], a.copy(), a.copyto(c), dst,
                a.tostype('row_sparse').copy()]
    for t, j in zip(*both(fn)):
        _same(t, j)


def test_csr_slicing_refuses_a_step():
    with mt.cpu():
        a = mt.nd.sparse.csr_matrix(_dense())
        with pytest.raises(ValueError):
            a[::2]


def test_arithmetic():
    def fn(p, c):
        r = p.nd.sparse.row_sparse_array(_dense(9), ctx=c)
        r2 = p.nd.sparse.row_sparse_array(_dense(10), ctx=c)
        s = p.nd.sparse.csr_matrix(_dense(11), ctx=c)
        d = p.nd.array(_dense(12) + 1, ctx=c)
        return [r * 2.5, 2.5 * r, r / 4.0, -r, r + r2, r - r2, r + d, d + r,
                d - s, s - d, d * s, s * d, s / d, d / r, 3.0 - s, r + 1.0,
                s + s, s * 2.0]
    for t, j in zip(*both(fn)):
        _same(t, j)


def test_retain():
    def fn(p, c):
        r = p.nd.sparse.row_sparse_array(_dense(13), ctx=c)
        ids = p.nd.array(np.array([4, 0, 4, 2, 9]), ctx=c)
        return [r.retain(ids), p.nd.sparse.retain(r, [1, 3]),
                p.nd.sparse_retain(r, ids),
                p.nd.sparse.sparse_retain(r, np.array([5]))]
    for t, j in zip(*both(fn)):
        _same(t, j)


def test_retain_refuses_a_dense_array():
    with mt.cpu():
        with pytest.raises(TypeError):
            mt.nd.sparse.retain(mt.nd.array(_dense()), [1])


@pytest.mark.parametrize('axis,keepdims', [(None, False), (None, True),
                                           (0, False), (0, True), (1, False),
                                           (1, True), (-1, False)])
def test_square_sum(axis, keepdims):
    t, j = both(lambda p, c: p.nd.sparse.square_sum(
        p.nd.sparse.row_sparse_array(_dense(14), ctx=c), axis=axis,
        keepdims=keepdims))
    _same(t, j)


def test_add_merges_the_indices():
    def fn(p, c):
        a = p.nd.sparse.row_sparse_array(_dense(15), ctx=c)
        b = p.nd.sparse.row_sparse_array((np.ones((3, 5)), [5, 0, 1]),
                                         shape=(6, 5), ctx=c)
        return [p.nd.sparse.add(a, b), p.nd.sparse.add(a, b.tostype(
            'default')), p.nd.sparse.add(b, b)]
    for t, j in zip(*both(fn)):
        _same(t, j)


# ---------------------------------------------------------------------------
# dot
# ---------------------------------------------------------------------------

def _dot_inputs(p, c, seed=16):
    rng = np.random.RandomState(seed)
    s = p.nd.sparse.csr_matrix(_dense(seed, (7, 9)), ctx=c)
    w = p.nd.array(rng.randn(9, 4).astype(np.float32), ctx=c)
    v = p.nd.array(rng.randn(7, 3).astype(np.float32), ctx=c)
    return s, w, v


def test_sparse_dot():
    def fn(p, c):
        s, w, v = _dot_inputs(p, c)
        r = p.nd.sparse.row_sparse_array(w.asnumpy(), ctx=c)
        return [p.nd.sparse.dot(s, w), p.nd.sparse.dot(s, v, transpose_a=True),
                p.nd.sparse.dot(s, r), p.nd.sparse.dot(v.T, v),
                p.nd.sparse.dot(s.tostype('default'), r)]
    for t, j in zip(*both(fn)):
        _same(t, j)
    assert t.stype == 'default'


def test_transposed_dot_gives_the_unique_columns():
    t, j = both(lambda p, c: p.nd.sparse.dot(*_dot_inputs(p, c)[::2],
                                             transpose_a=True))
    _same(t, j)
    assert t.stype == 'row_sparse'
    np.testing.assert_array_equal(
        t.indices.asnumpy(), np.unique(np.nonzero(_dense(16, (7, 9)))[1]))


def test_nd_dot_routes_a_csr_lhs():
    def fn(p, c):
        s, w, v = _dot_inputs(p, c)
        out_d = p.nd.zeros((7, 4), ctx=c)
        out_t = p.nd.zeros((9, 3), ctx=c)
        out_r = p.nd.sparse.zeros('row_sparse', (9, 3), ctx=c)
        res = [p.nd.dot(s, w), p.nd.dot(s, v, transpose_a=True),
               p.nd.dot(s, rhs=w), p.nd.dot(lhs=s.tostype('default'), rhs=w)]
        res.append(p.nd.dot(s, w, out=out_d))
        res.append(p.nd.dot(s, v, True, out=out_t))
        res.append(p.nd.dot(s, v, transpose_a=True, out=out_r))
        # transpose_b has no sparse kernel: the csr is lowered to dense
        res.append(p.nd.dot(s, w.T, transpose_b=True))
        res.append(p.nd.sum(s))
        return res + [out_d, out_t, out_r]
    for t, j in zip(*both(fn)):
        _same(t, j)


def test_nd_dot_out_errors():
    for p, c in PKGS:
        with (mt.cpu() if p is mt else mx.cpu()):
            s, w, v = _dot_inputs(p, c)
            with pytest.raises(ValueError, match='shape'):
                p.nd.dot(s, w, out=p.nd.zeros((3, 4), ctx=c))
            with pytest.raises(ValueError, match='stype'):
                p.nd.dot(s, w, out=p.nd.sparse.zeros('row_sparse', (7, 4),
                                                     ctx=c))
            with pytest.raises(NotImplementedError):
                p.nd.sparse.dot(s, w, transpose_b=True)


def test_sparse_ops_are_not_recorded():
    with mt.cpu():
        s, w, _ = _dot_inputs(mt, mt.cpu())
        w.attach_grad(stype='row_sparse')
        with mt.autograd.record():
            y = mt.nd.sparse.dot(s, w)
        assert not y.handle.requires_grad


# ---------------------------------------------------------------------------
# the registry ops and sym.sparse
# ---------------------------------------------------------------------------

def test_registry_cast_storage_and_square_sum():
    x = _dense(17)
    for name, attrs in (('cast_storage', {'stype': 'csr'}),
                        ('_sparse_cast_storage', {}),
                        ('_square_sum', {}), ('_square_sum', {'axis': 1}),
                        ('_square_sum', {'axis': (0, 1), 'keepdims': True}),
                        ('_square_sum', {'axis': 0, 'keepdims': True})):
        want = np.asarray(jreg.get(name).fn(attrs, jnp.asarray(x)))
        got = treg.get(name).fn(attrs, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        assert treg.get(name).param_defaults == jreg.get(name).param_defaults


@pytest.mark.parametrize('name', ['_sparse_retain', 'sparse_retain'])
def test_registry_sparse_retain_and_its_gradient(name):
    x = np.random.RandomState(18).randn(6, 3).astype(np.float32)
    idx = np.array([4, -1, 1, 9, 4], np.float32)   # -1 wraps, 9 is dropped
    cot = np.random.RandomState(19).randn(6, 3).astype(np.float32)
    f = jreg.get(name).fn
    out, vjp = jax.vjp(lambda a: f({}, a, jnp.asarray(idx)), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    got = treg.get(name).fn({}, tx, torch.from_numpy(idx))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    g, = torch.autograd.grad(got, tx, torch.from_numpy(cot))
    np.testing.assert_allclose(g.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]),
                               rtol=1e-4)
    assert treg.get(name) is treg.get('_sparse_retain')


def test_dense_nd_sparse_retain_uses_the_registry_op():
    t, j = both(lambda p, c: p.nd.sparse_retain(
        p.nd.array(_dense(20), ctx=c), p.nd.array([0, 3], ctx=c)))
    _same(t, j)


def test_symbol_sparse_namespace():
    x = _dense(21)
    outs = []
    for p, c in PKGS:
        data = p.sym.Variable('data', stype='csr')
        ids = p.sym.Variable('ids')
        w = p.sym.Variable('w', stype='row_sparse')
        net = p.sym.Group([
            p.sym.sparse.retain(data, ids),
            p.sym.sparse.square_sum(data, axis=1),
            p.sym.sparse.dot(p.sym.sparse.cast_storage(data, stype='csr'), w),
            p.sym.sparse.zeros_like(data)])
        ex = net.bind(c, {'data': p.nd.array(x, ctx=c),
                          'ids': p.nd.array([1, 4], ctx=c),
                          'w': p.nd.array(np.ones((5, 2)), ctx=c)})
        outs.append([o.asnumpy() for o in ex.forward()])
    for t, j in zip(*outs):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
    assert sorted(mt.sym.sparse.__all__) == sorted(mx.sym.sparse.__all__)


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------

def _sparse_set(p, c):
    return {'csr': p.nd.sparse.csr_matrix(_dense(22, (5, 7)), ctx=c),
            'rsp': p.nd.sparse.row_sparse_array(_dense(23, (6, 2, 3)), ctx=c),
            'dense': p.nd.array(_dense(24), ctx=c),
            'empty': p.nd.sparse.zeros('row_sparse', (3, 4), ctx=c)}


@pytest.mark.parametrize('writer,reader', [(mx, mt), (mt, mx), (mt, mt)],
                         ids=['jax-to-port', 'port-to-jax', 'port-to-port'])
def test_sparse_files_cross_between_the_packages(tmp_path, writer, reader):
    wctx = mt.cpu() if writer is mt else mx.cpu()
    with wctx:
        arrays = _sparse_set(writer, wctx)
    f = str(tmp_path / 'sp.params')
    writer.nd.save(f, arrays, fmt='mxnet')
    got = reader.nd.load(f)
    for k, a in arrays.items():
        assert got[k].stype == a.stype and tuple(got[k].shape) == a.shape
        for pg, pa in zip(_parts(got[k]), _parts(a)):
            np.testing.assert_array_equal(pg, pa)
    # a list, and the npz container (dense in both packages)
    writer.nd.save(f, list(arrays.values()), fmt='mxnet')
    assert [g.stype for g in reader.nd.load(f)] == \
        [a.stype for a in arrays.values()]
    writer.nd.save(f, arrays)
    for k, a in arrays.items():
        np.testing.assert_array_equal(reader.nd.load(f)[k].asnumpy(),
                                      a.asnumpy())


def test_sparse_files_are_byte_for_byte_the_jax_packages(tmp_path):
    files = []
    for p, c in PKGS:
        with c:
            f = str(tmp_path / ('%s.params' % p.__name__))
            p.nd.save(f, _sparse_set(p, c), fmt='mxnet')
        files.append(open(f, 'rb').read())
    assert files[0] == files[1]
    with mt.cpu():
        r = mt.nd.load(str(tmp_path / 'mxnet_tpu_torch.params'))
    assert r['csr'].indptr.dtype == np.int32 and r['csr'].context == mt.cpu()


# ---------------------------------------------------------------------------
# the kvstore
# ---------------------------------------------------------------------------

def test_row_sparse_pull():
    def fn(p, c):
        kv = p.kv.create('local')
        w = p.nd.array(np.arange(24.0).reshape(8, 3), ctx=c)
        kv.init('w', w)
        kv.init('r', p.nd.sparse.row_sparse_array(_dense(25, (8, 3)), ctx=c))
        ids = p.nd.array([6, 1, 1, 3], ctx=c)
        dense_out = p.nd.zeros((8, 3), ctx=c)
        rsp_out = p.nd.sparse.zeros('row_sparse', (8, 3), ctx=c)
        kv.row_sparse_pull('w', out=dense_out, row_ids=ids)
        kv.row_sparse_pull('w', out=rsp_out, row_ids=ids)
        r_out = p.nd.zeros((8, 3), ctx=c)
        kv.row_sparse_pull('r', out=[r_out], row_ids=ids)
        outs = [p.nd.zeros((8, 3), ctx=c), p.nd.zeros((8, 3), ctx=c)]
        kv.row_sparse_pull(['w', 'r'], out=outs,
                           row_ids=[ids, p.nd.array([0, 2], ctx=c)])
        return [dense_out, r_out] + outs + [rsp_out.tostype('default')]
    for t, j in zip(*both(fn)):
        _same(t, j)


def test_push_lowers_sparse_values():
    def fn(p, c):
        kv = p.kv.create('local')
        kv.init('g', p.nd.zeros((6, 5), ctx=c))
        kv.push('g', [p.nd.sparse.row_sparse_array(_dense(26), ctx=c),
                      p.nd.sparse.row_sparse_array(_dense(27), ctx=c)])
        out = p.nd.zeros((6, 5), ctx=c)
        kv.pull('g', out=out)
        return out
    _same(*both(fn))


# ---------------------------------------------------------------------------
# the native storage pool and the error type
# ---------------------------------------------------------------------------

def test_storage_pool_reuse():
    lib = _native.get_lib()
    if lib is None:
        pytest.skip('no g++ on this host: the native library is not built')
    lib.MXTStorageReleaseAll()
    before = (ctypes.c_int64 * 4)()
    lib.MXTStorageStats(before)
    p = ctypes.c_void_p()
    _native.check_call(lib.MXTStorageAlloc(5000, ctypes.byref(p)), lib)
    first = p.value
    _native.check_call(lib.MXTStorageFree(p), lib)
    _native.check_call(lib.MXTStorageAlloc(4100, ctypes.byref(p)), lib)
    # the same 8192 bucket: the same block handed back
    assert p.value == first
    after = (ctypes.c_int64 * 4)()
    lib.MXTStorageStats(after)
    assert after[3] - before[3] == 1  # exactly one pool hit
    _native.check_call(lib.MXTStorageDirectFree(p), lib)
    with pytest.raises(_native.NativeError, match='unknown pointer'):
        _native.check_call(lib.MXTStorageFree(ctypes.c_void_p(16)), lib)


def test_not_supported_for_sparse_error():
    from mxnet_tpu.base import NotSupportedForSparseNDArray as J

    def f():
        pass
    t, j = NotSupportedForSparseNDArray(f, 'op', 1), J(f, 'op', 1)
    assert str(t) == str(j) and isinstance(t, MXNetError)
