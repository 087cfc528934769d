"""Sparse storage, row_sparse and csr, and its ops: the counterpart of
``mxnet_tpu/ndarray/sparse.py``.

A sparse array is a container of the port's NDArrays on one device: a
``RowSparseNDArray`` holds ``data`` (the stored rows) and ``indices``
(their row ids), a ``CSRNDArray`` ``data``, ``indptr`` and ``indices`` in
the reference's aux layout. Index arrays are int32, as the JAX package's
are with x64 off. The values are computed on the array's device, and so
is the index metadata that the JAX package builds on the host (a row id
per value from ``indptr``, ``retain``'s membership mask, ``add``'s index
union): ``repeat_interleave`` over ``indptr``'s differences, ``isin``,
``unique`` and ``searchsorted`` give the same indices in the same order.
An op whose output size depends on the data (a boolean selection, a
``unique``) reads that size back from the device, as any such op does.

- ``dot(csr, dense)`` is a gather of the dense rows by column and a
  segment sum by row (``index_add_``), so its work is proportional to the
  stored values, not to the dense shape;
- ``dot(csr.T, dense)`` sums by column into the unique columns only and
  gives a ``RowSparseNDArray`` of them (the JAX form sums into all
  ``shape[1]`` rows and then gathers the unique ones: the same values);
- ``retain``, ``square_sum`` and ``add`` (row_sparse + row_sparse, the
  index union) keep their row structure;
- any other arithmetic lowers the sparse operand to dense and gives a
  dense NDArray, as the reference's elemwise fallbacks do.

As in the JAX package, the sparse ops are not recorded by autograd: they
run under ``torch.no_grad``.
"""
import numpy as np
import torch

from ..base import torch_dtype
from ..context import current_context
from .ndarray import NDArray, array as _dense_array, invoke, narrowed

__all__ = ['RowSparseNDArray', 'CSRNDArray', 'row_sparse_array', 'csr_matrix',
           'BaseSparseNDArray', 'cast_storage', 'retain', 'sparse_retain',
           'dot', 'square_sum', 'add', 'zeros', 'empty', 'array']


def _index(t, ctx):
    """An index tensor as the JAX package stores one: int32, on ``ctx``."""
    return NDArray(t.to(torch.int32), ctx)


# elements a block of rows when a dense array is scanned for its nonzeros:
# torch.nonzero takes fewer than 2^31 elements on the card, and a block
# bounds the masks' memory
_SCAN = 1 << 28


def _row_blocks(n_rows, row_size):
    step = max(1, _SCAN // max(row_size, 1))
    return [(s, min(n_rows, s + step)) for s in range(0, n_rows, step)]


def _host_dtype(arr):
    """The dtype of ``arr.asnumpy()`` (bfloat16 comes back as float32),
    which the JAX package's casts pass on as the stored dtype."""
    return np.float32 if arr._data.dtype == torch.bfloat16 else arr.dtype


class BaseSparseNDArray:
    def __init__(self, shape, ctx=None, dtype='float32'):
        self._shape = tuple(shape)
        self._ctx = ctx or current_context()
        self._dtype = np.dtype(dtype) if dtype != 'bfloat16' else dtype

    @property
    def shape(self):
        return self._shape

    @property
    def size(self):
        return int(np.prod(self._shape))

    @property
    def dtype(self):
        return self._dtype

    @property
    def context(self):
        return self._ctx

    ctx = context

    def asnumpy(self):
        return self.tostype('default').asnumpy()

    def wait_to_read(self):
        self.data.wait_to_read()

    def __repr__(self):
        return '<%s %s @%s>' % (type(self).__name__,
                                'x'.join(map(str, self._shape)), self._ctx)

    # the dense fallbacks: a sparse operand is lowered to dense and the
    # result is dense; subclasses keep the cases that stay sparse
    def _dense(self, other):
        return other.tostype('default') \
            if isinstance(other, BaseSparseNDArray) else other

    def __sub__(self, other):
        return self.tostype('default') - self._dense(other)

    def __rsub__(self, other):
        return self._dense(other) - self.tostype('default')

    def __truediv__(self, other):
        return self.tostype('default') / self._dense(other)

    def __rtruediv__(self, other):
        return self._dense(other) / self.tostype('default')

    def __neg__(self):
        return self * -1.0

    def __add__(self, other):
        return self.tostype('default') + self._dense(other)

    __radd__ = __add__

    def __mul__(self, other):
        return self.tostype('default') * self._dense(other)

    __rmul__ = __mul__


class RowSparseNDArray(BaseSparseNDArray):
    """Rows ``indices`` hold ``data``; every other row is zero."""

    stype = 'row_sparse'

    def __init__(self, data, indices, shape, ctx=None):
        super().__init__(shape, ctx, data.dtype)
        self.data = data          # NDArray (stored rows, *shape[1:])
        self.indices = indices    # NDArray int32 (stored rows,)

    @torch.no_grad()
    def tostype(self, stype):
        if stype == 'row_sparse':
            return self
        if stype != 'default':
            raise ValueError('cast from row_sparse to %s is not supported'
                             % stype)
        vals = self.data._data
        dense = torch.zeros(self._shape, dtype=vals.dtype, device=vals.device)
        dense[self.indices._data.long()] = vals
        return NDArray(dense, self._ctx)

    def copyto(self, other):
        if isinstance(other, NDArray):
            other._data = self.tostype('default')._data.to(
                other._ctx.torch_device())
            return other
        return RowSparseNDArray(self.data.copyto(other),
                                self.indices.copyto(other), self._shape, other)

    def copy(self):
        return RowSparseNDArray(self.data.copy(), self.indices.copy(),
                                self._shape, self._ctx)

    def retain(self, row_ids):
        return retain(self, row_ids)

    def __add__(self, other):
        if isinstance(other, RowSparseNDArray):
            return add(self, other)
        return self.tostype('default') + self._dense(other)

    __radd__ = __add__

    def __mul__(self, other):
        if np.isscalar(other):
            return RowSparseNDArray(self.data * other, self.indices,
                                    self._shape, self._ctx)
        return self.tostype('default') * self._dense(other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        if np.isscalar(other):
            return RowSparseNDArray(self.data / other, self.indices,
                                    self._shape, self._ctx)
        return self.tostype('default') / self._dense(other)

    def __sub__(self, other):
        if isinstance(other, RowSparseNDArray):
            return add(self, other * -1.0)
        return self.tostype('default') - self._dense(other)


class CSRNDArray(BaseSparseNDArray):
    """A compressed sparse row matrix."""

    stype = 'csr'

    def __init__(self, data, indptr, indices, shape, ctx=None):
        super().__init__(shape, ctx, data.dtype)
        self.data = data
        self.indptr = indptr
        self.indices = indices

    @torch.no_grad()
    def tostype(self, stype):
        if stype == 'csr':
            return self
        if stype == 'row_sparse':
            # through the dense rows, as the JAX package casts
            return row_sparse_array(self.tostype('default'), ctx=self._ctx,
                                    dtype=_host_dtype(self.data))
        if stype != 'default':
            raise ValueError(stype)
        vals = self.data._data
        dense = torch.zeros(self._shape, dtype=vals.dtype, device=vals.device)
        dense[self._row_ids(), self.indices._data.long()] = vals
        return NDArray(dense, self._ctx)

    def _row_ids(self):
        """The row of each stored value (int64, on the array's device):
        each row id repeated by its ``indptr`` difference. The count of
        values is the data's length, so nothing is read back."""
        ptr = self.indptr._data.long()
        counts = ptr[1:] - ptr[:-1]
        rows = torch.arange(counts.shape[0], device=ptr.device)
        return torch.repeat_interleave(rows, counts,
                                       output_size=self.data.shape[0])

    def copyto(self, other):
        if isinstance(other, NDArray):
            other._data = self.tostype('default')._data.to(
                other._ctx.torch_device())
            return other
        return CSRNDArray(self.data.copyto(other), self.indptr.copyto(other),
                          self.indices.copyto(other), self._shape, other)

    def copy(self):
        return CSRNDArray(self.data.copy(), self.indptr.copy(),
                          self.indices.copy(), self._shape, self._ctx)

    def __getitem__(self, key):
        """Row slicing, step 1 (an int is a slice of one row)."""
        if isinstance(key, int):
            key = slice(key, key + 1)
        start, stop, step = key.indices(self._shape[0])
        if step != 1:
            raise ValueError('CSR slicing requires step 1')
        ptr = self.indptr._data
        lo, hi = (int(v) for v in ptr[[start, stop]].tolist())
        return CSRNDArray(
            NDArray(self.data._data[lo:hi].clone(), self._ctx),
            _index(ptr[start:stop + 1] - lo, self._ctx),
            _index(self.indices._data[lo:hi], self._ctx),
            (stop - start, self._shape[1]), self._ctx)


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------

def _on_ctx(arr, ctx):
    """A dense NDArray source as a tensor on ``ctx`` (numpy and lists go
    through ``nd.array``'s placement)."""
    if isinstance(arr, NDArray):
        return arr._data.to(ctx.torch_device())
    return _dense_array(np.asarray(arr), ctx)._data


@torch.no_grad()
def row_sparse_array(arg1, shape=None, ctx=None, dtype='float32'):
    """A RowSparseNDArray from ``(data, indices)`` or from a dense array
    (its rows that hold a nonzero)."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        data = data if isinstance(data, NDArray) else \
            _dense_array(np.asarray(data, dtype=dtype), ctx)
        indices = indices if isinstance(indices, NDArray) else \
            _dense_array(np.asarray(indices, dtype=np.int64), ctx,
                         dtype='int64')
        if shape is None:
            nrows = int(indices._data.max()) + 1 if indices.size else 0
            shape = (nrows,) + data.shape[1:]
        return RowSparseNDArray(data, indices, shape, ctx)
    ctx = ctx if ctx is not None else current_context()
    dense = _on_ctx(arg1, ctx).to(torch_dtype(narrowed(dtype)))
    flat = dense.reshape(dense.shape[0], -1)
    keep = [(flat[a:b] != 0).any(dim=1) for a, b in _row_blocks(*flat.shape)]
    nz = torch.nonzero(torch.cat(keep)).reshape(-1) if keep else \
        torch.zeros((0,), dtype=torch.int64, device=dense.device)
    return RowSparseNDArray(NDArray(dense[nz], ctx), _index(nz, ctx),
                            tuple(dense.shape), ctx)


@torch.no_grad()
def csr_matrix(arg1, shape=None, ctx=None, dtype='float32'):
    """A CSRNDArray from ``(data, indices, indptr)`` or from a dense 2-d
    array (its nonzeros in row-major order, as scipy's ``csr_matrix``
    gives them)."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        data = data if isinstance(data, NDArray) else \
            _dense_array(np.asarray(data, dtype=dtype), ctx)
        indices = indices if isinstance(indices, NDArray) else \
            _dense_array(np.asarray(indices, dtype=np.int64), ctx,
                         dtype='int64')
        indptr = indptr if isinstance(indptr, NDArray) else \
            _dense_array(np.asarray(indptr, dtype=np.int64), ctx,
                         dtype='int64')
        return CSRNDArray(data, indptr, indices, shape, ctx)
    ctx = ctx if ctx is not None else current_context()
    dense = _on_ctx(arg1, ctx).to(torch_dtype(narrowed(dtype)))
    if dense.dim() != 2:
        raise ValueError('csr requires a 2-d array')
    # the nonzeros in row-major order, a block of rows at a time
    rows, cols = [], []
    for a, b in _row_blocks(*dense.shape):
        r, c = torch.nonzero(dense[a:b], as_tuple=True)
        rows.append(r + a)
        cols.append(c)
    rows = torch.cat(rows) if rows else torch.zeros(
        (0,), dtype=torch.int64, device=dense.device)
    cols = torch.cat(cols) if cols else rows
    indptr = torch.zeros(dense.shape[0] + 1, dtype=torch.int64,
                         device=dense.device)
    indptr[1:] = torch.cumsum(torch.bincount(rows,
                                             minlength=dense.shape[0]), dim=0)
    return CSRNDArray(NDArray(dense[rows, cols], ctx), _index(indptr, ctx),
                      _index(cols, ctx), tuple(dense.shape), ctx)


def zeros(stype, shape, ctx=None, dtype='float32'):
    """An all-zero array of ``stype`` (a sparse one stores no values)."""
    if stype == 'row_sparse':
        return RowSparseNDArray(
            _dense_array(np.zeros((0,) + tuple(shape[1:]), dtype), ctx),
            _dense_array(np.zeros((0,), np.int64), ctx, dtype='int64'),
            shape, ctx)
    if stype == 'csr':
        return CSRNDArray(
            _dense_array(np.zeros((0,), dtype), ctx),
            _dense_array(np.zeros((shape[0] + 1,), np.int64), ctx,
                         dtype='int64'),
            _dense_array(np.zeros((0,), np.int64), ctx, dtype='int64'),
            shape, ctx)
    from .ndarray import zeros as dense_zeros
    return dense_zeros(shape, ctx, dtype)


empty = zeros


def array(source, ctx=None, dtype='float32'):
    """A sparse array from a sparse one (a copy) or a scipy sparse matrix
    (csr)."""
    if isinstance(source, (RowSparseNDArray, CSRNDArray)):
        return source.copy()
    import scipy.sparse as sp
    if sp.issparse(source):
        m = source.tocsr()
        return csr_matrix((m.data, m.indices, m.indptr), shape=m.shape,
                          ctx=ctx, dtype=dtype)
    raise ValueError('use mx.nd.array for dense sources')


# ---------------------------------------------------------------------------
# sparse ops
# ---------------------------------------------------------------------------

def cast_storage(arr, stype):
    """dense <-> row_sparse <-> csr."""
    if isinstance(arr, BaseSparseNDArray):
        return arr.tostype(stype)
    if stype == 'default':
        return arr.copy()
    if stype == 'row_sparse':
        return row_sparse_array(arr, ctx=arr.context, dtype=_host_dtype(arr))
    if stype == 'csr':
        if len(arr.shape) != 2:
            raise ValueError('csr requires a 2-d array')
        return csr_matrix(arr, ctx=arr.context, dtype=_host_dtype(arr))
    raise ValueError('unknown storage type %r' % (stype,))


@torch.no_grad()
def retain(rsp, row_ids):
    """The stored rows of ``rsp`` whose ids are in ``row_ids``, in their
    stored order (a missing row stays absent)."""
    if not isinstance(rsp, RowSparseNDArray):
        raise TypeError('sparse_retain expects a RowSparseNDArray')
    have = rsp.indices._data.long()
    if isinstance(row_ids, NDArray):
        want = row_ids._data.to(have.device)
    else:
        want = torch.as_tensor(np.asarray(row_ids), device=have.device)
    mask = torch.isin(have, torch.unique(want.long()))
    return RowSparseNDArray(NDArray(rsp.data._data[mask], rsp._ctx),
                            _index(have[mask], rsp._ctx), rsp.shape, rsp._ctx)


sparse_retain = retain


@torch.no_grad()
def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """dot(csr, dense) -> dense; dot(csr.T, dense) -> row_sparse; any
    other sparse operand is lowered to dense."""
    if transpose_b:
        raise NotImplementedError('transpose_b with sparse inputs '
                                  '(unsupported in the reference too)')
    if isinstance(lhs, CSRNDArray):
        dense_rhs = (rhs.tostype('default')
                     if isinstance(rhs, BaseSparseNDArray) else rhs)._data
        rows = lhs._row_ids()
        cols = lhs.indices._data.long()
        vals = lhs.data._data
        if not transpose_a:
            # out[i] = sum over row i's values of val * rhs[col]
            contrib = vals[:, None] * dense_rhs[cols]
            out = torch.zeros((lhs.shape[0],) + tuple(contrib.shape[1:]),
                              dtype=contrib.dtype, device=contrib.device)
            out.index_add_(0, rows, contrib)
            return NDArray(out.to(dense_rhs.dtype), lhs._ctx)
        # csr.T x dense: sum by column into the unique columns
        contrib = vals[:, None] * dense_rhs[rows]
        nz, slot = torch.unique(cols, return_inverse=True)
        out = torch.zeros((nz.shape[0],) + tuple(contrib.shape[1:]),
                          dtype=contrib.dtype, device=contrib.device)
        out.index_add_(0, slot, contrib)
        return RowSparseNDArray(NDArray(out, lhs._ctx), _index(nz, lhs._ctx),
                                (lhs.shape[1], dense_rhs.shape[1]), lhs._ctx)
    if isinstance(rhs, BaseSparseNDArray) or isinstance(lhs,
                                                        BaseSparseNDArray):
        lhs_d = lhs.tostype('default') if isinstance(
            lhs, BaseSparseNDArray) else lhs
        rhs_d = rhs.tostype('default') if isinstance(
            rhs, BaseSparseNDArray) else rhs
        return invoke('dot', [lhs_d, rhs_d], {'transpose_a': transpose_a})
    return invoke('dot', [lhs, rhs], {'transpose_a': transpose_a,
                                      'transpose_b': transpose_b})


@torch.no_grad()
def square_sum(rsp, axis=None, keepdims=False):
    """The sum of squares of a row_sparse array without densifying it:
    ``axis=1`` with ``keepdims`` keeps the row structure."""
    if not isinstance(rsp, RowSparseNDArray):
        raise TypeError('square_sum expects a RowSparseNDArray')
    sq = rsp.data._data.float() ** 2
    if axis is None:
        out = sq.sum()
        return NDArray(out.reshape((1,) * len(rsp.shape)) if keepdims
                       else out, rsp._ctx)
    axis = int(axis) % len(rsp.shape)
    if axis == 1:
        row_sums = sq.sum(dim=tuple(range(1, sq.dim())))
        if keepdims:
            return RowSparseNDArray(NDArray(row_sums[:, None], rsp._ctx),
                                    rsp.indices, (rsp.shape[0], 1), rsp._ctx)
        dense = torch.zeros((rsp.shape[0],), dtype=torch.float32,
                            device=sq.device)
        dense[rsp.indices._data.long()] = row_sums
        return NDArray(dense, rsp._ctx)
    # axis 0: a dense row vector
    out = sq.sum(dim=0)
    return NDArray(out[None] if keepdims else out, rsp._ctx)


@torch.no_grad()
def add(a, b):
    """row_sparse + row_sparse -> row_sparse over the union of their
    indices (sorted); any other pair through the dense sum."""
    if not (isinstance(a, RowSparseNDArray) and
            isinstance(b, RowSparseNDArray)):
        a_d = a.tostype('default') if isinstance(a, BaseSparseNDArray) else a
        b_d = b.tostype('default') if isinstance(b, BaseSparseNDArray) else b
        return a_d + b_d
    assert a.shape == b.shape, (a.shape, b.shape)
    ia, ib = a.indices._data.long(), b.indices._data.long()
    union = torch.unique(torch.cat([ia, ib.to(ia.device)]))
    da = a.data._data
    out = torch.zeros((union.shape[0],) + tuple(a.shape[1:]), dtype=da.dtype,
                      device=da.device)
    out.index_add_(0, torch.searchsorted(union, ia), da)
    out.index_add_(0, torch.searchsorted(union, ib.to(ia.device)),
                   b.data._data.to(da.device, da.dtype))
    return RowSparseNDArray(NDArray(out, a._ctx), _index(union, a._ctx),
                            a.shape, a._ctx)
