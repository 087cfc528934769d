"""NDArray files: ``save`` and ``load``, the counterpart of
``mxnet_tpu/ndarray/utils.py``, in its two formats:

- the npz container (the default of ``save``): one ``.npz`` whose
  ``__format__`` entry says 'list' or 'dict', list items under
  ``__mxtpu_list__<i>``;
- the reference's binary list format (list magic 0x112, each array under
  the V2 magic 0xF993FAC9 with its shape, context and mshadow type flag,
  then the names), written by ``save(..., fmt='mxnet')``.

``load`` tells them apart by the list magic, so files cross between the
two packages (and the reference's ``.params`` files load) in either
direction. As in the JAX package, 64-bit payloads are narrowed to 32 bits
(an integer beyond int32 raises), bfloat16 is written as float32 in the
binary format, and a 0-d array as shape (1,). Loaded arrays are on the
CPU, the context the files record. Sparse arrays (:mod:`.sparse`) go into
the binary format as the reference lays them out: row_sparse is storage
type 1 with the aux array ``[indices]``, csr type 2 with ``[indptr,
indices]``, each aux array int64, the data under its storage shape; the
npz container stores them dense, as the JAX package does.
"""
import struct
import warnings

import numpy as np

from ..context import cpu
from . import sparse
from .ndarray import NDArray, array

__all__ = ['save', 'load']

_LIST_KEY = '__mxtpu_list__%d'

_LIST_MAGIC = 0x112
_V2_MAGIC = 0xF993FAC9
_V1_MAGIC = 0xF993FAC8
# mshadow type flags (mshadow/base.h)
_TYPE_FLAGS = {0: np.float32, 1: np.float64, 2: np.float16,
               3: np.uint8, 4: np.int32, 5: np.int8, 6: np.int64}
_FLAG_OF = {np.dtype(v): k for k, v in _TYPE_FLAGS.items()}


def _host(npy):
    return array(npy, ctx=cpu())


def save(fname, data, fmt='npz'):
    """Save an NDArray, a list or a dict of them. ``fmt='npz'`` (the npz
    container) or ``'mxnet'`` (the reference's binary list format)."""
    if isinstance(data, NDArray):
        data = [data]
    if fmt == 'mxnet':
        return _save_mxnet(fname, data)
    if fmt != 'npz':
        raise ValueError("fmt must be 'npz' or 'mxnet'")
    if isinstance(data, dict):
        arrays = {k: v.asnumpy() for k, v in data.items()}
        container = 'dict'
    elif isinstance(data, (list, tuple)):
        arrays = {_LIST_KEY % i: v.asnumpy() for i, v in enumerate(data)}
        container = 'list'
    else:
        raise ValueError('data must be NDArray, list or dict')
    with open(fname, 'wb') as f:  # savez would append .npz to a str path
        np.savez(f, __format__=container, **arrays)


def load(fname):
    """A list or dict of CPU NDArrays from ``fname``, in either format."""
    with open(fname, 'rb') as f:
        head = f.read(8)
    if len(head) == 8 and struct.unpack('<Q', head)[0] == _LIST_MAGIC:
        return _load_mxnet(fname)
    with np.load(fname, allow_pickle=False) as f:
        container = str(f['__format__'])
        keys = [k for k in f.files if k != '__format__']
        if container == 'list':
            return [_host(f[_LIST_KEY % i]) for i in range(len(keys))]
        return {k: _host(f[k]) for k in keys}


# ---------------------------------------------------------------------------
# the reference's binary format
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def take(self, n):
        b = self.buf[self.pos:self.pos + n]
        if len(b) != n:
            raise ValueError('truncated reference NDArray file')
        self.pos += n
        return b

    def u32(self):
        return struct.unpack('<I', self.take(4))[0]

    def i32(self):
        return struct.unpack('<i', self.take(4))[0]

    def u64(self):
        return struct.unpack('<Q', self.take(8))[0]

    def shape(self):
        # uint32 ndim, then int64 dims under the V1 and V2 magics
        ndim = self.u32()
        return tuple(struct.unpack('<%dq' % ndim, self.take(8 * ndim)))


def _read_one(r):
    """One NDArray (V2, V1 or the legacy form whose magic is ndim); a
    sparse one under V2."""
    magic = r.u32()
    stype, sshape, nad = 0, None, 0
    if magic == _V2_MAGIC:
        stype = r.i32()
        nad = {1: 1, 2: 2}.get(stype, 0)   # row_sparse / csr aux counts
        if nad > 0:
            sshape = r.shape()
        shape = r.shape()
    elif magic == _V1_MAGIC:
        shape = r.shape()
    else:
        ndim = magic                       # legacy: the magic is ndim
        shape = tuple(struct.unpack('<%dI' % ndim, r.take(4 * ndim)))
    if len(shape) == 0:
        return _host(np.zeros((0,), np.float32))
    r.i32()  # dev_type (placement is ours to choose)
    r.i32()  # dev_id
    type_flag = r.i32()
    dtype = _TYPE_FLAGS.get(type_flag)
    if dtype is None:
        raise ValueError('unknown reference dtype flag %d' % type_flag)
    aux = []
    for _ in range(nad):
        at = r.i32()
        aux.append((_TYPE_FLAGS[at], r.shape()))
    data_shape = sshape if nad > 0 else shape
    n = int(np.prod(data_shape)) if data_shape else 1
    data = np.frombuffer(r.take(n * np.dtype(dtype).itemsize),
                         dtype=dtype).reshape(data_shape)
    aux_data = []
    for at, ash in aux:
        an = int(np.prod(ash)) if ash else 1
        aux_data.append(np.frombuffer(
            r.take(an * np.dtype(at).itemsize), dtype=at).reshape(ash))
    data = _guard_narrowing(data.copy())
    if nad == 0:
        return _host(data)
    aux_data = [_host(_guard_narrowing(a.astype(np.int64)))
                for a in aux_data]
    if stype == 1:  # row_sparse: aux [indices]
        return sparse.RowSparseNDArray(_host(data), aux_data[0], shape,
                                       cpu())
    # csr: aux [indptr, indices]
    return sparse.CSRNDArray(_host(data), aux_data[0], aux_data[1], shape,
                             cpu())


def _guard_narrowing(npy):
    """64-bit payloads are stored as 32 bits, as in the JAX package: raise
    on an integer beyond int32, warn when float64 loses precision."""
    if npy.dtype == np.int64:
        if npy.size and (np.abs(npy) > np.iinfo(np.int32).max).any():
            raise ValueError(
                'reference file holds int64 values beyond int32 range; '
                'NDArrays store them as int32')
        return npy
    if npy.dtype == np.float64:
        warnings.warn('float64 payload narrowed to float32', stacklevel=3)
    return npy


def _load_mxnet(fname):
    with open(fname, 'rb') as f:
        r = _Reader(f.read())
    assert r.u64() == _LIST_MAGIC
    r.u64()  # reserved
    n = r.u64()
    arrays = [_read_one(r) for _ in range(n)]
    n_names = r.u64()
    names = []
    for _ in range(n_names):
        ln = r.u64()
        names.append(r.take(ln).decode())
    if not names:
        return arrays
    if len(names) != len(arrays):
        raise ValueError('invalid reference NDArray file (name count)')
    return dict(zip(names, arrays))


def _shape_bytes(shape):
    return struct.pack('<I', len(shape)) + \
        struct.pack('<%dq' % len(shape), *shape)


def _body_bytes(npy):
    """The context (cpu(0)) and the type flag of a payload."""
    return (struct.pack('<ii', 1, 0) +
            struct.pack('<i', _FLAG_OF[np.dtype(npy.dtype)]))


def _write_sparse(f, arr):
    """row_sparse (storage type 1, aux [indices]) or csr (type 2, aux
    [indptr, indices]) in the reference's layout."""
    data = arr.data.asnumpy()
    if np.dtype(data.dtype) not in _FLAG_OF:
        data = data.astype(np.float32)
    if isinstance(arr, sparse.RowSparseNDArray):
        stype, auxes = 1, [arr.indices.asnumpy().astype(np.int64)]
    else:
        stype = 2
        auxes = [arr.indptr.asnumpy().astype(np.int64),
                 arr.indices.asnumpy().astype(np.int64)]
    f.write(struct.pack('<I', _V2_MAGIC))
    f.write(struct.pack('<i', stype))
    f.write(_shape_bytes(data.shape))                    # storage shape
    f.write(_shape_bytes(arr.shape))
    f.write(_body_bytes(data))
    for a in auxes:
        f.write(struct.pack('<i', _FLAG_OF[np.dtype(a.dtype)]))
        f.write(_shape_bytes(a.shape))
    f.write(np.ascontiguousarray(data).tobytes())
    for a in auxes:
        f.write(np.ascontiguousarray(a).tobytes())


def _write_one(f, arr):
    if isinstance(arr, sparse.BaseSparseNDArray):
        return _write_sparse(f, arr)
    npy = arr.asnumpy()
    if np.dtype(npy.dtype) not in _FLAG_OF:
        npy = npy.astype(np.float32)   # bfloat16 and others: as float32
    if npy.ndim == 0:
        npy = npy.reshape(1)           # the reference has no 0-d arrays
    f.write(struct.pack('<I', _V2_MAGIC))
    f.write(struct.pack('<i', 0))                        # dense storage
    f.write(_shape_bytes(npy.shape))
    f.write(_body_bytes(npy))
    f.write(np.ascontiguousarray(npy).tobytes())


def _save_mxnet(fname, data):
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    elif isinstance(data, (list, tuple)):
        names, arrays = [], list(data)
    else:
        raise ValueError('data must be NDArray, list or dict')
    with open(fname, 'wb') as f:
        f.write(struct.pack('<QQ', _LIST_MAGIC, 0))
        f.write(struct.pack('<Q', len(arrays)))
        for a in arrays:
            _write_one(f, a)
        f.write(struct.pack('<Q', len(names)))
        for nm in names:
            b = nm.encode()
            f.write(struct.pack('<Q', len(b)))
            f.write(b)
