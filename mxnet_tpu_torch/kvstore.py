"""KVStore, the local key-value parameter store: the counterpart of the
local tier of ``mxnet_tpu/kvstore.py``.

``init`` stores a copy of a value under a key (a string or an int);
``push`` sums a list of values (on the first value's device) and either
runs the updater on the stored value or stores the sum; ``pull`` copies
the stored value into every target, cast to the target's dtype (a
multi-precision updater keeps f32 masters under bf16 weights) and on the
target's device. ``set_optimizer`` installs the optimizer's updater, and
the optimizer states save and load through it. ``row_sparse_pull`` copies
only the rows ``row_ids`` names: a row_sparse stored value is retained to
them, a dense one gives a row_sparse array of those rows, and a dense
target takes that array densified (zero elsewhere). A pushed sparse value
is lowered to dense before the sum. A push is fault injection's
``kvstore`` seam (``MXTPU_FAULT_INJECT``). With telemetry on, push
and pull are the ``kvstore.push`` and ``kvstore.pull`` spans, and the
bytes of their values count in ``kvstore.push_bytes`` and
``kvstore.pull_bytes``.

``create('local' | 'device' | 'local_allreduce_cpu' |
'local_allreduce_device')`` makes one. The dist types (a parameter server
across processes, NCCL across cards) are not ported: they raise
NotImplementedError (ROADMAP.md §1 item 11).
"""
import torch

from . import faults as _faults
from . import optimizer as opt
from . import telemetry as _tele
from .base import MXNetError
from .ndarray import NDArray
from .ndarray.sparse import BaseSparseNDArray, RowSparseNDArray, retain

__all__ = ['KVStore', 'create']


def _tele_bytes(counter_name, values):
    """Count the bytes of a push's or pull's values (a flat list or a list
    of lists of NDArrays) into a telemetry counter."""
    total = 0
    for v in values:
        for a in (v if isinstance(v, (list, tuple)) else [v]):
            # a sparse value counts its dense size, as in the JAX package
            t = a.data.handle if isinstance(a, BaseSparseNDArray) else a.handle
            total += a.size * t.element_size()
    _tele.counter(counter_name).inc(total)


class KVStore:
    """Init, push and pull over string or int keys, in one process."""

    def __init__(self, kv_type='local'):
        self.type = kv_type
        self._store = {}
        self._updater = None
        self._optimizer = None

    # -- lifecycle --------------------------------------------------------
    def init(self, key, value):
        keys, values = _key_value(key, value)
        for k, v in zip(keys, values):
            if k in self._store:
                continue
            vv = v[0] if isinstance(v, (list, tuple)) else v
            self._store[k] = vv.copy() if isinstance(vv, NDArray) else vv

    def push(self, key, value, priority=0):
        """Sum each key's values; run the updater on the stored value with
        the sum, or store the sum."""
        with _tele.span('kvstore.push', 'kvstore'):
            if _faults.enabled():
                # the dispatch-exception seam: the gradient push that would
                # train the current step
                _faults.maybe_raise('kvstore')
            keys, values = _key_value(key, value)
            if _tele.enabled():
                _tele_bytes('kvstore.push_bytes', values)
            for k, vlist in zip(keys, values):
                if not isinstance(vlist, (list, tuple)):
                    vlist = [vlist]
                merged = self._reduce(vlist)
                if self._updater is not None:
                    self._updater(_updater_key(k), merged, self._store[k])
                else:
                    self._store[k] = merged

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Copy each key's stored value into its target(s)."""
        assert out is not None
        with _tele.span('kvstore.pull', 'kvstore'):
            keys, outs = _key_value(key, out)
            if _tele.enabled():
                _tele_bytes('kvstore.pull_bytes', outs)
            for k, olist in zip(keys, outs):
                if not isinstance(olist, (list, tuple)):
                    olist = [olist]
                src = self._store[k]._data
                for o in olist:
                    o._data = src.to(o._data.device, o._data.dtype,
                                     copy=True)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Copy the rows ``row_ids`` of each key's stored value into its
        target(s)."""
        assert out is not None and row_ids is not None
        keys, outs = _key_value(key, out)
        if isinstance(row_ids, NDArray):
            row_ids = [row_ids] * len(keys)
        for k, olist, rids in zip(keys, outs, row_ids if isinstance(
                row_ids, list) else [row_ids]):
            if not isinstance(olist, (list, tuple)):
                olist = [olist]
            src = self._store[k]
            if isinstance(src, RowSparseNDArray):
                res = retain(src, rids)
            else:
                rows = rids._data.to(src._data.device).long()
                res = RowSparseNDArray(
                    NDArray(src._data[rows], src.context),
                    NDArray(rows.to(torch.int32), src.context), src.shape,
                    src.context)
            for o in olist:
                if isinstance(o, RowSparseNDArray):
                    o.data, o.indices = res.data, res.indices
                else:
                    res.copyto(o)

    def _reduce(self, vlist):
        """The sum of ``vlist`` on the first value's device (sparse values
        lowered to dense)."""
        if isinstance(vlist[0], BaseSparseNDArray):
            vlist = [v.tostype('default') for v in vlist]
        if len(vlist) == 1:
            return vlist[0].copy()
        dev = vlist[0]._data.device
        total = vlist[0]._data
        for v in vlist[1:]:
            total = total + v._data.to(dev)
        return NDArray(total, vlist[0].context)

    # -- optimizer plumbing ----------------------------------------------
    def set_updater(self, updater):
        self._updater = updater

    _set_updater = set_updater

    def set_optimizer(self, optimizer):
        """Install ``optimizer``'s updater: pushes then update the stored
        values."""
        self._optimizer = optimizer
        self.set_updater(opt.get_updater(optimizer))

    # -- topology of one process ------------------------------------------
    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def barrier(self):
        pass

    def _barrier(self):
        self.barrier()

    def _send_command_to_servers(self, head, body):
        pass

    def num_dead_node(self, node_id=6, timeout=60):
        return 0

    # -- optimizer states ---------------------------------------------------
    def save_optimizer_states(self, fname, dump_optimizer=False):
        assert self._updater is not None, 'Cannot save states for distributed training'
        with open(fname, 'wb') as fout:
            fout.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        assert self._updater is not None, 'Cannot load states for distributed training'
        with open(fname, 'rb') as fin:
            self._updater.set_states(fin.read())


def _updater_key(k):
    if isinstance(k, str) and k.isdigit():
        return int(k)
    return k


def _key_value(key, value):
    if isinstance(key, (str, int)):
        return [key], [value]
    assert len(key) == len(value)
    return list(key), list(value)


def create(name='local'):
    """A KVStore of type ``name``: local, device, local_allreduce_cpu or
    local_allreduce_device. The dist types raise NotImplementedError."""
    if not isinstance(name, str):
        raise TypeError('name must be a string')
    if 'dist' in name:
        raise NotImplementedError(
            'the %r KVStore (across processes or cards) is not ported yet '
            '(ROADMAP.md §1 item 11)' % name)
    if name in ('local', 'device', 'local_allreduce_cpu',
                'local_allreduce_device'):
        return KVStore(name)
    raise MXNetError('unknown KVStore type %s' % name)
