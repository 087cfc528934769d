"""Data iterators: the counterpart of ``mxnet_tpu/io/__init__.py`` for
``DataDesc``, ``DataBatch``, ``DataIter``, ``NDArrayIter`` (pad, discard
and roll_over), ``ResizeIter``, ``PrefetchingIter`` and ``auto_shard``.

An iterator keeps its source arrays on the host and yields CPU NDArrays,
as the JAX package's does under its default CPU context: the executor
group copies each batch into the arrays bound on the card. A seeded
shuffle draws from the host stream (:func:`..random.host_rng`), so
``random.seed(s)`` gives the same order in both packages.

With telemetry on, each batch an iterator yields counts in the
``io.batches`` counter, and the time ``PrefetchingIter`` waits for its
producer threads in the ``io.prefetch_wait`` histogram (ms).

Not ported yet: the record, image, MNIST, CSV and LibSVM iterators.
"""
from collections import namedtuple
import threading
import time

import numpy as np

from .. import random as _random
from .. import telemetry as _tele
from ..context import cpu
from ..ndarray import NDArray, array

__all__ = ['DataDesc', 'DataBatch', 'DataIter', 'NDArrayIter', 'ResizeIter',
           'PrefetchingIter', 'auto_shard']


def auto_shard():
    """``{'num_parts': P, 'part_index': i}`` from the launcher's
    environment (``MXTPU_NUM_HOSTS``, ``MXTPU_HOST_ID``); one part without
    it. The port has no process set yet to fall back on."""
    import os
    try:
        n = int(os.environ.get('MXTPU_NUM_HOSTS', '1') or 1)
        i = int(os.environ.get('MXTPU_HOST_ID', '0') or 0)
    except ValueError:
        n, i = 1, 0
    n = max(1, n)
    return {'num_parts': n, 'part_index': i % n}


class DataDesc(namedtuple('DataDesc', ['name', 'shape'])):
    """A named input's shape, dtype and layout."""

    def __new__(cls, name, shape, dtype=np.float32, layout='NCHW'):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find('N')


class DataBatch:
    """One batch: data and label lists, the padding at its end and the
    descriptors of its inputs."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None:
            assert isinstance(data, (list, tuple)), 'Data must be list of NDArrays'
        if label is not None:
            assert isinstance(label, (list, tuple)), 'Label must be list of NDArrays'
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """The iterator protocol: ``iter_next`` then ``getdata``/``getlabel``/
    ``getpad``/``getindex``."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            _tele.counter('io.batches').inc()
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError()

    def getdata(self):
        raise NotImplementedError()

    def getlabel(self):
        raise NotImplementedError()

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError()


def _init_data(data, allow_empty, default_name):
    """``data`` (an array, a list or a dict of them) as ``[(name, CPU
    NDArray)]``."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {('_%d_%s' % (i, default_name)): d
                    for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError('Input must be NDArray, numpy.ndarray, a list of them '
                        'or dict with them as values')
    out = []
    for k, v in data.items():
        if not isinstance(v, NDArray):
            v = array(np.asarray(v), ctx=cpu())
        out.append((k, v))
    return out


class NDArrayIter(DataIter):
    """Batches of in-memory arrays; the last short batch is padded from
    the start ('pad'), dropped ('discard') or carried into the next epoch
    ('roll_over')."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle='pad', data_name='data',
                 label_name='softmax_label'):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True, default_name=label_name)

        self.idx = np.arange(self.data[0][1].shape[0])
        if shuffle:
            _random.host_rng().shuffle(self.idx)
        self._shuffle = shuffle

        if last_batch_handle == 'discard':
            new_n = self.data[0][1].shape[0] - self.data[0][1].shape[0] % batch_size
            self.idx = self.idx[:new_n]

        self.data_list = [x[1] for x in self.data] + [x[1] for x in self.label]
        self.num_source = len(self.data_list)
        self.num_data = self.idx.shape[0]
        assert self.num_data >= batch_size, \
            'batch_size needs to be smaller than data size.'
        self.cursor = -batch_size
        self.batch_size = batch_size
        self.last_batch_handle = last_batch_handle
        # numpy staging for fancy indexing
        self._np_data = [x[1].asnumpy() for x in self.data]
        self._np_label = [x[1].asnumpy() for x in self.label]

    @property
    def provide_data(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype) for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype) for k, v in self.label]

    def hard_reset(self):
        self.cursor = -self.batch_size

    def reset(self):
        if self._shuffle:
            _random.host_rng().shuffle(self.idx)
        if self.last_batch_handle == 'roll_over' and \
                self.cursor > self.num_data:
            self.cursor = -self.batch_size + (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if self.iter_next():
            _tele.counter('io.batches').inc()
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=None,
                             provide_data=self.provide_data,
                             provide_label=self.provide_label)
        raise StopIteration

    def _getdata(self, arrays):
        assert self.cursor < self.num_data, 'DataIter needs reset.'
        if self.cursor + self.batch_size <= self.num_data:
            sel = self.idx[self.cursor:self.cursor + self.batch_size]
        else:
            pad = self.batch_size - self.num_data + self.cursor
            sel = np.concatenate([self.idx[self.cursor:], self.idx[:pad]])
        return [array(a[sel], ctx=cpu()) for a in arrays]

    def getdata(self):
        return self._getdata(self._np_data)

    def getlabel(self):
        return self._getdata(self._np_label)

    def getpad(self):
        if self.last_batch_handle == 'pad' and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


class ResizeIter(DataIter):
    """``data_iter`` cut or stretched to ``size`` batches an epoch."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Each of ``iters`` drawn one batch ahead on a thread of its own; the
    batches of all of them are joined into one."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        assert self.n_iter > 0
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0][1][0]
        self.data_ready = [threading.Event() for _ in range(self.n_iter)]
        self.data_taken = [threading.Event() for _ in range(self.n_iter)]
        for e in self.data_taken:
            e.set()
        self.started = True
        self.current_batch = [None for _ in range(self.n_iter)]
        self.next_batch = [None for _ in range(self.n_iter)]

        def prefetch_func(self, i):
            while True:
                self.data_taken[i].wait()
                if not self.started:
                    break
                try:
                    self.next_batch[i] = self.iters[i].next()
                except StopIteration:
                    self.next_batch[i] = None
                self.data_taken[i].clear()
                self.data_ready[i].set()

        self.prefetch_threads = [
            threading.Thread(target=prefetch_func, args=[self, i], daemon=True)
            for i in range(self.n_iter)]
        for thread in self.prefetch_threads:
            thread.start()

    def __del__(self):
        self.started = False
        for e in self.data_taken:
            e.set()

    def _renamed(self, descs, renames):
        if renames is None:
            return sum(descs, [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(x, DataDesc) else DataDesc(*x)
                     for x in d] for r, d in zip(renames, descs)], [])

    @property
    def provide_data(self):
        return self._renamed([i.provide_data for i in self.iters],
                             self.rename_data)

    @property
    def provide_label(self):
        return self._renamed([i.provide_label for i in self.iters],
                             self.rename_label)

    def reset(self):
        for e in self.data_ready:
            e.wait()
        for i in self.iters:
            i.reset()
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()

    def iter_next(self):
        if _tele.enabled():
            # how long the consumer waits for the producer threads: is the
            # input pipeline the bottleneck?
            t0 = time.time()
            for e in self.data_ready:
                e.wait()
            _tele.histogram('io.prefetch_wait').observe(
                (time.time() - t0) * 1e3)
        else:
            for e in self.data_ready:
                e.wait()
        if self.next_batch[0] is None:
            for i in self.next_batch:
                assert i is None, 'Number of entry mismatches between iterators'
            return False
        for batch in self.next_batch:
            assert batch.pad == self.next_batch[0].pad, \
                'Number of entry mismatches between iterators'
        self.current_batch = DataBatch(
            sum([batch.data for batch in self.next_batch], []),
            sum([batch.label for batch in self.next_batch], []),
            self.next_batch[0].pad, self.next_batch[0].index,
            provide_data=self.provide_data, provide_label=self.provide_label)
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad
