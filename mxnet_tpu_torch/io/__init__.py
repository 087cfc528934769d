"""Data iterators: the counterpart of ``mxnet_tpu/io/__init__.py``:
``DataDesc``, ``DataBatch``, ``DataIter``, ``NDArrayIter`` (pad, discard
and roll_over), ``ResizeIter``, ``PrefetchingIter``, ``MNISTIter`` (with
``synthetic_mnist``), ``CSVIter``, ``ImageRecordIter`` (the streaming
pipeline of :mod:`.image_record`, with its device augment),
``ImageDetRecordIter``, ``MXDataIter`` and ``auto_shard``.

An iterator keeps its source arrays on the host and yields CPU NDArrays,
as the JAX package's does under its default CPU context: the executor
group copies each batch into the arrays bound on the card. A seeded
shuffle and every host augment draw come from the host stream
(:func:`..random.host_rng`), so ``random.seed(s)`` gives the same order
and the same batches in both packages.

``ImageRecordIter``'s device augment (``device_augment=1`` or
``MXTPU_DEVICE_AUGMENT=1``) ships uint8 batches, a quarter of the f32
bytes, and crops, mirrors and normalises them on the current context's
device (the card unless the caller's context is the CPU), with an explicit
``torch.Generator`` on that device seeded from the port's per-run stream
(:func:`..random.next_seed`) for each batch: the fused fit window
(``module/fused_fit.py``) takes the raw batches (``defer_device_aug``)
and applies the same function inside its steps, drawing the same seeds in
the same order, so the window and the per-batch loop see the same
batches. Philox cannot match threefry: the device augment's random crops
and mirrors agree with the JAX package's in distribution only.

With telemetry on, each batch an iterator yields counts in the
``io.batches`` counter, and the time ``PrefetchingIter`` waits for its
producer threads in the ``io.prefetch_wait`` histogram (ms).

``LibSVMIter`` parses a libsvm file on the host and yields CSR batches
(:mod:`..ndarray.sparse`) on the current context, as the JAX package's
does: the card by default, where ``nd.sparse.dot`` and the executor's
dense lowering of a CSR batch run.
"""
from collections import namedtuple
import gzip
import os
import struct
import threading
import time

import numpy as np
import torch

from .. import random as _random
from .. import telemetry as _tele
from ..context import cpu, current_context
from ..ndarray import NDArray, array
from ..ndarray.sparse import csr_matrix

__all__ = ['DataDesc', 'DataBatch', 'DataIter', 'NDArrayIter', 'CSVIter',
           'MNISTIter', 'ResizeIter', 'PrefetchingIter', 'ImageRecordIter',
           'ImageDetRecordIter', 'LibSVMIter', 'MXDataIter', 'auto_shard',
           'synthetic_mnist', 'aug_generator']


def auto_shard():
    """``{'num_parts': P, 'part_index': i}`` from the launcher's
    environment (``MXTPU_NUM_HOSTS``, ``MXTPU_HOST_ID``); one part without
    it. The port has no process set yet to fall back on."""
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


# ---------------------------------------------------------------------------
# MNIST, CSV and LibSVM
# ---------------------------------------------------------------------------

def _read_mnist_images(path):
    opener = gzip.open if path.endswith('.gz') else open
    with opener(path, 'rb') as f:
        magic, num, rows, cols = struct.unpack('>IIII', f.read(16))
        if magic != 2051:
            raise ValueError('%s is not an idx3 image file' % path)
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(num, rows, cols)


def _read_mnist_labels(path):
    opener = gzip.open if path.endswith('.gz') else open
    with opener(path, 'rb') as f:
        magic, num = struct.unpack('>II', f.read(8))
        if magic != 2049:
            raise ValueError('%s is not an idx1 label file' % path)
        return np.frombuffer(f.read(), dtype=np.uint8)


def synthetic_mnist(n, seed=0):
    """Class-separable synthetic digits, the JAX package's: 10 fixed
    random prototype images (``RandomState(42)``) plus noise."""
    protos = np.random.RandomState(42).rand(10, 28, 28).astype(np.float32)
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n)
    images = protos[labels] + 0.3 * rng.randn(n, 28, 28).astype(np.float32)
    return np.clip(images, 0, 1).astype(np.float32), labels.astype(np.float32)


class MNISTIter(NDArrayIter):
    """MNIST's idx files (gzipped or not) as batches of (1, 28, 28) images
    in [0, 1] (or flat rows); without the files, the synthetic set of
    :func:`synthetic_mnist` (12,000 images for a 'train' name, else 2,000).
    The shuffle is one permutation at construction from ``seed``, which
    ``reset()`` keeps, as MXNet's iter_mnist.cc does."""

    def __init__(self, image='train-images-idx3-ubyte',
                 label='train-labels-idx1-ubyte', batch_size=128,
                 shuffle=True, flat=False, silent=False, seed=0,
                 num_parts=1, part_index=0, input_shape=None, **kwargs):
        if os.path.exists(image) or os.path.exists(image + '.gz'):
            img_path = image if os.path.exists(image) else image + '.gz'
            lab_path = label if os.path.exists(label) else label + '.gz'
            images = _read_mnist_images(img_path).astype(np.float32) / 255.0
            labels = _read_mnist_labels(lab_path).astype(np.float32)
        else:
            images, labels = synthetic_mnist(
                12000 if 'train' in image else 2000, seed=seed)
        # the full set is kept only for a sharded iterator, whose
        # set_shard re-slices it
        self._shard_full = (images, labels) if num_parts > 1 else None
        self._shard_args = dict(batch_size=batch_size, shuffle=shuffle,
                                flat=flat, seed=seed)
        self._num_parts = int(num_parts)
        self._part_index = int(part_index)
        self._shard_init(images, labels)

    def _shard_init(self, images, labels):
        a = self._shard_args
        if self._num_parts > 1:
            images = images[self._part_index::self._num_parts]
            labels = labels[self._part_index::self._num_parts]
        if a['flat']:
            images = images.reshape(images.shape[0], -1)
        else:
            images = images.reshape(images.shape[0], 1, 28, 28)
        if a['shuffle']:
            perm = np.random.RandomState(a['seed']).permutation(len(labels))
            images, labels = images[perm], labels[perm]
        super().__init__(images, labels, batch_size=a['batch_size'],
                         shuffle=False, last_batch_handle='discard',
                         label_name='softmax_label')

    def shard_info(self):
        """(num_parts, part_index)."""
        return self._num_parts, self._part_index

    def set_shard(self, part_index):
        """Re-slice onto shard ``part_index`` of the same partition (a
        no-op on an unsharded iterator); callers apply it at an epoch
        boundary."""
        if self._shard_full is None:
            return
        self._part_index = int(part_index) % max(1, self._num_parts)
        self._shard_init(*self._shard_full)


class CSVIter(NDArrayIter):
    """Rows of a CSV file reshaped to ``data_shape``, labels from
    ``label_csv`` (zeros without it); the last batch padded
    (``round_batch``) or dropped."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, data_name='data',
                 label_name='softmax_label', **kwargs):
        data = np.loadtxt(data_csv, delimiter=',', dtype=np.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=',', dtype=np.float32)
            label = label.reshape((-1,) + tuple(label_shape))
            if tuple(label_shape) == (1,):
                label = label.reshape(-1)
        else:
            label = np.zeros(data.shape[0], dtype=np.float32)
        super().__init__(data, label, batch_size=batch_size,
                         last_batch_handle='pad' if round_batch else 'discard',
                         data_name=data_name, label_name=label_name)


class LibSVMIter(DataIter):
    """The libsvm text format as CSR batches.

    Each line is ``label [label...] idx:value idx:value ...`` (0-based
    indices). Batches come out as CSRNDArray data with dense labels, both
    on the current context (the card by default); an optional
    ``label_libsvm`` file gives multi-dimensional sparse labels, densified.
    With ``round_batch`` the last batch wraps around to the start and says
    so in its ``pad``."""

    def __init__(self, data_libsvm, data_shape, label_libsvm=None,
                 label_shape=None, batch_size=1, round_batch=True,
                 data_name='data', label_name='softmax_label', **kwargs):
        super().__init__(batch_size)
        self.data_shape = tuple(data_shape) if not isinstance(
            data_shape, int) else (data_shape,)
        ncol = int(np.prod(self.data_shape))
        rows, labels = self._parse(data_libsvm, ncol)
        self._csr = rows                     # scipy csr [N, ncol]
        if label_libsvm is not None:
            lab_ncol = int(np.prod(label_shape)) if label_shape else 1
            lab, _ = self._parse(label_libsvm, lab_ncol, labels_inline=False)
            self._labels = np.asarray(lab.todense(), np.float32)
        else:
            self._labels = np.asarray(labels, np.float32)
        self.num_data = self._csr.shape[0]
        if self.num_data < batch_size:
            raise ValueError('fewer rows (%d) than batch_size (%d)'
                             % (self.num_data, batch_size))
        self.round_batch = round_batch
        self.provide_data = [DataDesc(data_name,
                                      (batch_size,) + self.data_shape)]
        lshape = (batch_size,) if self._labels.ndim == 1 else \
            (batch_size,) + self._labels.shape[1:]
        self.provide_label = [DataDesc(label_name, lshape)]
        self.reset()

    @staticmethod
    def _parse(path, ncol, labels_inline=True):
        import scipy.sparse as sp
        data, indices, indptr, labels = [], [], [0], []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                i = 0
                if labels_inline:
                    labels.append(float(parts[0]))
                    i = 1
                for tok in parts[i:]:
                    idx, val = tok.split(':')
                    indices.append(int(idx))
                    data.append(float(val))
                indptr.append(len(data))
        mat = sp.csr_matrix(
            (np.asarray(data, np.float32),
             np.asarray(indices, np.int64), np.asarray(indptr, np.int64)),
            shape=(len(indptr) - 1, ncol))
        return mat, np.asarray(labels, np.float32)

    def reset(self):
        self._cursor = 0

    def iter_next(self):
        if self._cursor + self.batch_size <= self.num_data:
            return True
        if self.round_batch and self._cursor < self.num_data:
            return True
        return False

    def next(self):
        if not self.iter_next():
            raise StopIteration
        start = self._cursor
        stop = start + self.batch_size
        pad = 0
        if stop <= self.num_data:
            sub = self._csr[start:stop]
            lab = self._labels[start:stop]
        else:  # wrap around to the start
            pad = stop - self.num_data
            import scipy.sparse as sp
            sub = sp.vstack([self._csr[start:], self._csr[:pad]]).tocsr()
            lab = np.concatenate([self._labels[start:], self._labels[:pad]])
        self._cursor = stop
        data = csr_matrix((sub.data, sub.indices, sub.indptr),
                       shape=(self.batch_size,) + self.data_shape)
        return DataBatch(data=[data], label=[array(lab)], pad=pad,
                         index=None)

    def getpad(self):
        """0: the pad rides on each batch."""
        return 0


# ---------------------------------------------------------------------------
# record iterators
# ---------------------------------------------------------------------------

def _read_imgrec(path_imgrec, data_shape, scale, means, stds):
    """Decode every record of a file and normalise it: (data (N, C, H, W)
    f32, the raw labels)."""
    from ..recordio import MXRecordIO, unpack_img
    record = MXRecordIO(path_imgrec, 'r')
    images, labels = [], []
    try:
        while True:
            item = record.read()
            if item is None:
                break
            header, img = unpack_img(item, data_shape=tuple(data_shape))
            images.append(img)
            labels.append(header.label)
    finally:
        record.close()
    if not images:
        raise ValueError('empty record file %s' % path_imgrec)
    data = np.stack(images).astype(np.float32) * scale
    mean = np.asarray(means, dtype=np.float32).reshape(3, 1, 1)
    std = np.asarray(stds, dtype=np.float32).reshape(3, 1, 1)
    if data.shape[1] == 3:
        data = (data - mean) / std
    return data, labels


# the tag a device-augment generator folds into its seed, as the JAX
# package folds 0x41554721 into the step key
_AUG_TAG = 0x41554721


def aug_generator(device, seed):
    """The ``torch.Generator`` on ``device`` of the device augment of one
    batch whose seed (``random.next_seed()``) is ``seed``."""
    return _random.node_generator(device, seed, _AUG_TAG)


def _host_nd(a):
    return NDArray(torch.from_numpy(np.ascontiguousarray(a)), cpu())


def _upload(a, device):
    """A host numpy batch on ``device``, from pinned memory on the card."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == 'cuda':
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class ImageRecordIter(DataIter):
    """The RecordIO image pipeline of MXNet's iter_image_recordio_2.cc:
    a framing-only offset scan at construction, then a producer thread,
    ``preprocess_threads`` decode and augment workers and a queue of
    ``prefetch_buffer`` batches (:mod:`.image_record`). The augment (crop,
    mirror, scale jitter, pad) is per image, on the host, or on the
    device with ``device_augment`` (see the module's docstring)."""

    def __init__(self, path_imgrec, data_shape, batch_size, label_width=1,
                 shuffle=False, mean_r=0, mean_g=0, mean_b=0, std_r=1,
                 std_g=1, std_b=1, scale=1.0, rand_crop=False,
                 rand_mirror=False, preprocess_threads=4, round_batch=True,
                 prefetch_buffer=4, resize=-1, pad=0, fill_value=127,
                 max_random_scale=1.0, min_random_scale=1.0, num_parts=1,
                 part_index=0, data_name='data', label_name='softmax_label',
                 device_augment=None, host_crop=None, **kwargs):
        super().__init__(batch_size)
        from .image_record import StreamingImageRecordIter
        from ..config import flags
        self.data_shape = tuple(data_shape)
        self._data_name = data_name
        self._label_name = label_name
        self._label_width = label_width
        if device_augment is None:
            device_augment = flags.get('MXTPU_DEVICE_AUGMENT')
        self._device_augment = bool(int(device_augment or 0))
        if host_crop is None:
            host_crop = flags.get('MXTPU_HOST_CROP')
        self._host_crop = bool(int(host_crop or 0)) and self._device_augment
        self._aug_params = dict(
            scale=float(scale), mean=(mean_r, mean_g, mean_b),
            std=(std_r, std_g, std_b), rand_crop=bool(int(rand_crop)),
            rand_mirror=bool(int(rand_mirror)))
        self._aug_fn = None
        self._defer_aug = False
        self._stream = StreamingImageRecordIter(
            path_imgrec, self.data_shape, batch_size,
            label_width=label_width, shuffle=shuffle,
            mean=(mean_r, mean_g, mean_b), std=(std_r, std_g, std_b),
            scale=scale, rand_crop=rand_crop, rand_mirror=rand_mirror,
            preprocess_threads=preprocess_threads,
            prefetch_buffer=prefetch_buffer, round_batch=round_batch,
            resize=resize, pad=pad, fill_value=fill_value,
            max_random_scale=max_random_scale,
            min_random_scale=min_random_scale,
            num_parts=num_parts, part_index=part_index, aug_kwargs=kwargs,
            device_augment=self._device_augment, host_crop=self._host_crop)
        self._pending = None
        self._exhausted = False

    @property
    def provide_data(self):
        return [DataDesc(self._data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self._label_width == 1 else \
            (self.batch_size, self._label_width)
        return [DataDesc(self._label_name, shape)]

    def reset(self):
        self._stream.start_epoch()
        self._pending = None
        self._exhausted = False

    def shard_info(self):
        """(num_parts, part_index)."""
        return self._stream.num_parts, self._stream.part_index

    def set_shard(self, part_index):
        """Move onto another shard of the same partition, from the next
        reset()."""
        self._stream.set_shard(part_index)

    def next(self):
        if self._pending is not None:
            batch, self._pending = self._pending, None
            return batch
        if self._exhausted:
            raise StopIteration
        item = self._stream.next_batch()
        if item is None:
            self._exhausted = True
            raise StopIteration
        _tele.counter('io.batches').inc()
        data, label, pad = item
        if self._device_augment and self._defer_aug:
            # deferred (defer_device_aug): the raw uint8 batch and its
            # label on the host; the consumer applies device_aug_pure
            data_nd = _host_nd(data)
        elif self._device_augment:
            data_nd = self._apply_device_aug(data)
        else:
            data_nd = _host_nd(data)
        return DataBatch(data=[data_nd], label=[_host_nd(label)],
                         pad=pad, index=None,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def _apply_device_aug(self, data_u8):
        """(B, S, S, C) uint8 on the host -> the augmented (B, C, H, W) f32
        batch on the current context's device, its randomness from a
        generator there seeded by ``random.next_seed()``."""
        if self._aug_fn is None:
            self._aug_fn = self.device_aug_pure()
        ctx = current_context()
        dev = ctx.torch_device()
        out = self._aug_fn(_upload(data_u8, dev),
                           aug_generator(dev, _random.next_seed()))
        return NDArray(out, ctx)

    def device_aug_pure(self):
        """The device augment as a function ``(uint8 (B, Sh, Sw, C')
        tensor, torch.Generator on its device) -> f32 (B, C, H, W)`` on the
        batch's device: a random (or centre) crop unless the workers
        cropped already (``host_crop``), a mirror coin an image, then
        ``(x * scale - mean) / std`` in f32. The source's size is read off
        the batch, so one function serves any record geometry; the fused
        fit window calls it inside its steps (``defer_device_aug``)."""
        C, H, W = self.data_shape
        p = self._aug_params
        # a grayscale data_shape takes only the first channel's mean/std,
        # as the host's table does
        mean_c = tuple(float(v) for v in p['mean'][:C])
        std_c = tuple(float(v) for v in p['std'][:C])
        scale_v = float(p['scale'])
        rand_crop, rand_mirror = p['rand_crop'], p['rand_mirror']
        pre_cropped = self._host_crop
        consts = {}

        def per_channel(dev):
            # filled on the device, once a device: a copy of a host list
            # would synchronise the host with the card at every call
            got = consts.get(dev)
            if got is None:
                mean = torch.empty((C, 1, 1), dtype=torch.float32, device=dev)
                std = torch.empty((C, 1, 1), dtype=torch.float32, device=dev)
                for c in range(C):
                    mean[c].fill_(mean_c[c])
                    std[c].fill_(std_c[c])
                got = consts[dev] = (mean, std)
            return got

        def aug(batch, gen):
            B, Sh, Sw = batch.shape[0], int(batch.shape[1]), int(batch.shape[2])
            dev = batch.device
            if pre_cropped:
                imgs = batch
            elif rand_crop and (Sh > H or Sw > W):
                # each image its own offsets, over each axis independently
                ys = torch.randint(0, Sh - H + 1, (B,), generator=gen,
                                   device=dev)
                xs = torch.randint(0, Sw - W + 1, (B,), generator=gen,
                                   device=dev)
                rows = ys[:, None] + torch.arange(H, device=dev)
                cols = xs[:, None] + torch.arange(W, device=dev)
                b = torch.arange(B, device=dev)
                imgs = batch[b[:, None, None], rows[:, :, None],
                             cols[:, None, :], :C]
            else:
                y, x = (Sh - H) // 2, (Sw - W) // 2
                imgs = batch[:, y:y + H, x:x + W, :C]
            if rand_mirror:
                coins = torch.rand((B,), generator=gen, device=dev) < 0.5
                imgs = torch.where(coins[:, None, None, None],
                                   imgs.flip(2), imgs)
            mean, std = per_channel(dev)
            chw = imgs.permute(0, 3, 1, 2).to(torch.float32)
            return (chw * scale_v - mean) / std

        return aug

    def device_aug_signature(self):
        """A hashable description of the augment's arithmetic: iterators
        that agree on it give the same device_aug_pure function, so a fit
        window built for one serves the other; any difference (mean, std,
        scale, the random flags, the target shape, host_crop) keys a
        window of its own."""
        p = self._aug_params
        return ('image-record-aug', tuple(self.data_shape), p['scale'],
                tuple(p['mean']), tuple(p['std']),
                p['rand_crop'], p['rand_mirror'], self._host_crop)

    def defer_device_aug(self, on):
        """Switch the deferred augment (the fused fit window's protocol):
        while on, next() returns the RAW uint8 host batches and the
        consumer applies device_aug_pure() itself. Only meaningful in
        device-augment mode; returns whether the switch engaged. The
        consumer switches it off again in a ``finally``, so that the eval
        windows and the per-batch loops see augmented batches."""
        if not self._device_augment:
            return False
        self._defer_aug = bool(on)
        return True

    def iter_next(self):
        if self._pending is not None:
            return True
        if self._exhausted:
            return False
        try:
            self._pending = self.next()
            return True
        except StopIteration:
            return False


class ImageDetRecordIter(DataIter):
    """The detection RecordIO pipeline of MXNet's
    iter_image_det_recordio.cc over records packed with ``--pack-label``:
    label = [header_width, object_width, (extra header...), then one row
    of object_width values an object, by convention [class_id, xmin,
    ymin, xmax, ymax, ...]]. The labels are padded with
    ``label_pad_value`` to one dense (B, 2 + max_objects * object_width)
    block (at least ``label_pad_width`` wide)."""

    @staticmethod
    def _is_det_header(lab):
        """A packed detection header: [hdr_w >= 2, obj_w >= 1, ...] with a
        body of whole objects."""
        if lab.size < 2:
            return False
        hdr_w, ow = float(lab[0]), float(lab[1])
        if hdr_w < 2 or ow < 1 or hdr_w != int(hdr_w) or ow != int(ow):
            return False
        body = lab.size - int(hdr_w)
        return body >= 0 and body % int(ow) == 0

    def __init__(self, path_imgrec, data_shape, batch_size, label_width=-1,
                 label_pad_width=-1, label_pad_value=-1.0, shuffle=False,
                 mean_r=0, mean_g=0, mean_b=0, std_r=1, std_g=1, std_b=1,
                 scale=1.0, rand_mirror=False, round_batch=True, **kwargs):
        super().__init__(batch_size)
        self.data_shape = tuple(data_shape)
        data, raw_labels = _read_imgrec(path_imgrec, self.data_shape, scale,
                                        (mean_r, mean_g, mean_b),
                                        (std_r, std_g, std_b))
        parsed = []
        max_objs = 0
        obj_w = None
        for rec_i, lab in enumerate(raw_labels):
            lab = np.atleast_1d(np.asarray(lab, dtype=np.float32))
            if self._is_det_header(lab):
                ow = int(lab[1])
                body = lab[int(lab[0]):]
            else:  # a plain label row: one object
                ow = max(int(lab.size), 1)
                body = lab
            if obj_w is None:
                obj_w = ow
            elif ow != obj_w:
                raise ValueError(
                    'record %d: inconsistent object width: %d vs %d'
                    % (rec_i, ow, obj_w))
            objs = body.reshape(-1, obj_w) if body.size else \
                np.zeros((0, obj_w), np.float32)
            parsed.append(objs)
            max_objs = max(max_objs, objs.shape[0])
        # exactly label_pad_width wide (or wider if the data needs it), so
        # that train and val iterators built alike always match
        width = 2 + max_objs * obj_w
        if label_pad_width > 0:
            width = max(width, label_pad_width)
        self.label_object_width = obj_w
        self.max_objects = max_objs
        label = np.full((len(parsed), width), label_pad_value,
                        dtype=np.float32)
        label[:, 0] = 2.0
        label[:, 1] = float(obj_w)
        for i, objs in enumerate(parsed):
            label[i, 2:2 + objs.size] = objs.ravel()
        self._inner = NDArrayIter(
            data, label, batch_size=batch_size, shuffle=shuffle,
            last_batch_handle='pad' if round_batch else 'discard')
        self._rand_mirror = rand_mirror
        self._pad_value = label_pad_value

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def _mirror_batch(self, batch):
        """A horizontal flip with the boxes' x coordinates flipped
        (normalised [0, 1]: xmin' = 1 - xmax, xmax' = 1 - xmin)."""
        data = [d.flip(axis=3) if d.ndim == 4 else d for d in batch.data]
        labels = []
        for lab_nd in batch.label:
            lab = lab_nd.asnumpy().copy()
            ow = self.label_object_width
            if ow >= 5:
                # only the object-aligned block holds boxes; the cells of
                # a wider label_pad_width are padding
                end = 2 + self.max_objects * ow
                objs = lab[:, 2:end].reshape(lab.shape[0], -1, ow)
                valid = objs[:, :, 0] != self._pad_value
                xmin = objs[:, :, 1].copy()
                xmax = objs[:, :, 3].copy()
                objs[:, :, 1] = np.where(valid, 1.0 - xmax, objs[:, :, 1])
                objs[:, :, 3] = np.where(valid, 1.0 - xmin, objs[:, :, 3])
                lab[:, 2:end] = objs.reshape(lab.shape[0], -1)
            labels.append(array(lab, ctx=cpu()))
        return DataBatch(data, labels, batch.pad, batch.index,
                         provide_data=batch.provide_data,
                         provide_label=batch.provide_label)

    def next(self):
        batch = self._inner.next()
        if self._rand_mirror and _random.host_rng().rand() < 0.5:
            batch = self._mirror_batch(batch)
        return batch

    def iter_next(self):
        return self._inner.iter_next()


class MXDataIter(DataIter):
    """The handle-style protocol over an iterator object (MXNet's
    io.py wraps a ctypes DataIterHandle; here the handle is the iterator
    itself): next/getdata/getlabel/getpad with one buffered batch."""

    def __init__(self, handle, data_name='data',
                 label_name='softmax_label', **_):
        if not isinstance(handle, DataIter):
            raise TypeError('MXDataIter wraps a data-iterator handle; '
                            'got %r' % (handle,))
        super().__init__(getattr(handle, 'batch_size', 1))
        self.handle = handle
        self._debug_skip_load = False
        self.first_batch = handle.next()
        data = self.first_batch.data[0]
        self.provide_data = [DataDesc(data_name, data.shape, data.dtype)]
        if self.first_batch.label:
            label = self.first_batch.label[0]
            self.provide_label = [DataDesc(label_name, label.shape,
                                           label.dtype)]
        else:
            self.provide_label = []
        self._current = None

    def debug_skip_load(self):
        """Return the first batch again and again, without loading."""
        self._debug_skip_load = True

    def reset(self):
        self._current = None
        self.first_batch = None
        self.handle.reset()

    def next(self):
        if self._debug_skip_load and self.first_batch is not None:
            self._current = self.first_batch
            return self.first_batch
        if self.first_batch is not None:
            batch, self.first_batch = self.first_batch, None
            self._current = batch
            return batch
        self._current = self.handle.next()
        return self._current

    def iter_next(self):
        try:
            self.next()
            return True
        except StopIteration:
            self._current = None
            return False

    def getdata(self):
        return self._current.data[0]

    def getlabel(self):
        return self._current.label[0] if self._current.label else None

    def getindex(self):
        return getattr(self._current, 'index', None)

    def getpad(self):
        return getattr(self._current, 'pad', 0) or 0
