"""Bucketed sequence iterators: the counterpart of ``mxnet_tpu/rnn/io.py``
(reference python/mxnet/rnn/io.py): ``encode_sentences`` and
``BucketSentenceIter``, which assigns sentences to length buckets and feeds
BucketingModule.

The shuffles draw on the framework's host streams
(:func:`..random.host_pyrng`, :func:`..random.host_rng`), so one
``mx.random.seed`` gives the same batches in the same order in both
packages. Batches are CPU NDArrays, as every iterator of :mod:`..io`
yields.
"""
import bisect

import numpy as np

from ..io import DataIter, DataBatch, DataDesc
from .. import random as _random
from ..context import cpu
from ..ndarray import array

# framework-private stdlib-style stream: mx.random.seed controls it,
# user-global `random` state is untouched
random = _random.host_pyrng()

__all__ = ['encode_sentences', 'BucketSentenceIter']


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key='\n', start_label=0):
    """Map token sequences to integer-id sequences, growing ``vocab``
    (only when it was not supplied) as new tokens appear.
    Reference rnn/io.py:29."""
    grow = vocab is None
    if grow:
        vocab = {invalid_key: invalid_label}
    next_id = start_label
    encoded = []
    for sentence in sentences:
        ids = []
        for token in sentence:
            if token not in vocab:
                if not grow:
                    raise AssertionError('Unknown token %s' % token)
                if next_id == invalid_label:
                    next_id += 1   # never hand out the padding id
                vocab[token] = next_id
                next_id += 1
            ids.append(vocab[token])
        encoded.append(ids)
    return encoded, vocab


def _default_buckets(sentences, batch_size):
    """One bucket per sentence length that can fill a batch."""
    counts = np.bincount([len(s) for s in sentences])
    return [length for length, n in enumerate(counts) if n >= batch_size]


class BucketSentenceIter(DataIter):
    """Pads each sentence to the smallest bucket that fits it; batches
    are drawn bucket-by-bucket so every batch has one static shape
    (``bucket_key``). Labels are the data shifted left by one with
    ``invalid_label`` at the end. Reference rnn/io.py:70."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name='data', label_name='softmax_label', dtype='float32',
                 layout='NT'):
        super().__init__()
        self.batch_size = batch_size
        self.buckets = sorted(buckets or
                              _default_buckets(sentences, batch_size))
        self.data_name, self.label_name = data_name, label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.layout = layout
        self.major_axis = layout.find('N')
        if self.major_axis not in (0, 1):
            raise ValueError('Invalid layout %s: Must by NT (batch major) or'
                             ' TN (time major)' % layout)
        self.default_bucket_key = max(self.buckets)

        # pad each sentence into the smallest bucket that holds it;
        # longer-than-every-bucket sentences are dropped
        per_bucket = [[] for _ in self.buckets]
        for sentence in sentences:
            which = bisect.bisect_left(self.buckets, len(sentence))
            if which == len(self.buckets):
                continue
            row = np.full((self.buckets[which],), invalid_label, dtype=dtype)
            row[:len(sentence)] = sentence
            per_bucket[which].append(row)
        # an empty bucket's asarray is 1-D (0,); give it the (0, length)
        # shape so reset()'s label[:, :-1] slicing stays valid (the
        # reference never hits this — PTB fills every default bucket)
        self.data = [np.asarray(rows, dtype=dtype) if rows else
                     np.empty((0, length), dtype=dtype)
                     for rows, length in zip(per_bucket, self.buckets)]

        batch_shape = self._oriented((batch_size, self.default_bucket_key))
        self.provide_data = [DataDesc(name=data_name, shape=batch_shape,
                                      layout=layout)]
        self.provide_label = [DataDesc(name=label_name, shape=batch_shape,
                                       layout=layout)]

        # (bucket, row-offset) of every full batch
        self.idx = [(b, start)
                    for b, rows in enumerate(self.data)
                    for start in range(0, len(rows) - batch_size + 1,
                                       batch_size)]
        self.nddata = []
        self.ndlabel = []
        self.curr_idx = 0
        self.reset()

    def _oriented(self, nt_shape):
        """(N, T) -> layout order."""
        return nt_shape if self.major_axis == 0 else nt_shape[::-1]

    def reset(self):
        self.curr_idx = 0
        random.shuffle(self.idx)
        for rows in self.data:
            _random.host_rng().shuffle(rows)
        self.nddata = list(self.data)
        self.ndlabel = []
        for rows in self.data:
            shifted = np.empty_like(rows)
            shifted[:, :-1] = rows[:, 1:]
            shifted[:, -1] = self.invalid_label
            self.ndlabel.append(shifted)

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        bucket, start = self.idx[self.curr_idx]
        self.curr_idx += 1

        rows = slice(start, start + self.batch_size)
        data_np = self.nddata[bucket][rows]
        label_np = self.ndlabel[bucket][rows]
        if self.major_axis == 1:   # time-major
            data_np, label_np = data_np.T, label_np.T
        data = array(data_np, ctx=cpu())
        label = array(label_np, ctx=cpu())
        return DataBatch([data], [label], pad=0,
                         bucket_key=self.buckets[bucket],
                         provide_data=[DataDesc(name=self.data_name,
                                                shape=data.shape,
                                                layout=self.layout)],
                         provide_label=[DataDesc(name=self.label_name,
                                                 shape=label.shape,
                                                 layout=self.layout)])
