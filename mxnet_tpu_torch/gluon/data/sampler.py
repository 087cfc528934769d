"""Gluon's samplers: the counterpart of ``mxnet_tpu/gluon/data/sampler.py``.
``RandomSampler`` shuffles with the port's host stream
(``random.host_rng()``), so ``random.seed(s)`` gives the JAX package's
order."""
import numpy as np

from ... import random as _random

__all__ = ['Sampler', 'SequentialSampler', 'RandomSampler', 'BatchSampler']


class Sampler:
    """An iterable of sample indices."""

    def __iter__(self):
        raise NotImplementedError()

    def __len__(self):
        raise NotImplementedError()


class SequentialSampler(Sampler):
    """0, 1, ..., length - 1."""

    def __init__(self, length):
        self._length = length

    def __iter__(self):
        return iter(range(self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    """A permutation of range(length), drawn anew at each pass."""

    def __init__(self, length):
        self._length = length

    def __iter__(self):
        indices = np.arange(self._length)
        _random.host_rng().shuffle(indices)
        return iter(indices)

    def __len__(self):
        return self._length


class BatchSampler(Sampler):
    """``sampler``'s indices in batches of ``batch_size``; the last short
    batch is kept ('keep'), dropped ('discard') or carried into the next
    pass ('rollover')."""

    def __init__(self, sampler, batch_size, last_batch='keep'):
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == 'keep':
                yield batch
            elif self._last_batch == 'discard':
                return
            elif self._last_batch == 'rollover':
                self._prev = batch
            else:
                raise ValueError(
                    "last_batch must be one of 'keep', 'discard', or "
                    "'rollover', but got %s" % self._last_batch)

    def __len__(self):
        if self._last_batch == 'keep':
            return (len(self._sampler) + self._batch_size - 1) // self._batch_size
        if self._last_batch == 'discard':
            return len(self._sampler) // self._batch_size
        if self._last_batch == 'rollover':
            return (len(self._prev) + len(self._sampler)) // self._batch_size
        raise ValueError(
            "last_batch must be one of 'keep', 'discard', or 'rollover', "
            "but got %s" % self._last_batch)
