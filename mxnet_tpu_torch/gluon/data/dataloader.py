"""Gluon's DataLoader: the counterpart of
``mxnet_tpu/gluon/data/dataloader.py``. A batch is a CPU NDArray (or a
list of them), as the port's iterators give; ``gluon.utils.split_and_load``
moves it to the card."""
import numpy as np

from ... import ndarray as nd
from ...context import cpu
from ...ndarray import NDArray
from . import sampler as _sampler

__all__ = ['DataLoader', 'default_batchify_fn']


def default_batchify_fn(data):
    """Stack a list of samples into a batch: NDArrays by ``nd.stack``,
    tuples element by element, anything else through numpy."""
    if isinstance(data[0], NDArray):
        return nd.stack(*data)
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_batchify_fn(i) for i in data]
    data = np.asarray(data)
    return nd.array(data, ctx=cpu())


class DataLoader:
    """Batches of a dataset, drawn through a sampler (sequential, or
    random with ``shuffle``) and a BatchSampler (``last_batch`` 'keep',
    'discard' or 'rollover'), stacked by ``batchify_fn``. The workers of
    ``num_workers`` are not used: the batches are made on the caller's
    thread, as in the JAX package."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError('batch_size must be specified unless '
                                 'batch_sampler is specified')
            if sampler is None:
                if shuffle:
                    sampler = _sampler.RandomSampler(len(dataset))
                else:
                    sampler = _sampler.SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError('shuffle must not be specified if sampler is '
                                 'specified')
            batch_sampler = _sampler.BatchSampler(
                sampler, batch_size, last_batch if last_batch else 'keep')
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError('batch_size, shuffle, sampler and last_batch must '
                             'not be specified if batch_sampler is specified.')
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn

    def __iter__(self):
        for batch in self._batch_sampler:
            yield self._batchify_fn([self._dataset[idx] for idx in batch])

    def __len__(self):
        return len(self._batch_sampler)
