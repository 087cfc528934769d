"""Serving engine: the batching contract of ``mxnet_tpu/serving/engine.py``
over a torch forward.

Request sizes are arbitrary, so the engine keeps a BUCKET LADDER of batch
sizes (powers of two up to ``max_batch``): every request pads with zero
rows up to the smallest covering bucket, a request larger than the
largest bucket is cut into chunks, and pad rows are stripped from the
outputs on axis 0 before they leave the engine. Fixed shapes keep the
device's work, and the memory it allocates, to a few known sizes, which
:meth:`ServingEngine.warmup` runs once each ahead of traffic.

The JAX engine serves a bound ``Module``. This one takes a torch forward
(for example :class:`~mxnet_tpu_torch.transformer.TransformerLM`) and the
data descriptors that a bound Module would carry: name, per-example shape
and dtype. A constructor that takes a ``Module`` comes with the port's
Module slice. The JAX engine's telemetry spans are not ported yet.
"""
import logging
import time

import ml_dtypes
import numpy as np
import torch

from ..config import flags
from ..context import as_torch_device

__all__ = ['ServingEngine', 'bucket_ladder']


def bucket_ladder(max_batch):
    """Powers of two up to ``max_batch`` (inclusive when it is one,
    appended when it is not), ascending."""
    max_batch = int(max_batch)
    if max_batch < 1:
        raise ValueError('max_batch must be >= 1, got %d' % max_batch)
    ladder = []
    b = 1
    while b <= max_batch:
        ladder.append(b)
        b *= 2
    if ladder[-1] != max_batch:
        ladder.append(max_batch)
    return ladder


def _serve_max_batch():
    flags.reload('MXTPU_SERVE_MAX_BATCH')
    return flags.get('MXTPU_SERVE_MAX_BATCH')


class ServingEngine:
    """Bucketed inference over one torch forward.

    ``forward(*inputs)`` takes one batched tensor per data descriptor, on
    ``device``, and returns a tensor or a tuple of tensors whose axis 0 is
    the batch. ``data_descs`` is a list of ``(name, per_example_shape,
    dtype)``. ``device`` defaults to the current context (the card); the
    forward runs under ``torch.inference_mode``.
    """

    def __init__(self, forward, data_descs, output_names=('output',),
                 max_batch=None, device=None, name='model', logger=logging):
        self.forward = forward
        self._descs = [(str(n), tuple(int(d) for d in shape), np.dtype(dt))
                       for n, shape, dt in data_descs]
        if not self._descs:
            raise ValueError('ServingEngine needs at least one data input')
        self._data_names = [n for n, _, _ in self._descs]
        self.output_names = list(output_names)
        self.device = as_torch_device(device)
        self.max_batch = int(max_batch) if max_batch else _serve_max_batch()
        self.buckets = bucket_ladder(self.max_batch)
        self.name = name
        self.logger = logger
        self.warmed = False

    def bucket_for(self, rows):
        """Smallest bucket covering ``rows`` (chunk first when rows exceed
        the largest bucket)."""
        for b in self.buckets:
            if b >= rows:
                return b
        raise ValueError('rows=%d exceeds the largest bucket %d — '
                         'chunk via dispatch_rows()' % (rows,
                                                        self.buckets[-1]))

    # -- dispatch ----------------------------------------------------------
    def _check_and_cast(self, arrays):
        if not isinstance(arrays, (list, tuple)):
            arrays = [arrays]
        if len(arrays) != len(self._descs):
            raise ValueError('expected %d input arrays (%s), got %d'
                             % (len(self._descs), ', '.join(self._data_names),
                                len(arrays)))
        out = []
        for (n, want, dtype), a in zip(self._descs, arrays):
            a = np.asarray(a, dtype=dtype)
            if tuple(a.shape[1:]) != want:
                raise ValueError('input %r: per-example shape %s does not '
                                 'match the bound %s'
                                 % (n, tuple(a.shape[1:]), want))
            out.append(a)
        rows = out[0].shape[0]
        if rows == 0:
            raise ValueError('empty request (0 rows)')
        if any(a.shape[0] != rows for a in out):
            raise ValueError('input arrays disagree on the row count')
        return out, rows

    def _dispatch_chunk(self, arrays, rows, timings=None):
        bucket = self.bucket_for(rows)
        t0 = time.perf_counter()
        padded = []
        for a in arrays:
            if rows < bucket:
                a = np.concatenate(
                    [a, np.zeros((bucket - rows,) + a.shape[1:], a.dtype)])
            padded.append(torch.from_numpy(np.ascontiguousarray(a))
                          .to(self.device))
        t1 = time.perf_counter()
        with torch.inference_mode():
            outs = self.forward(*padded)
        if isinstance(outs, torch.Tensor):
            outs = (outs,)
        if timings is not None:
            timings['pad_ms'] = timings.get('pad_ms', 0.0) + (t1 - t0) * 1e3
            timings['dispatch_ms'] = timings.get('dispatch_ms', 0.0) \
                + (time.perf_counter() - t1) * 1e3
        return tuple(outs), rows, bucket

    def dispatch_rows(self, arrays, timings=None):
        """Launch the forward for ``arrays`` without waiting for the device
        (row counts beyond the largest bucket are chunked across several
        calls). Returns a list of (device_outputs, rows, bucket) chunks;
        hand them to :meth:`fetch_chunks`. ``timings`` (a dict, optional)
        accumulates the host-measured ``pad_ms`` / ``dispatch_ms``."""
        arrays, rows = self._check_and_cast(arrays)
        chunks = []
        off = 0
        while off < rows:
            take = min(rows - off, self.buckets[-1])
            chunks.append(self._dispatch_chunk(
                [a[off:off + take] for a in arrays], take, timings=timings))
            off += take
        return chunks

    def fetch_chunks(self, chunks, timings=None):
        """Copy the chunks of one :meth:`dispatch_rows` call to the host
        with pad rows stripped: one numpy array per output, rows in
        request order, in the output's own dtype (bfloat16 as
        ``ml_dtypes.bfloat16``, bit for bit). ``timings`` accumulates the
        blocking ``fetch_ms``."""
        t0 = time.perf_counter()
        per_out = None
        for outs, rows, _bucket in chunks:
            host = []
            for o in outs:
                o = o[:rows].cpu()
                if o.dtype == torch.bfloat16:
                    host.append(o.view(torch.int16).numpy()
                                .view(ml_dtypes.bfloat16))
                else:
                    host.append(o.numpy())
            if per_out is None:
                per_out = [[h] for h in host]
            else:
                for acc, h in zip(per_out, host):
                    acc.append(h)
        if timings is not None:
            timings['fetch_ms'] = timings.get('fetch_ms', 0.0) \
                + (time.perf_counter() - t0) * 1e3
        return [np.concatenate(parts) if len(parts) > 1 else parts[0]
                for parts in per_out]

    def infer(self, arrays):
        """Synchronous predict: pad to the bucket, run, strip. Returns one
        array per output, each with exactly the request's row count."""
        return self.fetch_chunks(self.dispatch_rows(arrays))

    # -- warmup ------------------------------------------------------------
    def warmup(self, buckets=None):
        """Run every bucket once on zeros (kernel builds, library handles
        and the allocator's blocks are then in place before traffic).
        Returns the number of buckets warmed."""
        warmed = 0
        for b in (buckets or self.buckets):
            zeros = [np.zeros((b,) + shape, dtype)
                     for _, shape, dtype in self._descs]
            self.fetch_chunks([self._dispatch_chunk(zeros, b)])
            warmed += 1
        self.warmed = True
        self.logger.info('serving engine %s: %d buckets warm (ladder %s)',
                         self.name, warmed, self.buckets)
        return warmed

    def describe(self):
        """The /models payload for this engine."""
        return {
            'name': self.name,
            'buckets': list(self.buckets),
            'max_batch': self.max_batch,
            'inputs': [{'name': n, 'shape': list(shape), 'dtype': str(dt)}
                       for n, shape, dt in self._descs],
            'outputs': list(self.output_names),
            'warmed': bool(self.warmed),
        }
