"""Serving engine, the counterpart of ``mxnet_tpu/serving/engine.py``:
a checkpoint or a torch forward -> bucketed inference.

Request sizes are arbitrary, so the engine keeps a BUCKET LADDER of batch
sizes (powers of two up to ``max_batch``): every request pads with zero
rows up to the smallest covering bucket, a request larger than the
largest bucket is cut into chunks, and pad rows are stripped from the
outputs on axis 0 before they leave the engine. Fixed shapes keep the
device's work, and the memory it allocates, to a few known sizes, which
:meth:`ServingEngine.warmup` runs once each ahead of traffic.

:class:`ServingEngine` takes a bound ``Module``, as the JAX engine does
(a plain single-executor Module with its parameters, bound at the
largest bucket; :meth:`ServingEngine.from_checkpoint` loads and binds
one, on the card by default). Each bucket's program is the executor's
runner (``executor._GraphProgram.make_runner``) over a cached snapshot of
the parameters, run with ``is_train=False``: the math ``Module.predict``
runs, so a full-bucket request answers bit for bit as ``Module.predict``
at the same batch size. Smaller buckets run the same runner on fewer rows
(the graph is per example at inference: BatchNorm uses its moving
statistics); on the card cuDNN and cuBLAS may pick other algorithms for
another row count, so those answers agree with ``Module.predict`` to
rounding. A program is built once per bucket, under a ``serve.build``
span: after :meth:`~ServingEngine.warmup` no request builds one.

:meth:`ServingEngine.from_forward` serves a bare torch forward (for
example :class:`~mxnet_tpu_torch.transformer.TransformerLM`) under the
same contract, given the data descriptors a bound Module would carry.

``_SingleExecutorEngine`` holds what the engine shares with
:class:`~.step_cache.DecodeEngine` (the module's eligibility, the program
a bucket, the parameter snapshot), as the JAX package's does.

The dispatch runs under ``torch.inference_mode`` with the engine's device
named in the calling thread (both are per thread in torch, and the
batcher dispatches from a thread of its own). On the card each dispatch
records a CUDA event that :meth:`~ServingEngine.fetch_chunks` waits on
before it copies, so the fetch may run on another thread without a
device-wide synchronise.
"""
import contextlib
import logging
import re
import threading
import time

import ml_dtypes
import numpy as np
import torch

from .. import random as _random
from .. import telemetry as _tele
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


def _scope_name(name):
    """The JAX package's ``telemetry.programs.scope_name``: a symbol name
    with everything but [A-Za-z0-9_.-] replaced."""
    return re.sub(r'[^A-Za-z0-9_.\-]', '_', str(name)) or '_'


class _Outputs(tuple):
    """One dispatch's device outputs, with the CUDA event recorded after
    its launches (None on the CPU)."""
    ready = None


class _SingleExecutorEngine:
    """What :class:`ServingEngine` and :class:`~.step_cache.DecodeEngine`
    share: the module's eligibility (a plain single-executor Module with
    no host ops, bound with its parameters; an engine raises where the
    module does not fit, it never falls back), the program built once per
    bucket, the cached parameter snapshot, and the engine's card named in
    the calling thread."""

    _default_name = 'model'

    def __init__(self, module, logger=logging, name=None):
        from ..module.module import Module
        cls = type(self).__name__
        if type(module) is not Module:
            raise ValueError('%s needs a plain Module, got %s'
                             % (cls, type(module).__name__))
        assert module.binded and module.params_initialized, \
            'bind the module (for_training=False) and load params first'
        execs = getattr(module._exec_group, 'execs', ())
        if len(execs) != 1:
            raise ValueError('%s needs a single-executor module (one '
                             'context)' % cls)
        e = execs[0]
        if e._monitor is not None or e._group2ctx is not None:
            raise ValueError('%s cannot serve a staged/monitored module'
                             % cls)
        self.module = module
        self._exec = e
        self._arg_names = list(e._prog.arg_names)
        self._aux_names = list(e._prog.aux_names)
        self._snap = None          # cached (fixed, aux) parameter snapshot
        self._snap_lock = threading.Lock()
        self._base(e._ctx.torch_device(),
                   name or _scope_name(getattr(module._symbol, 'name', None)
                                       or self._default_name), logger)

    def _base(self, device, name, logger):
        self.device = device
        self.name = name
        self.logger = logger
        self._programs = {}        # bucket -> program
        self._build_lock = threading.Lock()

    def _program(self, bucket):
        with self._build_lock:
            prog = self._programs.get(bucket)
            if prog is None:
                with _tele.span('serve.build', 'serve'):
                    prog = self._build_program(bucket)
                self._programs[bucket] = prog
        return prog

    def _snapshot(self, fixed_names):
        """Parameter and aux tensors in program order, cached — serving
        parameters are immutable between :meth:`refresh_params` calls."""
        with self._snap_lock:
            if self._snap is None:
                e = self._exec
                self._snap = (
                    tuple(e.arg_dict[n]._data for n in fixed_names),
                    tuple(e.aux_dict[n]._data for n in self._aux_names))
            return self._snap

    def refresh_params(self):
        """Drop the cached parameter snapshot (after set_params or a hot
        reload); the next dispatch re-reads the executor's arrays. The
        bucket programs stay built."""
        if self.module is not None:
            with self._snap_lock:
                self._snap = None

    def _on_device(self):
        """Name the engine's card in the calling thread (torch's current
        device is per thread)."""
        if self.device.type == 'cuda':
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()


def _to_host(o):
    """A device tensor as a numpy array in its own dtype (bfloat16 as
    ``ml_dtypes.bfloat16``, bit for bit)."""
    o = o.cpu()
    if o.dtype == torch.bfloat16:
        return o.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return o.numpy()


class ServingEngine(_SingleExecutorEngine):
    """Bucketed inference over one bound Module.

    The module must be plain (single executor, no host ops) and bound at
    the largest bucket's batch size with parameters loaded, for inference
    (``for_training=False``; the JAX engine, like this one, does not check
    that flag: the forward runs with ``is_train=False`` either way).
    """

    def __init__(self, module, max_batch=None, logger=logging, name=None):
        super().__init__(module, logger=logger, name=name)
        descs = [(d.name, tuple(d.shape[1:]),
                  np.dtype(getattr(d, 'dtype', None) or np.float32))
                 for d in module.data_shapes]
        self._setup(descs, module.output_names, max_batch)

    def _setup(self, descs, output_names, max_batch):
        self._descs = descs
        if not descs:
            raise ValueError('ServingEngine needs at least one data input')
        self._data_names = [n for n, _, _ in descs]
        self.output_names = list(output_names)
        self.max_batch = int(max_batch) if max_batch else _serve_max_batch()
        self.buckets = bucket_ladder(self.max_batch)
        self.warmed = False

    # -- the two ways in ---------------------------------------------------
    @classmethod
    def from_checkpoint(cls, prefix, epoch, data_shapes, context=None,
                        max_batch=None, logger=logging, **module_kwargs):
        """``Module.load`` + inference bind + engine in one step, on
        ``context`` (default ``gpu(0)``; the JAX engine's is the CPU).

        ``data_shapes``: [(name, per_example_shape)] WITHOUT the batch
        dimension — the engine owns batching. Label variables a training
        graph carries (e.g. ``softmax_label``) are bound as plain zero
        arrays, exactly like a predict-bound module (``label_names=[]``);
        the ``is_train=False`` forward never reads them."""
        from .. import context as ctx_mod
        from ..module.module import Module
        data_shapes = [(n, tuple(s)) for n, s in data_shapes]
        max_b = int(max_batch) if max_batch else _serve_max_batch()
        mod = Module.load(prefix, epoch,
                          data_names=[n for n, _ in data_shapes],
                          label_names=[], context=context or ctx_mod.gpu(0),
                          logger=logger, **module_kwargs)
        mod.bind(data_shapes=[(n, (max_b,) + s) for n, s in data_shapes],
                 for_training=False)
        return cls(mod, max_batch=max_b, logger=logger)

    @classmethod
    def from_forward(cls, forward, data_descs, output_names=('output',),
                     max_batch=None, device=None, name='model',
                     logger=logging):
        """An engine over a torch forward: ``forward(*inputs)`` takes one
        batched tensor per data descriptor, on ``device``, and returns a
        tensor or a tuple of tensors whose axis 0 is the batch.
        ``data_descs`` is a list of ``(name, per_example_shape, dtype)``.
        ``device`` defaults to the current context (the card)."""
        self = cls.__new__(cls)
        self.module = None
        self.forward = forward
        self._base(as_torch_device(device), name, logger)
        self._setup([(str(n), tuple(int(d) for d in shape), np.dtype(dt))
                     for n, shape, dt in data_descs], output_names,
                    max_batch)
        return self

    # -- programs ----------------------------------------------------------
    def _build_program(self, bucket):
        if self.module is None:
            return self.forward
        run = self._exec._prog.make_runner()
        arg_pos = {n: i for i, n in enumerate(self._arg_names)}
        data_pos = [arg_pos[n] for n in self._data_names]
        fixed_names = [n for n in self._arg_names
                       if n not in self._data_names]
        fixed_pos = [arg_pos[n] for n in fixed_names]

        def program(*datas):
            fixed, aux = self._snapshot(fixed_names)
            full = [None] * len(arg_pos)
            for i, v in zip(fixed_pos, fixed):
                full[i] = v
            for i, v in zip(data_pos, datas):
                full[i] = v
            outs, _ = run(tuple(full), aux, _random.next_seed(), False)
            return outs
        return program

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
        prog = self._program(bucket)
        with self._on_device(), torch.inference_mode():
            t0 = time.perf_counter()
            padded = []
            for a in arrays:
                if rows < bucket:
                    a = np.concatenate(
                        [a, np.zeros((bucket - rows,) + a.shape[1:],
                                     a.dtype)])
                padded.append(torch.from_numpy(np.ascontiguousarray(a))
                              .to(self.device))
            t1 = time.perf_counter()
            _tele.histogram('serve.pad').observe((t1 - t0) * 1e3)
            with _tele.span('serve.dispatch', 'serve'):
                outs = prog(*padded)
            outs = _Outputs((outs,) if isinstance(outs, torch.Tensor)
                            else outs)
            if self.device.type == 'cuda':
                outs.ready = torch.cuda.Event()
                outs.ready.record()
        if timings is not None:
            timings['pad_ms'] = timings.get('pad_ms', 0.0) + (t1 - t0) * 1e3
            timings['dispatch_ms'] = timings.get('dispatch_ms', 0.0) \
                + (time.perf_counter() - t1) * 1e3
        return outs, rows, bucket

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
        with self._on_device(), _tele.span('serve.fetch', 'serve'):
            for outs, rows, _bucket in chunks:
                if getattr(outs, 'ready', None) is not None:
                    outs.ready.synchronize()
                host = [_to_host(o[:rows]) for o in outs]
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
        """Build every bucket's program and run it once on zeros (kernel
        builds, library handles and the allocator's blocks are then in
        place before traffic): no request builds a program after this.
        Sets the ``serve.buckets_warm`` gauge; returns the number of
        buckets warmed."""
        warmed = 0
        for b in (buckets or self.buckets):
            zeros = [np.zeros((b,) + shape, dtype)
                     for _, shape, dtype in self._descs]
            self.fetch_chunks([self._dispatch_chunk(zeros, b)])
            warmed += 1
        self.warmed = True
        _tele.gauge('serve.buckets_warm').set(warmed)
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
