"""The fused W-step window of score, predict and iter_predict: the
counterpart of ``mxnet_tpu/module/fused_eval.py``.

The per-batch score and predict run one forward and one copy to the host a
batch. The window runs W forwards from one host call, with no host
synchronisation inside it, as the JAX package runs them in one XLA call
(here a Python loop over the steps, as ``fused_fit.py`` runs its window),
behind the unchanged score/predict/iter_predict:

- score: Accuracy, TopKAccuracy and CrossEntropy (and composites of them)
  are sufficient statistics computed on the card, one vector a step,
  fetched once a window; any other metric takes stacked-output mode, where
  the window stacks each step's outputs on the card, fetched once a
  window, and the metric's own update runs on the host as in the per-batch
  loop. Metric values and the batch_end_callback's cadence are the
  per-batch loop's; the callbacks fire in a burst after each window;
- predict / iter_predict: the window stacks the outputs, fetched once a
  window; each batch's pad rows are trimmed on the host where the
  per-batch loop slices them (axis 0, ``out[:shape[0] - pad]``). The
  outputs are NDArrays on the host (``cpu()``), as in the JAX package;
- results surface one window late: the host's fetch of window k overlaps
  window k+1's run, and the next window is drawn and uploaded meanwhile
  (``window_pipeline.WindowPipeline``);
- the tail (fewer than W batches, or a ``num_batch`` remainder) runs the
  per-batch path on batches rebuilt from the draw-time snapshots;
- nothing is written back: the parameters and aux states are read-only,
  as in the per-batch forward in prediction.

Eligibility (``build`` returns None and the per-batch loop runs): a plain
Module, one executor, shapes it can infer; stacked-output mode also needs
W stacked f32 outputs under 256 MB. MXTPU_FUSED_EVAL=0 turns the window
off; MXTPU_EVAL_STEPS_PER_CALL sets W (4 by default);
MXTPU_FUSED_EVAL_PREFETCH=0 uploads each window in turn.

Telemetry (``MXTPU_TELEMETRY=1``), with the JAX package's names: the
window's ``fused_eval.build``, ``fused_eval.draw``, ``fused_eval.put``,
``fused_eval.dispatch`` and ``fused_eval.fetch`` spans, the
``fused_eval.windows`` and ``eval.batches`` counters, the
``fused_eval.steps_per_call`` gauge and the watchdog's
``fused_eval.window`` mark; the tail batches take the per-batch loop's
``eval.*`` spans.

With the health sentinels on (``MXTPU_HEALTH``) each forward also computes
its row on the card (``telemetry.health.step_stats`` of the outputs: the
per-output finite flags; the norms are zero without gradients). The
window's (W, k) rows ride its one fetch (columns of the statistics matrix;
in stacked-output mode one more copy) and are checked with
``has_grads=False``, the bad step bisected on its draw-time batch in
prediction, as in the JAX loop.
"""
import logging

import numpy as np
import torch

from .. import random as _random
from .. import telemetry as _tele
from ..config import flags
from ..ndarray.ndarray import NDArray
from . import window_pipeline as _wp
from .window_pipeline import (WindowPipeline, host_wrap, plan_metric,
                              rebind_children, window_size)

__all__ = ['FusedEvalLoop']


def _eval_window():
    return window_size('MXTPU_EVAL_STEPS_PER_CALL')


def _enabled():
    flags.reload('MXTPU_FUSED_EVAL')
    return flags.get('MXTPU_FUSED_EVAL')


class FusedEvalLoop:
    """One W-step forward window driving score and predict. ``windows``
    and ``fetches`` count the windows run and the copies of their results
    to the host, over the loop's life."""

    def __init__(self, module, children, stat_fns, window):
        self.module = module
        self.children = children   # leaf metrics fed by the statistics
        self.stat_fns = stat_fns   # None: stacked-output mode
        self.window = window
        self._programs = {}
        e = module._exec_group.execs[0]
        self._exec = e
        self._arg_names = list(e._prog.arg_names)
        self._aux_names = list(e._prog.aux_names)
        self._pipe = WindowPipeline(window,
                                    device_fn=lambda: e._ctx.torch_device(),
                                    span_prefix='fused_eval')
        # the sentinels, decided at build (build_cached keys reuse on them)
        self._health_on = _tele.health.enabled()
        self._hk = _tele.health.N_FIXED + len(module._symbol.list_outputs())
        self.windows = 0
        self.fetches = 0

    # -- reuse across score()/predict() calls ------------------------------
    def _rebind_metric(self, eval_metric):
        self.children = rebind_children(eval_metric, self.children)

    @classmethod
    def build_cached(cls, module, eval_metric, logger=logging):
        """build(), but reuse the previous call's loop while the bound
        executor, W and (for score) the metric's configuration are
        unchanged. ``eval_metric=None`` is the predict form; score and
        predict cache in separate slots."""
        if not _enabled():
            module.__dict__.pop('_fused_eval_cache', None)
            return None
        kind = 'score' if eval_metric is not None else 'predict'
        eg = getattr(module, '_exec_group', None)
        execs = getattr(eg, 'execs', None) or []
        sig = None
        if len(execs) == 1 and not execs[0]._use_staged():
            if eval_metric is None:
                msig = '<predict>'
            else:
                from .fused_fit import FusedFitLoop
                msig = FusedFitLoop._metric_sig(eval_metric)
            if msig is not None:
                sig = (id(execs[0]), _eval_window(), msig,
                       bool(_tele.health.enabled()))
        cache = module.__dict__.get('_fused_eval_cache')
        if sig is None:
            # unsignable (several executors, a staged executor, or a metric
            # whose get_config raises): the per-batch loop
            if cache is not None:
                cache.pop(kind, None)
            return None
        cached = cache.get(kind) if cache is not None else None
        if cached is not None and cached[0] == sig:
            loop = cached[1]
            if eval_metric is not None:
                loop._rebind_metric(eval_metric)
            return loop
        loop = cls.build(module, eval_metric, logger=logger)
        if loop is not None:
            module.__dict__.setdefault('_fused_eval_cache', {})[kind] = \
                (sig, loop)
        elif cache is not None:
            cache.pop(kind, None)
        return loop

    # -- eligibility -------------------------------------------------------
    @staticmethod
    def build(module, eval_metric, logger=logging):
        if not _enabled():
            return None
        from .module import Module
        if type(module) is not Module:
            return None
        eg = module._exec_group
        if len(getattr(eg, 'execs', ())) != 1:
            return None
        if eg.execs[0]._use_staged():   # group2ctx, a monitor or a host op
            return None
        shapes = {d.name: d.shape for d in
                  list(module.data_shapes) + list(module.label_shapes or [])}
        try:
            _, out_shapes, _ = module._symbol.infer_shape(**shapes)
        except Exception:  # noqa: BLE001 — shapes it cannot infer
            return None
        if out_shapes is None:
            return None
        window = _eval_window()
        children, fns = None, None
        if eval_metric is not None:
            # plan_metric also holds the stats fns' output and label
            # geometry; other geometries take stacked-output mode
            plan = plan_metric(eval_metric, out_shapes,
                               module._label_names)
            if plan is not None:
                children, fns = plan
        if fns is None:
            est = 4 * window * sum(
                int(np.prod(s)) for s in out_shapes if s)
            if est > _wp.OUT_STACK_CAP:
                return None
        loop = FusedEvalLoop(module, children, fns, window)
        logger.info('fused eval window active: %d steps a host call%s',
                    window,
                    '' if fns is not None else ' (stacked-output mode)')
        return loop

    # -- program -----------------------------------------------------------
    def _program(self, snaps):
        """The window for the drawn batches' signature: one program per
        (shapes, labels present)."""
        has_labels = len(snaps[0][1]) > 0
        shapes_key = tuple((tuple(a.shape), str(a.dtype))
                           for a in snaps[0][0] + snaps[0][1])
        key = (has_labels, shapes_key)
        entry = self._programs.get(key)
        if entry is None:
            with _tele.span('fused_eval.build', 'fused_eval'):
                entry = self._build_program(has_labels)
            self._programs[key] = entry
        return entry

    def _build_program(self, has_labels):
        """``(window_fn(fixed, aux, data_stack, label_stack, seeds) -> ys,
        fixed_names)``."""
        run = self._exec._run
        arg_pos = {n: i for i, n in enumerate(self._arg_names)}
        data_names = list(self.module._data_names)
        label_names = list(self.module._label_names) if has_labels else []
        # a label that is an argument of the graph is fed to it; labels the
        # graph does not take still reach the stats fns
        fed_pairs = [(li, arg_pos[n]) for li, n in enumerate(label_names)
                     if n in arg_pos]
        io_pos = set(arg_pos[n] for n in data_names) | \
            set(ai for _, ai in fed_pairs)
        fixed_names = [n for i, n in enumerate(self._arg_names)
                       if i not in io_pos]
        stat_fns = self.stat_fns
        W = self.window
        health_on = self._health_on

        def window_fn(fixed, aux, data_stack, label_stack, seeds):
            ys, rows = [], []
            with torch.no_grad():
                for j in range(W):
                    datas = tuple(d[j] for d in data_stack)
                    labels = tuple(l[j] for l in label_stack)
                    full = [None] * len(arg_pos)
                    for n, v in zip(fixed_names, fixed):
                        full[arg_pos[n]] = v
                    for n, v in zip(data_names, datas):
                        full[arg_pos[n]] = v
                    for li, ai in fed_pairs:
                        full[ai] = labels[li]
                    outs, _ = run(tuple(full), aux, seeds[j], False)
                    if health_on:
                        rows.append(_tele.health.step_stats(outs))
                    if stat_fns is not None:
                        # every metric's statistics in one vector a step
                        ys.append(torch.stack([v for fn in stat_fns
                                               for v in fn(outs, labels)]))
                    else:
                        ys.append(outs)
                hmat = torch.stack(rows) if rows else None
                if stat_fns is not None:
                    ys = torch.stack(ys)
                    if hmat is not None:
                        # the rows ride the statistics' one copy
                        return torch.cat([ys, hmat], dim=1), None
                    return ys, None
                return tuple(torch.stack(o) for o in zip(*ys)), hmat

        return window_fn, fixed_names

    def _snapshot(self, fixed_names):
        e = self._exec
        fixed = tuple(e.arg_dict[n]._data for n in fixed_names)
        aux = tuple(e.aux_dict[n]._data for n in self._aux_names)
        return fixed, aux

    def _pool(self):
        flags.reload('MXTPU_FUSED_EVAL_PREFETCH')
        return self._pipe.pool() \
            if flags.get('MXTPU_FUSED_EVAL_PREFETCH') else None

    @staticmethod
    def _rebuild_batch(snap):
        """A per-batch DataBatch from a draw-time snapshot (the iterator's
        own buffers may hold later batches by now)."""
        from ..io import DataBatch
        ds, ls, pad, idx = snap
        return DataBatch(data=[NDArray(d) for d in ds],
                         label=[NDArray(l) for l in ls], pad=pad, index=idx)

    # -- the shared window drive -------------------------------------------
    def _drive(self, eval_data, num_batch):
        """The window loop of score and predict: yields ('window', pieces,
        win_snaps) for each window, one window late by design (the
        consumer's fetch overlaps the next window's run and upload), and
        ('tail', rebuilt_batch, snap) for each remaining batch."""
        it = iter(eval_data)
        pipe = self._pipe
        pool = self._pool()
        drawn_n = 0
        pending = None

        def collect():
            nonlocal drawn_n
            lim = None if num_batch is None else num_batch - drawn_n
            snaps, drawn = pipe.collect(it, limit=lim)
            drawn_n += len(snaps)
            return snaps, drawn

        snaps, drawn = collect()
        fut = pipe.start_put(snaps, drawn, pool) \
            if len(snaps) == self.window else None
        try:
            while len(snaps) == self.window:
                window_fn, fixed_names = self._program(snaps)
                fixed, aux = self._snapshot(fixed_names)
                seeds = [_random.next_seed() for _ in range(self.window)]
                with _tele.span('fused_eval.put', 'fused_eval'):
                    data_stack, label_stack = fut()
                with _tele.span('fused_eval.dispatch', 'fused_eval'):
                    pieces = window_fn(fixed, aux, data_stack, label_stack,
                                       seeds)
                self.windows += 1
                _tele.counter('fused_eval.windows').inc()
                _tele.counter('eval.batches').inc(self.window)
                # eval windows mark the watchdog too, or a long score
                # between epochs would trip it
                _tele.watchdog.note_progress('fused_eval.window')
                win_snaps = snaps
                snaps, drawn = collect()
                fut = pipe.start_put(snaps, drawn, pool) \
                    if len(snaps) == self.window else None
                if pending is not None:
                    yield ('window',) + pending
                pending = (pieces, win_snaps)
        finally:
            # an upload in flight is resolved before the teardown (or an
            # exception's or a closed generator's unwind) can race the
            # side thread
            if pool is not None:
                WindowPipeline.drain(fut)
            pipe.drop_cache()
        if pending is not None:
            yield ('window',) + pending
        for snap in snaps:
            yield ('tail', self._rebuild_batch(snap), snap)

    def _fetch(self, pieces, win_snaps, nbatch):
        """One copy of a window's results to the host: the statistics'
        (W, 2 * metrics) array, or each output's stack; then the sentinel
        rows' check (the bisect on the bad step's batch, in prediction)."""
        ys, hmat = pieces
        with _tele.span('fused_eval.fetch', 'fused_eval'):
            if self.stat_fns is not None:
                self.fetches += 1
                host = ys.cpu().numpy()
                if self._health_on:
                    host, hmat = host[:, :-self._hk], host[:, -self._hk:]
            else:
                self.fetches += len(ys) + (hmat is not None)
                host = [o.cpu() for o in ys]
                if hmat is not None:
                    hmat = hmat.cpu().numpy()
        if hmat is not None:
            _tele.health.note_window(
                hmat, source='fused_eval', nbatch_base=nbatch,
                has_grads=False,
                bisect=_wp.window_bisect(
                    self._exec, list(self.module._data_names),
                    list(self.module._label_names), win_snaps, False))
        return host

    # -- score -------------------------------------------------------------
    def run_score(self, eval_data, eval_metric, num_batch,
                  batch_end_callback, epoch):
        """The windowed score pass; returns the number of batches
        consumed."""
        from ..model import BatchEndParam
        from .base_module import _as_list

        m = self.module
        _tele.gauge('fused_eval.steps_per_call').set(self.window)
        nbatch = 0

        def fire_callback(nbatch):
            if batch_end_callback is not None:
                p = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                  eval_metric=eval_metric, locals=locals())
                for cb in _as_list(batch_end_callback):
                    cb(p)

        for kind, a, b in self._drive(eval_data, num_batch):
            if kind == 'tail':
                with _tele.span('eval.dispatch', 'eval'):
                    m.forward(a, is_train=False)
                with _tele.span('eval.metric', 'eval'):
                    m.update_metric(eval_metric, a.label)
                _tele.counter('eval.batches').inc()
                fire_callback(nbatch)
                nbatch += 1
                continue
            host = self._fetch(a, b, nbatch)
            for i, (_, ls, _, _) in enumerate(b):
                if self.stat_fns is not None:
                    for j, child in enumerate(self.children):
                        child.sum_metric += float(host[i, 2 * j])
                        child.num_inst += int(host[i, 2 * j + 1])
                else:
                    eval_metric.update([NDArray(l) for l in ls],
                                       [host_wrap(o[i]) for o in host])
                fire_callback(nbatch)
                nbatch += 1
        return nbatch

    # -- predict / iter_predict --------------------------------------------
    def iter_windows(self, eval_data, num_batch):
        """The windowed generator behind predict and iter_predict: yields
        (outputs, nbatch, batch) a batch, as iter_predict does, fetching a
        window at a time. The outputs are NDArrays on the host, trimmed of
        the pad rows where the per-batch loop trims them (axis 0)."""
        m = self.module
        _tele.gauge('fused_eval.steps_per_call').set(self.window)
        nbatch = 0
        for kind, a, b in self._drive(eval_data, num_batch):
            if kind == 'tail':
                with _tele.span('eval.dispatch', 'eval'):
                    m.forward(a, is_train=False)
                pad = a.pad or 0
                with _tele.span('eval.fetch', 'eval'):
                    # on the host like the windowed outputs, so that
                    # predict's merge never joins across devices
                    outputs = [host_wrap(
                        out._data[0:out.shape[0] - pad].cpu())
                        for out in m.get_outputs()]
                _tele.counter('eval.batches').inc()
                yield outputs, nbatch, a
                nbatch += 1
                continue
            outs_host = self._fetch(a, b, nbatch)
            for i, snap in enumerate(b):
                pad = snap[2] or 0
                outputs = [host_wrap(o[i][0:o[i].shape[0] - pad])
                           for o in outs_host]
                yield outputs, nbatch, self._rebuild_batch(snap)
                nbatch += 1
