"""The fused W-step window of Module.fit: the counterpart of
``mxnet_tpu/module/fused_fit.py``.

The JAX package compiles a window of W training steps into one XLA call
(``lax.scan``). The port has no tracing compiler to hand the window to, so
it runs the window as a Python loop over its W steps, issued from one host
call with no host synchronisation inside it, behind the unchanged
``Module.fit``:

- each step runs the graph forward through the executor's
  ``_GraphProgram`` runner, differentiates it by torch autograd under
  all-ones head gradients (the JAX body's ``jax.vjp``), and updates each
  parameter with the registered fused update op that its optimizer's plan
  names (SGD and ccSGD, multi-precision included, NAG, Adam, RMSProp in
  both forms, Ftrl), with the plan's static attrs and state order;
- lr and wd enter as (W, n) f32 arrays sampled on the host ahead of the
  window, one row a step, so a scheduler boundary inside a window and
  Adam's per-update-count bias correction are exact. The JAX body's traced
  f32 lr promotes the update of a half-precision weight to f32, and the
  result is cast back to the weight's type; the port hands each step's lr
  and wd to the op as f32 tensors on the weight's device, which its update
  ops promote beside as jnp does (``ops/optimizer_ops._k``), and casts
  back the same way;
- BatchNorm's aux states and, for ``grad_req='add'``, the gradient
  accumulators carry from step to step;
- metrics: Accuracy, TopKAccuracy and CrossEntropy (and composites of
  them) are sufficient statistics computed on the card
  (``window_pipeline.plan_metric``), fetched once a window and applied one
  window late; any other metric takes host-metric mode, where the window
  keeps each step's outputs on the card, fetched once a window, and the
  metric's own ``update`` replays them on the host. Either way the metric
  values and the batch_end_callback's cadence are the per-batch loop's;
  the callbacks fire in a burst after each window;
- the next window's batches are drawn and uploaded while this window runs
  (``window_pipeline.WindowPipeline``), and the tail batches (fewer than
  W) run through the per-batch loop;
- the deferred device augment: an iterator that takes
  ``defer_device_aug(True)`` (``ImageRecordIter`` in device-augment mode)
  hands over its raw uint8 batches, which the window stacks and uploads
  in one copy (a quarter of the f32 bytes), and each step applies the
  iterator's ``device_aug_pure`` on the card before the graph. Each step
  draws its augment's seed and then its run's seed from the per-run
  stream, the order in which the per-batch loop draws them (the eager
  augment at the draw, the executor at the forward), so the window sees
  the per-batch loop's batches; the tail batches take the eager augment.
  The switch is flipped back in a ``finally``, and the window's key
  carries ``device_aug_signature()``: iterators with another mean, std,
  scale, flags or shape never share a window.

Eligibility (``build`` returns None and fit runs the per-batch loop, as in
the JAX package): a plain Module, one executor, ``grad_req`` 'write' or
'add' without ``inputs_need_grad``, an optimizer with a plan, and no
kvstore or a 'local' or 'device' one; host-metric mode also needs W
stacked f32 outputs under 256 MB. Once a window is built, an error inside
it raises: nothing reruns its batches one at a time.

Telemetry (``MXTPU_TELEMETRY=1``), with the JAX package's names: the
window's ``fused_fit.build``, ``fused_fit.draw``, ``fused_fit.put``,
``fused_fit.dispatch`` and ``fused_fit.fetch`` spans, the ``fit.steps`` (W
a window) and ``fused_fit.windows`` counters, the
``fused_fit.steps_per_call`` gauge, the ``fused_fit.overlap_ms`` histogram
(the upload's time hidden under host work), the watchdog's
``fused_fit.window`` mark and the profiler's and step timeline's step
counts (W a window); the tail batches take the per-batch loop's marks.
The spans time the host: ``fused_fit.dispatch`` is the window's launches,
and the device's time lands in the next ``fused_fit.fetch`` that waits
for it.

Not ported: the sharded (ZeRO) update and the compressed gradients with
their ``update.*`` and ``comm.*`` gauges (ROADMAP.md §1 item 11), faults
and the checkpointer hook (item 12), the health and dynamics sentinels and
the run ledger (item 13). Without a mesh the JAX loop's ``_prepare_tail``
has nothing to do, and it is left out.

Flags: MXTPU_FUSED_FIT=0 turns the window off; MXTPU_FIT_STEPS_PER_CALL
sets W (4 by default); MXTPU_FUSED_FIT_PREFETCH=0 uploads each window in
turn; MXTPU_FUSED_FIT_TIMING=1 logs each epoch's host stages.
"""
import logging
import math
import time
import weakref

import numpy as np
import torch

from .. import metric as metric_mod
from .. import optimizer as opt_mod
from .. import profiler as _profiler
from .. import random as _random
from .. import telemetry as _tele
from ..config import flags
from ..executor import mirror_wrap
from ..io import aug_generator
from ..kvstore import _updater_key
from ..ndarray.ndarray import NDArray
from ..ops import registry as _reg
from ..optimizer import _as_clip, _is_half
from . import window_pipeline as _wp
from .window_pipeline import (WindowPipeline, host_wrap, rebind_children,
                              window_size)
from .window_pipeline import plan_metric as _metric_plan

__all__ = ['FusedFitLoop']


def _window_size():
    return window_size('MXTPU_FIT_STEPS_PER_CALL')


def _flag(name):
    flags.reload(name)
    return flags.get(name)


def updater_obj(module):
    """The updater that holds the module's optimizer states (the
    kvstore's under update_on_kvstore, else the module's own)."""
    return module._kvstore._updater if module._update_on_kvstore \
        else module._updater


def updater_keys(module, grad_names):
    """The key each parameter updates under, as in the per-batch path: by
    name on the kvstore's updater, by position on the local one
    (``model._update_params``)."""
    if module._update_on_kvstore:
        return {n: _updater_key(n) for n in grad_names}
    pnames = module._exec_group.param_names
    return {n: pnames.index(n) for n in grad_names}


def ensure_opt_states(module, grad_names, upd_keys, arg_dict):
    """Make the optimizer states through the optimizer's own
    ``create_state_multi_precision`` (the per-batch loop makes them at
    their first update), so that the window and the per-batch loop see the
    same structure. Returns the updater."""
    upd = updater_obj(module)
    for n in grad_names:
        key = upd_keys[n]
        if key not in upd.states:
            upd.states[key] = \
                module._optimizer.create_state_multi_precision(
                    key, arg_dict[n])
            upd.states_synced[key] = True
    return upd


# ---------------------------------------------------------------------------
# optimizer plans: one registered fused update op per optimizer
# ---------------------------------------------------------------------------

class _OptPlan:
    """One optimizer's update() as its registered fused op: the op's
    choice, the static attrs, the host-side lr transform (Adam's bias
    correction) and the state <-> op-input order. Every fused update op
    returns (new_weight, *new_states) with the states in input order."""

    supports_mp = False

    def __init__(self, opt):
        self.opt = opt

    _clip = staticmethod(_as_clip)

    def lr_wd(self, index):
        """(lr, wd) of the current update count of ``index`` (call right
        after _update_count, as update() does)."""
        return self.opt._get_lr(index), self.opt._get_wd(index)

    def state_arrays(self, st):
        """The optimizer state as tensors in the op's input order."""
        if st is None:
            return []
        if isinstance(st, tuple):
            return [s._data for s in st]
        return [st._data]

    def writeback_state(self, st, arrays):
        if st is None:
            return
        if isinstance(st, tuple):
            for s, a in zip(st, arrays):
                s._data = a
        else:
            st._data = arrays[0]


class _SGDPlan(_OptPlan):
    supports_mp = True

    def mode(self, weight_dtype):
        """SGD.update_multi_precision's op choice."""
        mp = self.opt.multi_precision and _is_half(weight_dtype)
        mom = self.opt.momentum != 0.0
        return ('mp_' if mp else '') + ('sgd_mom_update' if mom
                                        else 'sgd_update')

    def static_attrs(self):
        o = self.opt
        return {'momentum': o.momentum, 'rescale_grad': o.rescale_grad,
                'clip_gradient': self._clip(o.clip_gradient)}

    def state_arrays(self, st):
        if isinstance(st, tuple):           # multi-precision (w32, mom)
            w32, mom = st
            if mom is None:
                return [w32._data]          # mp_sgd_update(..., weight32)
            return [mom._data, w32._data]   # mp_sgd_mom_update(.., mom, w32)
        return [st._data] if st is not None else []

    def writeback_state(self, st, arrays):
        if isinstance(st, tuple):
            w32, mom = st
            if mom is None:
                w32._data = arrays[0]
            else:
                mom._data = arrays[0]
                w32._data = arrays[1]
        elif st is not None:
            st._data = arrays[0]


class _NAGPlan(_SGDPlan):
    supports_mp = False

    def mode(self, weight_dtype):
        return ('nag_mom_update' if self.opt.momentum != 0.0
                else 'sgd_update')


class _AdamPlan(_OptPlan):
    def mode(self, weight_dtype):
        return 'adam_update'

    def static_attrs(self):
        o = self.opt
        return {'beta1': o.beta1, 'beta2': o.beta2, 'epsilon': o.epsilon,
                'rescale_grad': o.rescale_grad,
                'clip_gradient': self._clip(o.clip_gradient)}

    def lr_wd(self, index):
        """Adam.update's bias correction of this update count, folded into
        the step's lr on the host."""
        o = self.opt
        lr, wd = o._get_lr(index), o._get_wd(index)
        t = o._index_update_count[index]
        lr *= math.sqrt(1. - o.beta2 ** t) / (1. - o.beta1 ** t)
        return lr, wd


class _RMSPropPlan(_OptPlan):
    def mode(self, weight_dtype):
        return ('rmspropalex_update' if self.opt.centered
                else 'rmsprop_update')

    def static_attrs(self):
        o = self.opt
        attrs = {'gamma1': o.gamma1, 'epsilon': o.epsilon,
                 'rescale_grad': o.rescale_grad,
                 'clip_gradient': self._clip(o.clip_gradient),
                 'clip_weights': self._clip(o.clip_weights)}
        if o.centered:
            attrs['gamma2'] = o.gamma2
        return attrs


class _FtrlPlan(_OptPlan):
    def mode(self, weight_dtype):
        return 'ftrl_update'

    def static_attrs(self):
        o = self.opt
        return {'lamda1': o.lamda1, 'beta': o.beta,
                'rescale_grad': o.rescale_grad,
                'clip_gradient': self._clip(o.clip_gradient)}


def _opt_plan(opt):
    """The plan of this optimizer's exact type, or None (the per-batch
    loop): a subclass that overrides update() must not take its base's
    fused form."""
    table = {opt_mod.SGD: _SGDPlan, opt_mod.ccSGD: _SGDPlan,
             opt_mod.NAG: _NAGPlan, opt_mod.Adam: _AdamPlan,
             opt_mod.RMSProp: _RMSPropPlan, opt_mod.Ftrl: _FtrlPlan}
    cls = table.get(type(opt))
    return cls(opt) if cls is not None else None


class FusedFitLoop:
    """One W-step training window driving Module's state. ``windows``,
    ``tail_batches`` and ``fetches`` count, over the loop's life, the
    windows run, the batches run through the per-batch loop after them and
    the copies of window results to the host."""

    def __init__(self, module, children, stat_fns, window, oplan):
        self.module = module
        self.children = children
        self.stat_fns = stat_fns
        self.window = window
        self._programs = {}
        e = module._exec_group.execs[0]
        self._exec = e
        self._arg_names = list(e._prog.arg_names)
        self._aux_names = list(e._prog.aux_names)
        self._grad_names = list(e._grad_names)
        io_names = set(module._data_names) | set(module._label_names)
        self._carry_names = [n for n in self._arg_names if n not in io_names]
        self._carry_pos = {n: i for i, n in enumerate(self._carry_names)}
        self._optimizer = module._optimizer
        self._plan = oplan  # the instance build() checked eligibility on
        self._accum = (module._grad_req == 'add')
        self._pipe = WindowPipeline(window,
                                    device_fn=lambda: e._ctx.torch_device(),
                                    span_prefix='fused_fit')
        self._upd_keys = updater_keys(module, self._grad_names)
        ensure_opt_states(module, self._grad_names, self._upd_keys,
                          e.arg_dict)
        # the deferred augment's function of each iterator, while it
        # lives, and the one of the epoch that runs (None: no defer)
        self._defer_fns = weakref.WeakKeyDictionary()
        self._defer_fn = None
        self.windows = 0
        self.tail_batches = 0
        self.fetches = 0

    # -- reuse across fit() calls ------------------------------------------
    @staticmethod
    def _metric_sig(eval_metric):
        """The metric configuration's value signature (class and every
        distinguishing kwarg, through get_config); None = never reuse."""
        if isinstance(eval_metric, metric_mod.CompositeEvalMetric):
            leaves = list(eval_metric.metrics)
        else:
            leaves = [eval_metric]
        try:
            return repr([sorted(m.get_config().items(), key=str)
                         for m in leaves])
        except Exception:  # noqa: BLE001 — a custom metric w/o get_config
            return None

    def _rebind_metric(self, eval_metric):
        self.children = rebind_children(eval_metric, self.children)

    @classmethod
    def build_cached(cls, module, eval_metric, logger=logging):
        """build(), but reuse the previous fit() call's loop, with its
        window programs, while what they were built on is unchanged: the
        bound executor, the optimizer instance, grad_req, the kvstore
        mode, W, the recompute flag and an equal-config metric (an
        epoch-at-a-time driver calls fit once an epoch)."""
        if not _flag('MXTPU_FUSED_FIT'):
            module.__dict__.pop('_fused_fit_cache', None)
            return None
        eg = getattr(module, '_exec_group', None)
        execs = getattr(eg, 'execs', None) or []
        sig = None
        if len(execs) == 1 and not execs[0]._use_staged():
            # a monitor installed between fit() calls invalidates the
            # cached loop, as build() declines it: the per-batch loop is
            # the one that calls the monitor
            msig = cls._metric_sig(eval_metric)
            if msig is not None:
                sig = (id(execs[0]), id(module._optimizer),
                       repr(module._grad_req),
                       bool(module._update_on_kvstore),
                       getattr(module._kvstore, 'type', None),
                       _window_size(), str(_flag('MXTPU_BACKWARD_DO_MIRROR')),
                       msig)
        cached = module.__dict__.get('_fused_fit_cache')
        if cached is not None and sig is not None and cached[0] == sig:
            loop = cached[1]
            loop._rebind_metric(eval_metric)
            return loop
        loop = cls.build(module, eval_metric, logger=logger)
        if loop is not None and sig is not None:
            module.__dict__['_fused_fit_cache'] = (sig, loop)
        else:
            module.__dict__.pop('_fused_fit_cache', None)
        return loop

    # -- eligibility -------------------------------------------------------
    @staticmethod
    def build(module, eval_metric, logger=logging):
        if not _flag('MXTPU_FUSED_FIT'):
            return None
        from .module import Module
        if type(module) is not Module:
            return None
        eg = module._exec_group
        if len(getattr(eg, 'execs', ())) != 1:
            return None
        e = eg.execs[0]
        if e._use_staged():     # group2ctx, a monitor or a host op
            return None
        if module._grad_req not in ('write', 'add') \
                or module.inputs_need_grad:
            return None
        opt = module._optimizer
        oplan = _opt_plan(opt)
        if oplan is None:
            return None
        if not oplan.supports_mp and opt.multi_precision and any(
                _is_half(e.arg_dict[n].dtype) for n in e._grad_names):
            return None  # the master-weight form is planned for SGD only
        kv = module._kvstore
        if kv is not None and kv.type not in ('local', 'device'):
            return None
        shapes = {d.name: d.shape for d in
                  list(module.data_shapes) + list(module.label_shapes or [])}
        try:
            _, out_shapes, _ = module._symbol.infer_shape(**shapes)
        except Exception:  # noqa: BLE001 — shapes it cannot infer
            return None
        if out_shapes is None:
            return None
        window = _window_size()
        # plan_metric also holds the stats fns' output and label geometry;
        # other geometries take host-metric mode
        plan = _metric_plan(eval_metric, out_shapes, module._label_names)
        if plan is not None:
            children, fns = plan
        else:
            est = 4 * window * sum(
                int(np.prod(s)) for s in out_shapes if s)
            if est > _wp.OUT_STACK_CAP:
                return None
            children, fns = None, None
        loop = FusedFitLoop(module, children, fns, window, oplan)
        logger.info('fused fit window active: %d steps a host call%s',
                    loop.window,
                    '' if fns is not None else ' (host-metric mode)')
        return loop

    # -- optimizer state ---------------------------------------------------
    def _state_arrays(self, n):
        st = updater_obj(self.module).states[self._upd_keys[n]]
        return self._plan.state_arrays(st)

    def _writeback_state(self, n, arrays):
        st = updater_obj(self.module).states[self._upd_keys[n]]
        self._plan.writeback_state(st, arrays)

    # -- program -----------------------------------------------------------

    def _sample_window_lr(self):
        """Advance the optimizer's update counts batch by batch, as the
        per-batch loop's update() calls would, and return (W, n) f32 lr and
        wd arrays with the value the updater would use at each batch of
        the window."""
        o = self._optimizer
        n = len(self._grad_names)
        lr = np.empty((self.window, n), np.float32)
        wd = np.empty((self.window, n), np.float32)
        for w in range(self.window):
            for j, name in enumerate(self._grad_names):
                idx = self._upd_keys[name]
                o._update_count(idx)
                lr[w, j], wd[w, j] = self._plan.lr_wd(idx)
        return lr, wd

    def _lr_tensors(self, lr, wd):
        """The window's lr and wd rows on the device, in one copy from
        pinned memory on the card."""
        both = torch.from_numpy(np.stack([lr, wd]))
        dev = self._exec._ctx.torch_device()
        if dev.type == 'cuda':
            both = both.pin_memory().to(dev, non_blocking=True)
        return both[0], both[1]

    def _build_program(self, static_attrs):
        """``window_fn(params, states, aux, gaccs, data_stack, label_stack,
        seeds, lr, wd, aug_seeds) -> (params, states, aux, gaccs, ys)``: the
        W steps of the window, ``ys`` the (W, 2 * metrics) statistics or,
        in host-metric mode, each output stacked over the steps. Under the
        deferred device augment (``self._defer_fn``, set by run_epoch) each
        step first turns its raw first input into the graph's with that
        function and a generator seeded by its entry of ``aug_seeds``."""
        run = mirror_wrap(self._exec._run)
        arg_pos = {n: i for i, n in enumerate(self._arg_names)}
        data_names = list(self.module._data_names)
        label_names = list(self.module._label_names)
        carry_names = self._carry_names
        grad_names = self._grad_names
        grad_carry_idx = [self._carry_pos[n] for n in grad_names]
        grad_arg_pos = [arg_pos[n] for n in grad_names]
        modes = {n: self._plan.mode(self._exec.arg_dict[n].dtype)
                 for n in grad_names}
        ops = {mode: _reg.get(mode).fn for mode in set(modes.values())}
        stat_fns = self.stat_fns
        accum = self._accum
        n_args = len(arg_pos)
        W = self.window
        defer_fn = self._defer_fn

        def step(params, states, aux, gaccs, datas, labels, seed, lr_row,
                 wd_row, aug_seed):
            if defer_fn is not None:
                datas = (defer_fn(datas[0], aug_generator(datas[0].device,
                                                          aug_seed)),) \
                    + tuple(datas[1:])
            full = [None] * n_args
            for n, v in zip(carry_names, params):
                full[arg_pos[n]] = v
            for n, v in zip(data_names, datas):
                full[arg_pos[n]] = v
            for n, v in zip(label_names, labels):
                full[arg_pos[n]] = v
            wrt = []                # None: an argument without a gradient
            for i in grad_arg_pos:
                if full[i].is_floating_point():
                    full[i] = full[i].detach().requires_grad_()
                    wrt.append(full[i])
                else:
                    wrt.append(None)
            with torch.enable_grad():
                outs, new_aux = run(tuple(full), aux, seed, True)
            # the JAX body's vjp with all-ones head gradients
            pairs = [o for o in outs if o.requires_grad]
            leaves = [w for w in wrt if w is not None]
            got = iter(torch.autograd.grad(
                pairs, leaves, [torch.ones_like(o) for o in pairs],
                allow_unused=True) if pairs and leaves
                else [None] * len(leaves))
            grads = []
            for j, w in enumerate(wrt):
                p = params[grad_carry_idx[j]]
                g = next(got) if w is not None else None
                grads.append(torch.zeros_like(p) if g is None
                             else g.to(p.dtype))
            if accum:
                # grad_req='add': the per-batch loop accumulates into the
                # gradient arrays and never clears them
                grads = [ga + g for ga, g in zip(gaccs, grads)]
                gaccs = tuple(grads)
            new_params = list(params)
            new_states = list(states)
            with torch.no_grad():
                for j, n in enumerate(grad_names):
                    ci = grad_carry_idx[j]
                    attrs = dict(static_attrs)
                    attrs['lr'] = lr_row[j]
                    attrs['wd'] = wd_row[j]
                    w, st = params[ci], states[j]
                    res = ops[modes[n]](attrs, w, grads[j], *st)
                    if not isinstance(res, tuple):
                        res = (res,)
                    # the f32 lr and wd promote a half-precision update to
                    # f32, as in the JAX window: back to each input's type
                    ins = (w,) + tuple(st)
                    res = tuple(r.to(i.dtype) if r.dtype != i.dtype else r
                                for r, i in zip(res, ins))
                    new_params[ci] = res[0]
                    if len(res) > 1:
                        new_states[j] = tuple(res[1:])
                outs = tuple(o.detach() for o in outs)
                if stat_fns is not None:
                    # every metric's statistics in one vector a step, so
                    # that the host fetches a window's once
                    ys = torch.stack([v for fn in stat_fns
                                      for v in fn(outs, labels)])
                else:
                    ys = outs
            return tuple(new_params), tuple(new_states), tuple(new_aux), \
                gaccs, ys

        def window_fn(params, states, aux, gaccs, data_stack, label_stack,
                      seeds, lr, wd, aug_seeds=None):
            ys = []
            for j in range(W):
                params, states, aux, gaccs, y = step(
                    params, states, aux, gaccs,
                    tuple(d[j] for d in data_stack),
                    tuple(l[j] for l in label_stack), seeds[j], lr[j], wd[j],
                    aug_seeds[j] if aug_seeds is not None else None)
                ys.append(y)
            if stat_fns is not None:
                ys = torch.stack(ys)
            else:
                ys = tuple(torch.stack(o) for o in zip(*ys))
            return params, states, aux, gaccs, ys

        return window_fn

    # -- per-epoch drive ---------------------------------------------------
    def _snapshot(self):
        e = self._exec
        params = tuple(e.arg_dict[n]._data for n in self._carry_names)
        states = tuple(tuple(self._state_arrays(n))
                       for n in self._grad_names)
        aux = tuple(e.aux_dict[n]._data for n in self._aux_names)
        gaccs = tuple(e.grad_dict[n]._data for n in self._grad_names) \
            if self._accum else ()
        return params, states, aux, gaccs

    def _writeback(self, params, states, aux, gaccs):
        e = self._exec
        m = self.module
        for n, v in zip(self._carry_names, params):
            e.arg_dict[n]._data = v
        for n, st in zip(self._grad_names, states):
            self._writeback_state(n, list(st))
            if m._update_on_kvstore:
                # the kvstore's copy, which pull reads
                store = m._kvstore._store.get(n)
                if store is not None:
                    store._data = e.arg_dict[n]._data
        for n, v in zip(self._aux_names, aux):
            e.aux_dict[n]._data = v
        if self._accum:
            for n, v in zip(self._grad_names, gaccs):
                e.grad_dict[n]._data = v
        m._params_dirty = True

    def run_epoch(self, train_data, eval_metric, epoch, batch_end_callback):
        """Run one epoch; returns the number of batches consumed. The
        tail batches (fewer than W) run through the per-batch loop: the
        state is written back after every window, so the two interleave."""
        from ..model import BatchEndParam
        from .base_module import _as_list

        def apply_stats(pieces, labels_w, nbatch):
            """One copy of the window's results to the host, then each
            batch's metric update and callbacks: the statistics' sums into
            the metric's children, or (host-metric mode) the metric's own
            update on each step's outputs against the draw-time labels."""
            with _tele.span('fused_fit.fetch', 'fused_fit'):
                # the window's one copy to the host: the host waits here
                # for the window's device work
                if self.stat_fns is not None:
                    host = pieces.cpu().numpy()     # (W, 2 * n_metrics)
                    self.fetches += 1
                    steps = host.shape[0]
                else:
                    outs_host = [o.cpu() for o in pieces]   # (W, ...)
                    self.fetches += len(outs_host)
                    steps = outs_host[0].shape[0]
            for i in range(steps):
                if self.stat_fns is not None:
                    for j, child in enumerate(self.children):
                        child.sum_metric += float(host[i, 2 * j])
                        child.num_inst += int(host[i, 2 * j + 1])
                else:
                    eval_metric.update(labels_w[i],
                                       [host_wrap(o[i]) for o in outs_host])
                if batch_end_callback is not None:
                    p = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                      eval_metric=eval_metric,
                                      locals=locals())
                    for cb in _as_list(batch_end_callback):
                        cb(p)
                nbatch += 1
            return nbatch

        # the deferred device augment: raw uint8 batches, augmented inside
        # the steps (one function an iterator, kept while it lives)
        defer_switch = getattr(train_data, 'defer_device_aug', None)
        self._defer_fn = None
        defer_sig = False
        if callable(defer_switch) and defer_switch(True):
            fn = self._defer_fns.get(train_data)
            if fn is None:
                fn = self._defer_fns[train_data] = \
                    train_data.device_aug_pure()
            self._defer_fn = fn
            sig_fn = getattr(train_data, 'device_aug_signature', None)
            # the augment's arithmetic is part of the window: its key
            # carries the configuration (an unsigned iterator keys by the
            # live function, held by the key itself)
            defer_sig = sig_fn() if callable(sig_fn) \
                else ('defer-unsigned', fn)
        else:
            defer_switch = None
        try:
            return self._run_epoch_inner(train_data, eval_metric, epoch,
                                         batch_end_callback, apply_stats,
                                         defer_sig)
        finally:
            if defer_switch is not None:
                defer_switch(False)
                self._defer_fn = None
            # the loop outlives fit() (build_cached): drop the last
            # window's device stacks and the strong references of its key
            self._pipe.drop_cache()

    def _run_epoch_inner(self, train_data, eval_metric, epoch,
                         batch_end_callback, apply_stats, defer_sig):
        from ..io import DataBatch
        from ..model import BatchEndParam
        from .base_module import _as_list
        m = self.module
        _tele.gauge('fused_fit.steps_per_call').set(self.window)
        tl_on = _tele.timeline.enabled()
        nbatch = 0
        pending = None
        it = iter(train_data)
        # MXTPU_FUSED_FIT_TIMING=1: the epoch's host stages; wall time
        # beyond them is device time the host did not hide
        timing = bool(_flag('MXTPU_FUSED_FIT_TIMING'))
        tm = {'draw': 0.0, 'put': 0.0, 'dispatch': 0.0, 'fetch': 0.0}
        clk = time.perf_counter
        ep_t0 = clk()
        pipe = self._pipe
        pool = pipe.pool() if _flag('MXTPU_FUSED_FIT_PREFETCH') else None

        def collect():
            t = clk()
            got = pipe.collect(it)
            tm['draw'] += clk() - t
            return got

        snaps, drawn = collect()
        if not snaps:
            # exhausted before the first batch: the per-batch loop's first
            # next() raises here, so the window does too (a score or
            # predict pass leaves the iterator drained until reset())
            raise StopIteration(
                'training iterator is exhausted at epoch start — reset() it '
                '(a score()/predict pass leaves the iterator drained, as in '
                'the per-batch fit loop)')
        fut = pipe.start_put(snaps, drawn, pool) \
            if len(snaps) == self.window else None
        try:
            while len(snaps) == self.window:
                # one program per (static attrs, shapes); lr and wd are
                # arrays of each window
                static_attrs = self._plan.static_attrs()
                attrs_key = tuple(sorted(static_attrs.items()))
                shapes_key = tuple((tuple(d.shape), str(d.dtype))
                                   for d in snaps[0][0])
                prog_key = (attrs_key, shapes_key, defer_sig)
                if prog_key not in self._programs:
                    with _tele.span('fused_fit.build', 'fused_fit'):
                        self._programs[prog_key] = self._build_program(
                            static_attrs)
                window_fn = self._programs[prog_key]
                # host-metric mode: the draw-time labels for the deferred
                # eval_metric.update
                labels_snap = None
                if self.stat_fns is None:
                    labels_snap = [[NDArray(l) for l in ls]
                                   for _, ls, _, _ in snaps]
                params, states, aux, gaccs = self._snapshot()
                # the optimizer's host work runs before the wait for the
                # upload, which it hides under
                lr_arr, wd_arr = self._sample_window_lr()
                # with the deferred augment, each step's augment seed and
                # then its run seed: the per-batch loop's order
                aug_seeds = None
                if self._defer_fn is not None:
                    pairs = [(_random.next_seed(), _random.next_seed())
                             for _ in range(self.window)]
                    aug_seeds = [a for a, _ in pairs]
                    seeds = [r for _, r in pairs]
                else:
                    seeds = [_random.next_seed()
                             for _ in range(self.window)]
                t = clk()
                with _tele.span('fused_fit.put', 'fused_fit'):
                    data_stack, label_stack = fut()
                if pool is not None:
                    _tele.histogram('fused_fit.overlap_ms').observe(
                        fut.hidden_ms)
                tm['put'] += clk() - t
                t = clk()
                with _tele.span('fused_fit.dispatch', 'fused_fit'):
                    lr, wd = self._lr_tensors(lr_arr, wd_arr)
                    params, states, aux, gaccs, pieces = window_fn(
                        params, states, aux, gaccs, data_stack, label_stack,
                        seeds, lr, wd, aug_seeds)
                    self._writeback(params, states, aux, gaccs)
                self.windows += 1
                _tele.counter('fit.steps').inc(self.window)
                _tele.counter('fused_fit.windows').inc()
                # the watchdog's mark: one window issued (a wedged device
                # shows at the next put or fetch, which then stops marking)
                _tele.watchdog.note_progress('fused_fit.window')
                # the MXTPU_XPROF step window, in whole windows
                _profiler.note_step(self.window)
                tm['dispatch'] += clk() - t
                # the device runs this window while the host draws the next
                # one (its upload starts on the side thread) and fetches
                # the previous window's results: callbacks run one window
                # late, with unchanged values and cadence
                snaps, drawn = collect()
                fut = pipe.start_put(snaps, drawn, pool) \
                    if len(snaps) == self.window else None
                t = clk()
                if pending is not None:
                    nbatch = apply_stats(pending[0], pending[1], nbatch)
                pending = (pieces, labels_snap)
                if tl_on:
                    # the step timeline: a whole window of steps
                    _tele.timeline.note_step(self.window)
                tm['fetch'] += clk() - t
        finally:
            # an upload in flight is resolved before the teardown, or an
            # exception's unwind, can race the side thread
            if pool is not None:
                WindowPipeline.drain(fut)
        t = clk()
        if pending is not None:
            nbatch = apply_stats(pending[0], pending[1], nbatch)
        tm['fetch'] += clk() - t
        for ds, ls, pad, idx in snaps:
            # the tail (< W): the per-batch path, on batches rebuilt from
            # the draw-time snapshots; a deferred batch takes the eager
            # augment on the executor's device
            if self._defer_fn is not None:
                dev = self._exec._ctx.torch_device()
                ds = (self._defer_fn(ds[0].to(dev, non_blocking=True),
                                     aug_generator(dev,
                                                   _random.next_seed())),) \
                    + tuple(ds[1:])
            sb = DataBatch(data=[NDArray(d) for d in ds],
                           label=[NDArray(l) for l in ls], pad=pad,
                           index=idx)
            m.forward_backward(sb)
            m.update()
            _tele.counter('fit.steps').inc()
            _tele.watchdog.note_progress('fit.step')
            if tl_on:
                _tele.timeline.note_step(1)
            _profiler.note_step()
            m.update_metric(eval_metric, sb.label)
            self.tail_batches += 1
            if batch_end_callback is not None:
                p = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                  eval_metric=eval_metric, locals=locals())
                for cb in _as_list(batch_end_callback):
                    cb(p)
            nbatch += 1
        if timing:
            logging.info(
                'fused_fit timing epoch=%d wall=%.3fs draw=%.3fs put=%.3fs '
                'dispatch=%.3fs fetch=%.3fs', epoch, clk() - ep_t0,
                tm['draw'], tm['put'], tm['dispatch'], tm['fetch'])
        return nbatch
