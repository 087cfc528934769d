"""Periodic training checkpoints and restart from the last good one: the
counterpart of ``mxnet_tpu/module/checkpointing.py`` (its one-process
half).

The health plane (``telemetry/health.py``) can *detect* a dying run; this
module is the half that *acts* on it. ``BaseModule.fit`` builds a
:class:`TrainCheckpointer` from the ``MXTPU_CKPT_*`` flags and drives it
from both train loops (the per-batch loop and the fused window):

- every ``MXTPU_CKPT_EVERY`` trained steps the whole training state
  (parameters, aux states, optimizer states with their update counts,
  every RNG stream of the port, the epoch/step cursor and the eval
  metric's partial sums) is captured and handed to a background writer,
  which commits it through :mod:`..parallel.checkpoint`. The step loop
  never waits for it. The capture takes references: every tensor of the
  state is rebound by the step, never written in place (the update ops
  return new weights and states, BatchNorm new statistics, the window
  writes its results back by rebinding), so a reference names the
  captured step's value for good. On the card the copy to the host is
  issued on a side stream after an event recorded on the compute stream,
  into pinned buffers (each tensor marked as used by the side stream so
  that the caching allocator does not hand its memory out before the
  copy); the writer thread waits on the copy's event, never on the
  compute stream;
- ``max_to_keep`` pruning is the store's (``MXTPU_CKPT_KEEP``);
- a **last-good pointer** (``last_good.step`` in the checkpoint directory)
  advances past a saved step only once its write has committed AND the
  health plane has seen every step it covers finite. A checkpoint captured
  after a NaN trained into the parameters is never certified;
- ``MXTPU_CKPT_RESUME`` (on by default): a fresh ``fit()`` against a
  directory that holds a certified checkpoint restores it bit for bit
  into the live arrays (by rebinding their tensors, which the cached fused
  loop reads afresh at every window), brings back the update counts and
  RNG streams, skips the epochs already trained and skips the data
  iterator to the restored step (``seed_epoch(epoch)`` first, on an
  iterator that has it).

Degradation ladder (a checkpointing failure never kills training, and
never moves it off the card): the async writer dies -> synchronous saves;
those fail repeatedly -> checkpointing off, with a warning; a corrupt
step -> the next older committed step; nothing restorable -> a fresh
start. ``module/resilient_fit.py`` and ``train_supervisor.py`` build the
restart loop on top.

All flags off: ``for_fit`` returns None, no thread exists and nothing
runs. Not ported (ROADMAP.md §1 item 11): the multi-process gang mode
(the cross-host pointer agreement and commit barrier), restoring onto a
different mesh, and the ZeRO optimizer leaves.
"""
import logging
import os
import re

import numpy as np
import torch

from .. import faults as _faults
from .. import random as _random
from .. import telemetry as _tele

__all__ = ['TrainCheckpointer', 'enabled', 'read_pointer', 'write_pointer']

_POINTER = 'last_good.step'
_MAX_SAVE_FAILURES = 3
_FORMAT = 1


def write_pointer(directory, step):
    """Atomically write the ``last_good.step`` pointer."""
    tmp = os.path.join(str(directory), _POINTER + '.tmp')
    with open(tmp, 'w') as f:
        f.write('%d\n' % int(step))
    os.replace(tmp, os.path.join(str(directory), _POINTER))


def read_pointer(directory):
    """The certified last-good step recorded in ``directory``, or None
    when nothing was ever certified."""
    try:
        with open(os.path.join(str(directory), _POINTER)) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def _flags():
    from ..config import flags
    for name in ('MXTPU_CKPT_DIR', 'MXTPU_CKPT_EVERY', 'MXTPU_CKPT_KEEP',
                 'MXTPU_CKPT_ASYNC', 'MXTPU_CKPT_RESUME'):
        flags.reload(name)
    return (flags.get('MXTPU_CKPT_DIR'), flags.get('MXTPU_CKPT_EVERY'),
            flags.get('MXTPU_CKPT_KEEP'), flags.get('MXTPU_CKPT_ASYNC'),
            flags.get('MXTPU_CKPT_RESUME'))


def enabled():
    """Whether the checkpoint flags ask for periodic saves."""
    d, every, _, _, _ = _flags()
    return bool(d) and every > 0


def _metric_children(eval_metric):
    from .. import metric as metric_mod
    if isinstance(eval_metric, metric_mod.CompositeEvalMetric):
        return list(eval_metric.metrics)
    return [eval_metric]


class _HostCopy:
    """A captured tree's copy to the host. On the card: pinned buffers
    filled on ``side`` after an event on the compute stream; ``wait()``
    (the writer thread) waits on the copy's event only. On the CPU the
    leaves are already host tensors."""

    def __init__(self, tree, side):
        self.done = None
        self.tree = tree
        leaves = [t for t in _leaves(tree) if t.is_cuda]
        if not leaves:
            return
        dev = leaves[0].device
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(dev))
        side.wait_event(ready)
        with torch.cuda.stream(side):
            def host(t):
                if not t.is_cuda:
                    return t
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                t.record_stream(side)
                return h
            self.tree = _map_tree(tree, host)
            self.done = torch.cuda.Event()
            self.done.record(side)

    def wait(self):
        if self.done is not None:
            self.done.synchronize()
        return self.tree


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


class TrainCheckpointer:
    """One fit() call's checkpoints and resume (built by :meth:`for_fit`,
    driven by the fit loops)."""

    def __init__(self, module, eval_metric, directory, every, keep,
                 async_, logger=logging):
        from ..parallel import checkpoint as ckpt
        self._ckpt = ckpt
        self.module = module
        self.eval_metric = eval_metric
        self.directory = os.path.abspath(str(directory))
        self.every = int(every)
        self.logger = logger
        self._async = bool(async_)
        self._mngr = ckpt.manager(self.directory, max_to_keep=keep)
        self._param_names = list(module._exec_group.param_names)
        self._aux_names = list(module._exec_group.aux_names)
        self._grad_names = list(self._exec._grad_names)
        from .fused_fit import updater_keys
        self._upd_keys = updater_keys(module, self._grad_names)
        self._accum = (module._grad_req == 'add')

        self.global_step = 0
        self.epoch = 0
        self.step_in_epoch = 0
        self.epoch_nbatch_base = 0  # resumed epoch: its first nbatch value
        self.resumed_epoch = None   # epoch whose batches were skipped
        self._checked = 0           # steps the health plane has verified
        self._last_save = 0
        self._initiated = 0         # newest step a save actually started
        self._pending = []  # [step, nonfinite_at_capture, future, cleared]
        self._pool = None
        self._side = None           # the copy-to-host stream on the card
        self._failures = 0
        self._disabled = False
        self._resume = None         # (epoch, step_in_epoch, metric_state)
        self.last_good = None
        self.restored_step = None
        # the incident count at fit start: a NEW incident this attempt
        # makes every later capture uncertifiable (_promote), while counts
        # of an earlier attempt of the same process (a resilient_fit retry)
        # do not freeze the restored run
        self._nf_base = self._nonfinite_count() or 0

    @property
    def _exec(self):
        # read afresh every time: a reshape rebinds the executors, and a
        # capture of the orphaned one would checkpoint stale parameters
        return self.module._exec_group.execs[0]

    # -- construction ------------------------------------------------------
    @classmethod
    def for_fit(cls, module, eval_metric, logger=logging):
        """Build (and maybe resume) the fit loop's checkpointer, or None
        when the flags are off or the module is not a one-executor Module.
        A failure here warns and turns checkpointing off; it never stops
        the fit."""
        module.__dict__.pop('_mxtpu_ckpt', None)
        directory, every, keep, async_, resume = _flags()
        if not directory or every <= 0:
            return None
        group = getattr(module, '_exec_group', None)
        if group is None:
            logger.warning(
                'checkpointing: MXTPU_CKPT_DIR is set but %s does not '
                'expose an executor group — periodic checkpoints need '
                'the standard Module; continuing without checkpoints',
                type(module).__name__)
            return None
        execs = getattr(group, 'execs', None) or []
        if len(execs) != 1:
            logger.warning(
                'checkpointing: MXTPU_CKPT_DIR is set but the module '
                'binds %d executors — periodic checkpoints support one '
                'executor; continuing without checkpoints', len(execs))
            return None
        try:
            self = cls(module, eval_metric, directory, every, keep,
                       async_, logger=logger)
        except OSError as e:
            logger.warning('checkpointing: cannot open %s (%s) — '
                           'continuing without checkpoints', directory, e)
            return None
        if resume:
            try:
                self._try_resume()
            except Exception as e:  # noqa: BLE001 — never stop the fit
                logger.warning('checkpointing: resume failed (%s) — '
                               'starting fresh', e)
                self._resume = None
        module.__dict__['_mxtpu_ckpt'] = self
        # the watchdog's abort (os._exit from its monitor thread) must
        # still commit and certify the save in flight: the wedged main
        # thread never reaches finish() or handle_failure()
        _tele.watchdog.add_abort_hook(self._abort_drain)
        return self

    # -- state capture -----------------------------------------------------
    def _updater(self):
        from .fused_fit import updater_obj
        return updater_obj(self.module)

    def _ensure_opt_states(self):
        from .fused_fit import ensure_opt_states
        ensure_opt_states(self.module, self._grad_names, self._upd_keys,
                          self._exec.arg_dict)

    def _walk_opt(self):
        """(structure, arrays): the optimizer-state tree flattened into
        deterministically named leaves ('opt.N'); the structure mirrors each
        state (None, a leaf's name, or a list for a tuple state)."""
        self._ensure_opt_states()
        upd = self._updater()
        arrays = {}
        counter = [0]

        def enc(v):
            if v is None:
                return None
            if isinstance(v, tuple):
                return [enc(x) for x in v]
            k = 'opt.%d' % counter[0]
            counter[0] += 1
            arrays[k] = v._data
            return k

        structure = [[n, enc(upd.states[self._upd_keys[n]])]
                     for n in self._grad_names]
        return structure, arrays

    def _opt_bookkeeping(self):
        o = self.module._optimizer
        return {'num_update': int(o.num_update),
                'index_update_count': [[k, int(v)] for k, v in
                                       sorted(o._index_update_count.items(),
                                              key=str)]}

    def _state_tree(self):
        e = self._exec
        tree = {
            'params': {n: e.arg_dict[n]._data for n in self._param_names},
            'aux': {n: e.aux_dict[n]._data for n in self._aux_names},
        }
        structure, opt_arrays = self._walk_opt()
        if opt_arrays:
            tree['opt'] = opt_arrays
        if self._accum:
            tree['gacc'] = {n: e.grad_dict[n]._data
                            for n in self._grad_names}
        return tree, structure

    def _capture(self):
        """The checkpoint tree and its JSON meta, captured on the MAIN
        thread so that they name one step: references to the live tensors
        (never written in place), whose copy to the host is then issued
        off the step loop. The RNG streams ride the meta."""
        tree, structure = self._state_tree()
        rng = _random.get_state()
        rng['generators'] = {d: np.asarray(s).tolist()
                             for d, s in rng['generators'].items()}
        metric_state = [[type(c).__name__, float(c.sum_metric),
                         int(c.num_inst)]
                        for c in _metric_children(self.eval_metric)]
        meta = {'format': _FORMAT, 'epoch': int(self.epoch),
                'step_in_epoch': int(self.step_in_epoch),
                'global_step': int(self.global_step),
                'opt_structure': structure,
                'opt_bookkeeping': self._opt_bookkeeping(),
                'metric': metric_state, 'rng_host': rng,
                'grad_req': self.module._grad_req,
                'shapes': self._ckpt.template_shapes(tree)}
        cuda = [t for t in _leaves(tree) if t.is_cuda]
        if cuda and self._side is None:
            self._side = torch.cuda.Stream(cuda[0].device)
        return _HostCopy(tree, self._side), meta

    # -- save --------------------------------------------------------------
    def _nonfinite_count(self):
        """health.nonfinite_steps now, or None while the health plane is
        off (no gate to wait for)."""
        if not _tele.health.enabled():
            return None
        return int(_tele.get_registry()
                   .counter('health.nonfinite_steps').value)

    def _do_save(self, step, copy, meta):
        """The write (the writer thread in async mode): wait for the copy
        to the host, commit through the store, then the fault injection's
        corrupt seam."""
        tree = copy.wait()
        with _tele.span('ckpt.save', 'ckpt'):
            self._ckpt.save(self._mngr, step, tree, wait=True, meta=meta)
        _faults.maybe_corrupt_checkpoint(self.directory, step)
        _tele.counter('ckpt.saves').inc()
        # a committed save is forward progress even while the step loop is
        # briefly quiet (the synchronous fallback)
        _tele.watchdog.note_progress('ckpt.save')

    def _initiate_save(self):
        step = self.global_step
        if not step or self._disabled:
            return
        if [p for p in self._pending if p[2] is not None
                and not p[2].done()]:
            # the writer is still on an earlier step: drop this save rather
            # than queue behind slow storage (finish() saves again after
            # draining, so the run's final state is never lost)
            _tele.counter('ckpt.skipped').inc()
            return
        try:
            with _tele.span('ckpt.capture', 'ckpt'):
                copy, meta = self._capture()
        except Exception as e:  # noqa: BLE001 — never kill training
            self._note_failure('state capture failed: %s' % e)
            return
        nf0 = self._nonfinite_count()
        # health-cleared at birth when the sentinels already checked
        # through this step (the lag=0 paths): later incidents then belong
        # to LATER steps and must not taint this capture
        cleared = nf0 is None or self._checked >= step
        if self._async:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor
                self._pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix='mxtpu-ckpt')
            try:
                fut = self._pool.submit(self._do_save, step, copy, meta)
            except RuntimeError as e:   # the pool was torn down
                self.logger.warning(
                    'checkpointing: async writer unavailable (%s) — '
                    'falling back to synchronous saves', e)
                self._async = False
                fut = None
            if fut is not None:
                self._initiated = step
                self._pending.append([step, nf0, fut, cleared])
                return
        try:
            self._do_save(step, copy, meta)
        except Exception as e:  # noqa: BLE001
            self._note_failure('save of step %d failed: %s' % (step, e))
            return
        self._initiated = step
        self._pending.append([step, nf0, None, cleared])

    def _note_failure(self, msg):
        self._failures += 1
        _tele.counter('ckpt.save_failures').inc()
        if self._failures >= _MAX_SAVE_FAILURES:
            self._disabled = True
            self.logger.warning(
                'checkpointing: %s — %d consecutive failures, disabling '
                'checkpoints for this run (training continues)', msg,
                self._failures)
        else:
            self.logger.warning(
                'checkpointing: %s — training continues', msg)

    # -- last-good promotion -----------------------------------------------
    def _write_pointer(self, step):
        write_pointer(self.directory, step)
        self.last_good = int(step)
        _tele.gauge('ckpt.last_good').set(int(step))

    def _promote(self, bound=None, final=False):
        """Advance the last-good pointer over committed saves the health
        plane has certified. A pending save at step k promotes once its
        write landed AND the sentinels checked through step k with no
        non-finite incident on record this attempt (an incident under
        action=warn trains into the parameters, so every capture after it
        is tainted); ``bound`` (the known first bad step of an unwinding
        incident) promotes everything strictly before it instead. With the
        health plane off, the commit alone promotes. ``final`` (no more
        sentinel rows are coming) certifies on an unchanged incident count
        alone: a NaN that the crash hid from the sentinels re-raises on the
        first resumed step, which falls back to an older checkpoint."""
        nf_now = self._nonfinite_count()
        keep = []
        for entry in self._pending:
            step, nf0, fut, cleared = entry
            if not cleared and nf_now is not None \
                    and nf_now == nf0 and self._checked >= step:
                # the sentinels caught up with this step, the count
                # unchanged: the capture is clean for good
                entry[3] = cleared = True
            if fut is not None:
                if not fut.done():
                    keep.append(entry)
                    continue
                err = fut.exception()
                if err is not None:
                    if self._async:
                        self.logger.warning(
                            'checkpointing: async writer died (%s) — '
                            'falling back to synchronous saves', err)
                        self._async = False
                    self._note_failure('async save of step %d failed: %s'
                                       % (step, err))
                    continue
            if bound is not None:
                ok = step < bound
            elif nf_now is None:
                ok = True
            elif (nf0 or 0) > self._nf_base:
                # an incident precedes this capture within THIS attempt:
                # under action=warn the NaN trained into the parameters, so
                # the pointer freezes at the last clean step
                _tele.counter('ckpt.uncertified').inc()
                continue
            elif cleared or (final and nf_now == nf0):
                ok = True
            elif nf_now != nf0:
                # an incident landed before health checked through this
                # step: it may belong to a step the capture covers
                _tele.counter('ckpt.uncertified').inc()
                continue
            else:
                keep.append(entry)   # health has not caught up yet
                continue
            if ok:
                try:
                    self._write_pointer(step)
                except OSError as e:
                    self.logger.warning(
                        'checkpointing: cannot write last-good pointer '
                        '(%s)', e)
            else:
                _tele.counter('ckpt.uncertified').inc()
        self._pending = keep

    # -- fit-loop hooks ----------------------------------------------------
    def begin_epoch(self, epoch, eval_metric, train_data):
        """Epoch-start hook (after the metric reset). Returns False when
        this epoch precedes the resume target (fit skips it without
        touching the data). At the resume epoch itself the metric's
        partial sums are re-applied and the iterator is skipped to the
        restored step."""
        self.eval_metric = eval_metric
        if self._resume is not None:
            r_epoch, r_step, metric_state = self._resume
            if epoch < r_epoch:
                return False
            if epoch == r_epoch:
                self._resume = None
                self.epoch = epoch
                self.step_in_epoch = r_step
                # the fit loops start their batch counter here, so that
                # callbacks, incidents and the failure bound see TRUE
                # batch-in-epoch indices on a resumed epoch
                self.epoch_nbatch_base = r_step
                self.resumed_epoch = epoch if r_step else None
                seed_fn = getattr(train_data, 'seed_epoch', None)
                if callable(seed_fn):
                    seed_fn(epoch)
                if r_step:
                    it = iter(train_data)
                    skipped = 0
                    while skipped < r_step:
                        try:
                            next(it)
                        except StopIteration:
                            break
                        skipped += 1
                    self.logger.info(
                        'checkpointing: resumed epoch %d at step %d '
                        '(skipped %d already-trained batches)',
                        epoch, r_step, skipped)
                if metric_state:
                    children = _metric_children(eval_metric)
                    live = [type(c).__name__ for c in children]
                    saved = [s[0] for s in metric_state]
                    if live != saved:
                        # a changed metric list would zip-truncate and
                        # mis-assign the partial sums
                        self.logger.warning(
                            'checkpointing: eval-metric state did not '
                            'match the checkpoint (saved %s vs live %s); '
                            'metric restarts at 0', saved, live)
                    else:
                        for child, (_, s, n) in zip(children, metric_state):
                            child.sum_metric = s
                            child.num_inst = n
                _tele.event('ckpt.resume', epoch=epoch, step=r_step,
                            restored_step=self.restored_step)
                return True
            self._resume = None   # the target epoch already passed
        self.epoch = epoch
        self.step_in_epoch = 0
        self.epoch_nbatch_base = 0
        return True

    def allow_empty_epoch(self, epoch):
        """Whether the fit loops may draw ZERO batches at this epoch's
        start: only a resumed epoch whose checkpoint landed exactly on its
        boundary (the skip consumed every batch)."""
        return self.resumed_epoch == epoch

    def save_due(self, n):
        """Whether :meth:`note_steps`\\ (n) will initiate a save: the fused
        loop asks BEFORE noting a window, so that it can first apply its
        pipelined metric and health rows (the capture's metric state then
        covers every step it claims)."""
        return (not self._disabled
                and self.global_step + n - self._last_save >= self.every)

    def note_steps(self, n, lag=0):
        """Step hook, called by both train loops after ``n`` more steps are
        trained. ``lag`` is how many trained steps the loop's health
        checks trail by (the fused loop checks a window's rows one window
        late)."""
        self.global_step += n
        self.step_in_epoch += n
        self._checked = max(self._checked, self.global_step - lag)
        if self._pending:
            self._promote()
        if not self._disabled \
                and self.global_step - self._last_save >= self.every:
            self._last_save = self.global_step
            self._initiate_save()

    def _abort_drain(self):
        """The watchdog's abort hook (its side thread, bounded by the
        watchdog's cap): drain the writer and certify what committed, so
        that the relaunch has a last-good pointer. No new capture: the
        wedged main thread owns the live arrays."""
        self._drain()
        before = self.last_good
        self._promote(final=True)
        if self.last_good != before:
            self.logger.warning(
                'checkpointing: abort drain certified step %s in %s',
                self.last_good, self.directory)

    def finish(self):
        """fit() completed: a final save, the writer drained, and what the
        health plane has cleared certified. Draining FIRST means the final
        save is never dropped on the busy-writer guard."""
        self._checked = self.global_step
        self._drain()
        if not self._disabled and self.global_step > self._initiated:
            self._last_save = self.global_step
            self._initiate_save()
            self._drain()
        self._promote()
        self._shutdown_pool()

    def handle_failure(self, diagnostic=None):
        """fit() died (fit's and resilient_fit's except paths): drain the
        writer, then certify the pending saves. When the diagnostic names
        the first bad step (TrainingHealthError), every committed save
        strictly before it is good whatever the detector's lag; otherwise
        the commit and an unchanged incident count certify (``final``)."""
        self._drain()
        bound = None
        if diagnostic and diagnostic.get('step') is not None:
            epoch_base = self.global_step - self.step_in_epoch
            bound = epoch_base + int(diagnostic['step'])
        self._promote(bound=bound, final=bound is None)
        self._shutdown_pool()

    def _drain(self):
        for entry in self._pending:
            fut = entry[2]
            if fut is not None and not fut.done():
                try:
                    fut.exception(timeout=600)
                except Exception:  # noqa: BLE001 — read in _promote
                    pass
        self._ckpt.wait(self._mngr)

    def _shutdown_pool(self):
        _tele.watchdog.remove_abort_hook(self._abort_drain)
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    # -- restore -----------------------------------------------------------
    @staticmethod
    def _annotate_opt_leaves(msg, meta):
        """Map the anonymous ``opt/opt.N`` leaf paths in a shape-mismatch
        message to the parameter each state leaf belongs to."""
        owners = {}

        def walk(enc, name):
            if enc is None:
                return
            if isinstance(enc, list):
                for e in enc:
                    walk(e, name)
                return
            owners[enc] = name

        for name, enc in meta.get('opt_structure') or []:
            walk(enc, name)
        return re.sub(
            r'opt/(opt\.\d+)',
            lambda m: 'opt/%s (%s)' % (m.group(1),
                                       owners.get(m.group(1), '?')), msg)

    def _fetch_step(self, step):
        """Read and validate one committed step WITHOUT touching the live
        module: ``(meta, restored_tree)``, each leaf on its live array's
        device and dtype. A changed model or optimizer raises naming the
        offending leaf; the caller falls back to an older step."""
        meta = self._ckpt.read_meta(self._mngr, step)
        if meta.get('format') != _FORMAT:
            raise ValueError('unsupported checkpoint format %r'
                             % meta.get('format'))
        template, _ = self._state_tree()
        saved_shapes = meta.get('shapes')
        if saved_shapes:
            try:
                self._ckpt.validate_shapes(saved_shapes, template)
            except ValueError as e:
                raise ValueError(self._annotate_opt_leaves(str(e), meta)) \
                    from None
        restored = self._ckpt.restore_state(self._mngr, template, step)
        return meta, restored

    def _apply(self, tree, meta):
        e = self._exec
        m = self.module
        # optimizer state: walk the SAVED structure against the live state
        # NDArrays (made by the optimizer's own create_state, so shapes and
        # wrapping match). The walk runs FIRST and only stages: a mismatch
        # must raise while the live module is untouched, so that the
        # fallback never inherits a half-restored run
        self._ensure_opt_states()
        upd = self._updater()
        opt_arrays = tree.get('opt', {})
        staged = []   # (live state NDArray, restored tensor)

        def stage(struct, live, name):
            if struct is None:
                if live is not None:
                    raise ValueError(
                        'optimizer state for %s drifted: checkpoint has '
                        'no state leaf, live optimizer has one' % name)
                return
            if isinstance(struct, list):
                if not isinstance(live, tuple) or len(live) != len(struct):
                    raise ValueError(
                        'optimizer state for %s drifted: checkpoint '
                        'holds %d state leaf(s), live optimizer %s'
                        % (name, len(struct),
                           len(live) if isinstance(live, tuple)
                           else 'a single leaf'))
                for s, l in zip(struct, live):
                    stage(s, l, name)
                return
            if live is None or isinstance(live, tuple):
                raise ValueError(
                    'optimizer state for %s drifted: checkpoint leaf %s '
                    'has no matching live state array' % (name, struct))
            arr = opt_arrays[struct]
            if tuple(arr.shape) != tuple(live._data.shape):
                raise ValueError(
                    'optimizer state for %s drifted: leaf %s saved '
                    'shape %s vs live %s'
                    % (name, struct, tuple(arr.shape),
                       tuple(live._data.shape)))
            staged.append((live, arr))

        for name, struct in meta['opt_structure']:
            if name not in self._upd_keys:
                raise ValueError('checkpoint names unknown param %r' % name)
            stage(struct, upd.states[self._upd_keys[name]], name)

        for n in self._param_names:
            e.arg_dict[n]._data = tree['params'][n]
            if m._update_on_kvstore:
                store = m._kvstore._store.get(n)
                if store is not None:
                    store._data = tree['params'][n]
        for n in self._aux_names:
            e.aux_dict[n]._data = tree['aux'][n]
        if self._accum and 'gacc' in tree:
            for n in self._grad_names:
                e.grad_dict[n]._data = tree['gacc'][n]
        m._params_dirty = True
        for live, arr in staged:
            live._data = arr

        book = meta.get('opt_bookkeeping') or {}
        o = m._optimizer
        o.num_update = int(book.get('num_update', o.num_update))
        o._index_update_count = {k: int(v) for k, v in
                                 book.get('index_update_count', [])}
        _random.set_state(dict(meta.get('rng_host') or {}))

    def _try_resume(self):
        steps = self._ckpt.all_steps(self._mngr)
        if not steps:
            return
        ptr = read_pointer(self.directory)
        if ptr is None:
            self.logger.warning(
                'checkpointing: %s holds %d checkpoint(s) but no '
                'last-good pointer — none was health-certified; '
                'starting fresh', self.directory, len(steps))
            return
        for step in [s for s in sorted(steps, reverse=True) if s <= ptr]:
            try:
                meta, restored = self._fetch_step(step)
                # _apply stages everything before it writes, so a failure
                # leaves the module untouched
                self._apply(restored, meta)
            except Exception as e:  # noqa: BLE001 — a corrupt/drifted step
                self.logger.warning(
                    'checkpointing: restore of step %d failed (%s) — '
                    'trying an older checkpoint', step, e)
                continue
            # steps newer than the restore point are stale (and, after an
            # incident, possibly poisoned): clear them so that pruning and
            # the replay's saves stay sane
            for s in steps:
                if s > step:
                    self._ckpt.delete_step(self._mngr, s)
            self.global_step = int(meta['global_step'])
            self._last_save = self.global_step
            self._initiated = self.global_step
            self._checked = self.global_step
            self.last_good = step
            self.restored_step = step
            if step != ptr:
                try:
                    self._write_pointer(step)
                except OSError:
                    pass
            self._resume = (int(meta['epoch']), int(meta['step_in_epoch']),
                            meta.get('metric') or [])
            self.logger.info(
                'checkpointing: restored step %d (epoch %d, step %d) '
                'from %s', step, meta['epoch'], meta['step_in_epoch'],
                self.directory)
            return
        self.logger.warning(
            'checkpointing: no checkpoint in %s was restorable — '
            'starting fresh', self.directory)
