"""Deterministic fault injection for the resilience tier: the counterpart of
``mxnet_tpu/faults.py``.

``MXTPU_FAULT_INJECT=<kind>:<step>[:<arg>]`` arms ONE fault that fires at
a deterministic training step, so every recovery path of the resilience
tier (``module/checkpointing.py``'s restore from the last good checkpoint,
``module/resilient_fit.py``'s restart loop, ``train_supervisor.py``) is
exercised by real failures. Kinds:

- ``nan-grad:<k>``: poison the k-th drawn training batch with a NaN on the
  host, before its upload, so that step k computes non-finite gradients:
  the health sentinels name the step, the bisect names the input, and
  ``MXTPU_HEALTH_ACTION=raise`` turns it into the TrainingHealthError that
  the restart loop recovers from. Fires once;
- ``checkpoint-corrupt:<k>``: truncate the files of the first checkpoint
  saved at step >= k after it commits, so that a later restore of that
  step fails and falls back to an older one. Fires once;
- ``dispatch-exception:<k>[:<seam>]``: raise :class:`FaultInjected` from a
  dispatch seam (``dispatch``: the fused fit window; ``executor``: the
  per-batch forward and backward; ``kvstore``: the gradient push) when the
  trained-step counter reaches k; ``seam`` restricts which seam fires.
  Fires once;
- ``backend-probe-timeout:<n>``: parsed for the JAX package's bench.py,
  which reads the flag itself; nothing in the port fires it;
- ``slow-host:<k>[:<ms>]``: sleep ``ms`` (default 50) a step from step k
  on. Never disarms;
- ``mem-hog:<k>[:<mb>]``: allocate and keep ``mb`` MiB (default 8) a step
  on the batch's device from step k on: a leak's shape, for the memory
  plane's forecaster (which is not ported yet) to notice. Never disarms;
- ``clock-skew:<k>[:<ms>]``: shift this host's wall clock by ``ms`` as
  the step timeline's sync half samples it (:func:`clock_skew_ms`; that
  half is not ported yet). Never disarms;
- ``hang:<k>[:<secs>]``: sleep ``secs`` (default 3600) in place at the
  first dispatch seam that reaches step k: the hang watchdog is what
  should notice, and with ``MXTPU_WATCHDOG_ACTION=abort`` the process dies
  with code 85 for the supervisor to relaunch. Fires once;
- ``host-loss:<k>``: ``os._exit(113)`` from the first dispatch seam that
  reaches step k: no unwind, no atexit, no final checkpoint. Fires once a
  process (a relaunch re-arms unless the environment is cleared).

``MXTPU_FAULT_HOST=<i>`` arms the fault only in the process whose
``MXTPU_HOST_ID`` is ``i`` (unset: wherever the environment reaches).

Off (the default) every seam is one cached-bool check. Injection happens
at host-side seams (the batch draw, the dispatch calls, the checkpoint
commit), never inside the step's arithmetic.
"""
import logging
import os
import threading
import time

import numpy as np
import torch

__all__ = ['FaultInjected', 'HOST_LOSS_EXIT_CODE', 'enabled', 'spec',
           'note_steps', 'clock_skew_ms', 'maybe_poison_snap',
           'maybe_poison_batch', 'maybe_raise',
           'maybe_corrupt_checkpoint']

KINDS = ('nan-grad', 'checkpoint-corrupt', 'dispatch-exception',
         'backend-probe-timeout', 'slow-host', 'hang', 'host-loss',
         'mem-hog', 'clock-skew')

_SLOW_DEFAULT_MS = 50.0
_HOG_DEFAULT_MB = 8.0
_SKEW_DEFAULT_MS = 100.0
_hog = []   # mem-hog's retained device allocations (the leak itself)
_HANG_DEFAULT_SECS = 3600.0
HOST_LOSS_EXIT_CODE = 113   # distinct from the watchdog's 85


class FaultInjected(RuntimeError):
    """Raised by an armed ``dispatch-exception`` fault; carries the seam
    and step for the restart loop's record."""

    def __init__(self, message, seam=None, step=None):
        super().__init__(message)
        self.seam = seam
        self.step = step


class _FState:
    __slots__ = ('decided', 'active', 'kind', 'step', 'arg', 'drawn',
                 'steps', 'fired', 'lock')

    def __init__(self):
        self.decided = False
        self.active = False
        self.kind = None
        self.step = 0
        self.arg = None
        self.drawn = 0      # training batches drawn so far (draw order is
        self.steps = 0      # step order in every fit loop)
        self.fired = False
        self.lock = threading.Lock()


_state = _FState()
_decide_lock = threading.Lock()


def _parse(raw):
    """'<kind>:<step>[:<arg>]' -> (kind, step, arg); ValueError otherwise."""
    parts = raw.split(':')
    if len(parts) < 2 or parts[0] not in KINDS:
        raise ValueError(
            'MXTPU_FAULT_INJECT=%r: expected <kind>:<step>[:<arg>] with '
            'kind one of %s' % (raw, list(KINDS)))
    return parts[0], int(parts[1]), (parts[2] if len(parts) > 2 else None)


def _host_guard():
    """(fault_host, my_host): the MXTPU_FAULT_HOST restriction (None =
    unrestricted) and this process's MXTPU_HOST_ID."""
    from .config import flags
    flags.reload('MXTPU_FAULT_HOST')
    flags.reload('MXTPU_HOST_ID')
    fault_host = flags.get('MXTPU_FAULT_HOST')
    my_host = flags.get('MXTPU_HOST_ID')
    return (None if fault_host is None or fault_host < 0 else
            int(fault_host)), int(my_host)


def _decide():
    with _decide_lock:
        if _state.decided:
            return _state.active
        from .config import flags
        flags.reload('MXTPU_FAULT_INJECT')
        raw = (flags.get('MXTPU_FAULT_INJECT') or '').strip()
        if raw:
            try:
                kind, step, arg = _parse(raw)
                fault_host, my_host = _host_guard()
                if fault_host is not None and fault_host != my_host:
                    # another process's fault: this one runs clean, and
                    # says so once
                    logging.info(
                        'fault injection: %s armed for host %d only — '
                        'this is host %d, fault inert', kind, fault_host,
                        my_host)
                else:
                    _state.kind, _state.step, _state.arg = kind, step, arg
                    _state.active = True
                    logging.warning(
                        'fault injection armed: %s at step %d%s%s',
                        kind, step, ' (%s)' % arg if arg else '',
                        ' [host %d]' % my_host
                        if fault_host is not None else '')
            except ValueError as e:
                logging.warning('%s — fault injection disabled', e)
        _state.decided = True
    return _state.active


def enabled():
    """Whether a fault is armed (decided once from MXTPU_FAULT_INJECT):
    the seams' gate, one attribute check after the first call."""
    if _state.decided:
        return _state.active
    return _decide()


def spec():
    """(kind, step, arg) of the armed fault, or None."""
    if not enabled():
        return None
    return _state.kind, _state.step, _state.arg


def _float_arg(default):
    try:
        return float(_state.arg) if _state.arg else default
    except ValueError:
        return default


def note_steps(n=1, device=None):
    """Advance the trained-step counter (fed by the fit loops where they
    count fit.steps). An armed ``slow-host`` sleeps here once the counter
    passes its step, and an armed ``mem-hog`` allocates and keeps memory on
    ``device`` (the batch's; the card when there is one, by default)."""
    if not enabled():
        return
    with _state.lock:
        _state.steps += n
        slow = (_state.kind == 'slow-host' and _state.steps > _state.step)
        hog = (_state.kind == 'mem-hog' and _state.steps > _state.step)
    if slow:
        time.sleep(n * _float_arg(_SLOW_DEFAULT_MS) / 1e3)
    if hog:
        mb = _float_arg(_HOG_DEFAULT_MB)
        if device is None:
            device = 'cuda' if torch.cuda.is_available() else 'cpu'
        try:
            # n steps' worth of leak, written so that the allocator really
            # hands the bytes out
            _hog.append(torch.zeros(max(1, int(n * mb * 2**20 / 4)),
                                    dtype=torch.float32, device=device))
        except RuntimeError as e:     # a chaos harness must not crash the
            logging.warning(          # run itself
                'fault injection: mem-hog allocation failed: %s', e)


def clock_skew_ms():
    """The wall-clock shift (ms) an armed ``clock-skew`` applies to this
    host's timeline clock samples: 0.0 unarmed or before its step (``>=``,
    so ``clock-skew:0`` skews from the first sync round)."""
    if not enabled():
        return 0.0
    with _state.lock:
        hit = (_state.kind == 'clock-skew' and _state.steps >= _state.step)
    if not hit:
        return 0.0
    return _float_arg(_SKEW_DEFAULT_MS)


def _poison(arr, in_place):
    """One NaN planted at the origin of a float tensor or numpy array:
    (array, poisoned). ``in_place`` writes into ``arr`` itself (the fused
    window's draw-time slot, which is the window's own copy); otherwise a
    poisoned copy comes back. A non-float array comes back unchanged."""
    idx = tuple(0 for _ in arr.shape)
    if isinstance(arr, np.ndarray):
        if arr.dtype.kind != 'f':
            return arr, False
        out = arr if in_place else arr.copy()
        out[idx] = np.nan
        return out, True
    if not arr.is_floating_point() or arr.numel() == 0:
        return arr, False
    out = arr if in_place else arr.clone()
    out[idx] = float('nan')
    return out, True


def _poison_arrays(datas, labels, in_place):
    """Poison the first float array among datas, then labels (uint8 data
    of the deferred augment falls through to the label). Returns (datas,
    labels, poisoned_any)."""
    datas = list(datas)
    for i, a in enumerate(datas):
        out, ok = _poison(a, in_place)
        if ok:
            datas[i] = out
            return tuple(datas), tuple(labels), True
    labels = list(labels)
    for i, a in enumerate(labels):
        out, ok = _poison(a, in_place)
        if ok:
            labels[i] = out
            return tuple(datas), tuple(labels), True
    return tuple(datas), tuple(labels), False


def _armed_draw():
    """True when THIS draw is the poisoned one (advances the counter)."""
    with _state.lock:
        hit = (_state.kind == 'nan-grad' and not _state.fired
               and _state.drawn == _state.step)
        _state.drawn += 1
        if hit:
            _state.fired = True
    return hit


def _note_poison(hit):
    if hit:
        logging.warning('fault injection: nan-grad fired on batch %d',
                        _state.step)
    else:
        # the armed draw is consumed either way (firing later than asked
        # would be worse), but a silent drop would make a hung chaos test
        # undebuggable
        logging.warning(
            'fault injection: nan-grad armed for batch %d but the batch '
            'holds no float array — fault NOT injected', _state.step)


def maybe_poison_snap(snap):
    """The fused loop's draw seam: one (datas, labels, pad, index)
    draw-time snapshot in, possibly NaN-poisoned out. The snapshot's
    tensors are the window's own draw-time slots, so the NaN is written
    into the slot (and so into the stack that is uploaded); a snapshot
    that comes back as another object than the one passed was the armed
    draw. Counts every drawn training batch, so the armed step is a global
    batch index."""
    if not _armed_draw():
        return snap
    ds, ls, pad, idx = snap
    ds, ls, hit = _poison_arrays(ds, ls, in_place=True)
    _note_poison(hit)
    return ds, ls, pad, idx


def maybe_poison_batch(batch):
    """The per-batch loop's draw seam: poison a DataBatch's arrays (a
    poisoned copy rebound into the NDArray; same counter as
    :func:`maybe_poison_snap`)."""
    if not _armed_draw():
        return batch
    ds = tuple(a._data for a in batch.data)
    ls = tuple(a._data for a in (batch.label or ()))
    ds, ls, hit = _poison_arrays(ds, ls, in_place=False)
    if hit:
        for a, v in zip(batch.data, ds):
            a._data = v
        for a, v in zip(batch.label or (), ls):
            a._data = v
    _note_poison(hit)
    return batch


def maybe_raise(seam, upcoming=1):
    """A dispatch seam: fire an armed ``dispatch-exception`` (raise
    :class:`FaultInjected`), ``hang`` (sleep in place) or ``host-loss``
    (``os._exit``) when its step falls inside the ``upcoming`` steps this
    dispatch is about to train (the fused window passes W). A
    ``dispatch-exception`` with an ``arg`` fires at that seam only."""
    if not enabled():
        return
    with _state.lock:
        kind = _state.kind
        if (kind not in ('dispatch-exception', 'hang', 'host-loss')
                or _state.fired
                or _state.steps + upcoming <= _state.step):
            return
        if kind == 'dispatch-exception' and _state.arg \
                and _state.arg != seam:
            return
        _state.fired = True
        step = _state.step
    if kind == 'hang':
        secs = _float_arg(_HANG_DEFAULT_SECS)
        logging.warning('fault injection: hang fired at the %s seam '
                        '(step %d) — sleeping %.1fs', seam, step, secs)
        time.sleep(secs)
        return
    if kind == 'host-loss':
        logging.warning('fault injection: host-loss fired at the %s seam '
                        '(step %d) — os._exit(%d)', seam, step,
                        HOST_LOSS_EXIT_CODE)
        os._exit(HOST_LOSS_EXIT_CODE)
    raise FaultInjected(
        'injected dispatch failure at the %s seam (step %d)'
        % (seam, step), seam=seam, step=step)


def maybe_corrupt_checkpoint(directory, step):
    """The checkpoint seam (after a save commits): truncate the committed
    step's files so that a later restore of it fails. Fires on the first
    save at step >= the armed step."""
    if not enabled():
        return False
    with _state.lock:
        hit = (_state.kind == 'checkpoint-corrupt' and not _state.fired
               and int(step) >= _state.step)
        if hit:
            _state.fired = True
    if not hit:
        return False
    n = 0
    for root, _, files in os.walk(os.path.join(str(directory), str(step))):
        for name in files:
            try:
                with open(os.path.join(root, name), 'r+b') as f:
                    f.truncate(2)
                n += 1
            except OSError:
                pass
    logging.warning('fault injection: checkpoint-corrupt fired — '
                    'truncated %d file(s) of step %s in %s',
                    n, step, directory)
    return True


def _reset_for_tests():
    global _state
    _state = _FState()
    _hog.clear()
