"""Hang watchdog, the counterpart of ``mxnet_tpu/telemetry/watchdog.py``:
detect a wedged loop and act on it.

``MXTPU_WATCHDOG_SECS=<t>`` arms a daemon-thread progress monitor fed by
:func:`note_progress` (one cached-bool check plus a clock store): the fit
loops mark each step or window (``fit.step``, ``fused_fit.window``,
``fit.epoch_end``), the eval loops each window (``fused_eval.window``,
``eval.step``) and the serving batcher each completed dispatch
(``serve.dispatch``). The monitor arms at the FIRST mark (so a long
first build cannot false-trip) and then requires a mark at least every
``t`` seconds; :func:`suspend`, which the fit and eval loops call as they
end, stops expecting marks until the next one. On a stall it:

- dumps every thread's stack plus the last progress mark and the serving
  counters as a ``hang`` JSONL incident (when telemetry is on) and logs
  the same digest, and dumps the flight recorder (``flight-hang.jsonl``);
- flips ``/healthz`` to 503 with a ``hung`` status until progress
  resumes (telemetry/serve.py reads :func:`hang_info`);
- under ``MXTPU_WATCHDOG_ACTION=abort`` runs the abort hooks
  (:func:`add_abort_hook`; the checkpointer registers its drain, which
  commits and certifies the save in flight so that the relaunch has a
  last-good checkpoint) on a side thread for at most
  :data:`_ABORT_HOOK_CAP_S` seconds, then exits the process with the
  distinct code :data:`HANG_EXIT_CODE` (85) after flushing the JSONL
  sink. The exit is ``os._exit`` by design: a wedged thread cannot be
  unwound, only replaced.

Off (the default) = no thread is ever created and every progress site
costs one cached-bool check. The watchdog is independent of
``MXTPU_TELEMETRY``; only the JSONL record and the /healthz digest need
telemetry on.
"""
import logging
import os
import sys
import threading
import time
import traceback

__all__ = ['HANG_EXIT_CODE', 'enabled', 'note_progress', 'suspend',
           'hang_info', 'snapshot_watchdog', 'stop', 'add_abort_hook',
           'remove_abort_hook']

# distinct from every exit code a Python process produces on its own
# (tracebacks exit 1, CLI misuse 2, signals 128+n)
HANG_EXIT_CODE = 85

_MIN_POLL_S = 0.05
_STACK_LIMIT = 24          # frames kept per thread in the hang digest
_ABORT_HOOK_CAP_S = 30.0   # bound on the abort hooks' work: the exit
                           # happens even if a hook wedges too

# callables run (bounded, best effort) before an abort exit
_abort_hooks = []
_hook_lock = threading.Lock()


def add_abort_hook(fn):
    """Register ``fn`` to run (on a side thread, bounded by
    _ABORT_HOOK_CAP_S in all) before an ``action=abort`` exit. Idempotent
    per callable."""
    with _hook_lock:
        if fn not in _abort_hooks:
            _abort_hooks.append(fn)


def remove_abort_hook(fn):
    with _hook_lock:
        try:
            _abort_hooks.remove(fn)
        except ValueError:
            pass


def _run_abort_hooks():
    """Run the abort hooks on a side thread and wait at most
    _ABORT_HOOK_CAP_S for them (the wedged main thread never will)."""
    with _hook_lock:
        hooks = list(_abort_hooks)
    if not hooks:
        return

    def run():
        for fn in hooks:
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — the exit must happen
                logging.warning('watchdog: abort hook %r failed: %s', fn, e)
    ht = threading.Thread(target=run, name='mxtpu-watchdog-drain',
                          daemon=True)
    ht.start()
    ht.join(timeout=_ABORT_HOOK_CAP_S)
    if ht.is_alive():
        logging.warning('watchdog: abort hooks still running after %.0fs '
                        '— exiting anyway', _ABORT_HOOK_CAP_S)


class _WState:
    __slots__ = ('decided', 'active', 'secs', 'action', 'thread',
                 'stop_ev', 'last_mark', 'last_what', 'marks',
                 'tripped', 'hang', 'lock')

    def __init__(self):
        self.decided = False
        self.active = False
        self.secs = 0.0
        self.action = 'warn'
        self.thread = None
        self.stop_ev = None
        self.last_mark = None     # time.time() of the newest mark
        self.last_what = None
        self.marks = 0
        self.tripped = False      # an un-recovered hang is on record
        self.hang = None          # the last hang digest (dict)
        self.lock = threading.Lock()


_state = _WState()
_decide_lock = threading.Lock()


def _decide():
    with _decide_lock:
        if _state.decided:
            return _state.active
        from ..config import flags
        flags.reload('MXTPU_WATCHDOG_SECS')
        flags.reload('MXTPU_WATCHDOG_ACTION')
        secs = float(flags.get('MXTPU_WATCHDOG_SECS'))
        action = flags.get('MXTPU_WATCHDOG_ACTION')
        _state.secs = secs
        _state.action = action
        _state.active = secs > 0.0
        _state.decided = True
    return _state.active


def enabled():
    """Whether the watchdog is armed (MXTPU_WATCHDOG_SECS > 0, decided
    once). One attribute check after the first call — the progress
    sites' gate. The monitor thread only starts at the first
    :func:`note_progress` call, so an armed-but-idle process still has
    no extra thread."""
    if _state.decided:
        return _state.active
    return _decide()


def note_progress(what):
    """Hot-path progress mark: the loop made forward progress of kind
    ``what`` (the serving batcher's 'serve.dispatch'). Off = one
    cached-bool check. The first mark arms the monitor thread; a mark
    arriving after a hang incident marks it recovered (and /healthz
    goes green again)."""
    if not enabled():
        return
    st = _state
    # monotonic, not wall: an NTP step across a mark gap must neither
    # false-trip a hang (forward step > threshold would, under abort,
    # kill a healthy run) nor mask a real one (backward step)
    st.last_mark = time.monotonic()
    st.last_what = what
    st.marks += 1
    if st.thread is None:
        _start()
    elif st.tripped:
        recovered = None
        with st.lock:
            if st.tripped:
                st.tripped = False
                if st.hang is not None:
                    st.hang['active'] = False
                    recovered = st.hang.get('stalled_s')
        if recovered is not None:
            logging.warning(
                'watchdog: progress resumed (%s) after a %.1fs stall — '
                'clearing the hang state', what, recovered)


def suspend():
    """The watched region ended (fit returned or unwound, an eval pass
    finished): stop expecting marks until the next one arrives, so that
    host work after training, or the idle time between epoch-at-a-time
    fit() calls, never trips the watchdog. An active hang is cleared too:
    with the region over, "the loop is stalled now" no longer holds. The
    next :func:`note_progress` re-arms it."""
    if not enabled():
        return
    _state.last_mark = None
    _state.last_what = None
    with _state.lock:
        if _state.tripped:
            _state.tripped = False
            if _state.hang is not None:
                _state.hang['active'] = False


def hang_info():
    """The ACTIVE hang digest (the loop is stalled right now), or None.
    telemetry/serve.py flips /healthz to 503 on it."""
    with _state.lock:
        if _state.hang is not None and _state.hang.get('active'):
            return dict(_state.hang)
    return None


def snapshot_watchdog():
    """Point-in-time watchdog state for reports: the last hang digest
    (recovered or not) or None when the run never stalled."""
    with _state.lock:
        return dict(_state.hang) if _state.hang is not None else None


# ---------------------------------------------------------------------------
# monitor thread
# ---------------------------------------------------------------------------

def _start():
    with _state.lock:
        if _state.thread is not None:
            return
        _state.stop_ev = threading.Event()
        _state.thread = threading.Thread(
            target=_monitor, name='mxtpu-watchdog', daemon=True)
        _state.thread.start()


def _monitor():
    st = _state
    poll = max(_MIN_POLL_S, st.secs / 4.0)
    ev = st.stop_ev
    while not ev.wait(poll):
        last = st.last_mark
        if last is None or st.tripped:
            continue
        stalled = time.monotonic() - last
        if stalled > st.secs:
            try:
                _trip(stalled)
            except Exception as e:  # noqa: BLE001 — the monitor must
                # survive anything (incl. a test reset racing the trip):
                # a watchdog that dies of its own reporting is worse
                # than the hang it watches for
                logging.warning('watchdog: hang reporting failed: %s', e)


def _thread_stacks():
    """{thread name: [frame lines]} for every live thread, the
    watchdog thread excluded (its own stack is noise)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    me = threading.get_ident()
    out = {}
    for ident, frame in sys._current_frames().items():
        if ident == me:
            continue
        lines = traceback.format_stack(frame, limit=_STACK_LIMIT)
        out[names.get(ident, 'thread-%d' % ident)] = \
            [ln.rstrip('\n') for ln in lines]
    return out


def _telemetry_digest():
    """The last telemetry state worth having in a hang report: the step,
    window and serving counters. Empty when telemetry is off — the
    watchdog does not require it."""
    from . import _state as tst
    if not tst.active:
        return {}
    reg = tst.registry
    out = {}
    for name in ('fit.steps', 'fused_fit.windows', 'eval.batches',
                 'serve.requests', 'serve.dispatches', 'serve.errors'):
        c = reg.get(name)
        if c is not None and getattr(c, 'value', 0):
            out[name] = c.value
    return out


def _trip(stalled):
    """One stall crossed the threshold: record the hang incident and
    apply MXTPU_WATCHDOG_ACTION (runs on the monitor thread — the
    wedged thread cannot run anything)."""
    st = _state
    digest = {
        'active': True,
        'stalled_s': round(stalled, 2),
        'threshold_s': st.secs,
        'last_progress': st.last_what,
        'marks': int(st.marks),
        'action': st.action,
        'telemetry': _telemetry_digest(),
        'stacks': _thread_stacks(),
    }
    with st.lock:
        if st.tripped:     # raced a concurrent trip
            return
        st.tripped = True
    from . import _state as tst, counter as _counter
    _counter('watchdog.hangs').inc()
    rec = {'type': 'hang'}
    rec.update(digest)
    rec.pop('active')
    if tst.active and tst.sink is not None:
        tst.sink.emit(rec)
        tst.sink.flush()    # the process may be about to die — no buffer
    # flight recorder: the spans/records BEFORE the stall are exactly
    # what the postmortem wants (and under action=abort this is the
    # last chance to write them)
    try:
        from . import flight
        flight.dump('hang', extra={'stalled_s': digest['stalled_s'],
                                   'last_progress':
                                   digest['last_progress']})
    except Exception:  # noqa: BLE001 — forensics must not add a crash
        pass
    # /healthz and hang_info() show the hang once its records are on disk
    # (a mark that arrived meanwhile has already cleared the trip)
    with st.lock:
        digest['active'] = st.tripped
        st.hang = digest
    logging.warning(
        'watchdog: no progress for %.1fs (threshold %.1fs; '
        'last mark: %s) — the run looks hung. Thread stacks recorded%s',
        stalled, st.secs, st.last_what or 'none',
        ' in the telemetry JSONL' if tst.active and tst.sink is not None
        else ' in this log')
    for name, frames in digest['stacks'].items():
        logging.warning('watchdog: stack of %s:\n%s', name,
                        ''.join('%s\n' % f for f in frames[-6:]))
    if st.action == 'abort':
        logging.warning(
            'watchdog: MXTPU_WATCHDOG_ACTION=abort — exiting with code %d '
            'so that a supervisor relaunches from last-good', HANG_EXIT_CODE)
        _run_abort_hooks()
        if tst.active and tst.sink is not None:
            try:
                tst.sink.close()
            except Exception:  # noqa: BLE001
                pass
        # os._exit, not sys.exit: the hung thread is wedged and will never
        # unwind; atexit hooks would block on it forever
        os._exit(HANG_EXIT_CODE)


def stop():
    """Tear the monitor thread down (telemetry shutdown / test resets).
    No-op when it never started."""
    with _state.lock:
        th, ev = _state.thread, _state.stop_ev
        _state.thread = _state.stop_ev = None
    if ev is not None:
        ev.set()
    if th is not None:
        th.join(timeout=5)


def _reset_for_tests():
    global _state
    stop()
    with _hook_lock:
        del _abort_hooks[:]
    _state = _WState()
