"""Incident flight recorder, the counterpart of
``mxnet_tpu/telemetry/flight.py``: a bounded in-memory black box.

A fixed-size in-memory ring (``MXTPU_FLIGHT_RECORDER`` slots, default
2048, on whenever telemetry is on) retains the most recent telemetry
records (spans, request traces, SLO and hang records) at the cost of one
deque append per record, no I/O and no thread.

Each ported incident path dumps the ring to ``flight-<reason>.jsonl``
next to the telemetry log the moment the incident is on record:

- ``flight-hang.jsonl``       — watchdog stall (telemetry/watchdog.py);
- ``flight-slo-burn.jsonl``   — SLO error-budget burn (telemetry/slo.py);
- ``flight-nonfinite.jsonl``  — a non-finite training step
  (telemetry/health.py);
- ``flight-restart.jsonl``    — a supervised restart
  (module/resilient_fit.py through health.note_restart).

(The JAX package's OOM dump comes with the memory plane.) The dump
carries a ``flight`` header record (reason, ring size,
wall time) followed by the retained records oldest-first: the seconds
BEFORE the incident. Dumps are bounded per reason
(:data:`_MAX_DUMPS_PER_REASON`, newest wins).

Feeding: :func:`note` is called from the JSONL sink's emit chokepoint,
so everything that would reach the log (including records a size-capped
sink drops) enters the ring too.

Gating: ``MXTPU_TELEMETRY=1`` and ``MXTPU_FLIGHT_RECORDER > 0`` (the
default). Off = no ring is ever allocated and every entry point is one
cached-bool check.
"""
import collections
import json
import logging
import os
import threading
import time

__all__ = ['enabled', 'note', 'dump', 'snapshot_flight']

_MAX_DUMPS_PER_REASON = 5


class _FState:
    __slots__ = ('decided', 'active', 'size', 'ring', 'dumps', 'lock')

    def __init__(self):
        self.decided = False
        self.active = False
        self.size = 0
        self.ring = None
        self.dumps = {}       # reason -> dump count
        self.lock = threading.Lock()


_state = _FState()
_decide_lock = threading.Lock()


def _tele():
    """The telemetry package state (deciding it from the flag first)."""
    from . import enabled as _tele_enabled, _state as st
    _tele_enabled()
    return st


def _decide():
    # decide telemetry BEFORE taking our lock: the telemetry decide
    # emits the 'start' record through the sink, whose emit chokepoint
    # re-enters flight.note()/_decide() on this same thread — a
    # non-reentrant lock held across it would deadlock the process at
    # first telemetry use
    tele_on = _tele().active
    with _decide_lock:
        if _state.decided:
            return _state.active
        size = 0
        if tele_on:
            from ..config import flags
            flags.reload('MXTPU_FLIGHT_RECORDER')
            size = int(flags.get('MXTPU_FLIGHT_RECORDER'))
        _state.size = size
        if size > 0:
            _state.ring = collections.deque(maxlen=size)
        _state.active = size > 0
        _state.decided = True
    return _state.active


def enabled():
    """Whether the recorder is on: MXTPU_TELEMETRY=1 and
    MXTPU_FLIGHT_RECORDER > 0, decided once. One attribute check after
    the first call — the emit chokepoint's gate."""
    if _state.decided:
        return _state.active
    return _decide()


def note(record):
    """Retain one telemetry record (a plain dict, already t/host
    stamped by the sink). Off = one cached-bool check; on = one
    (uncontended) lock + deque append — the lock is what lets a
    concurrent dump() snapshot the ring without a mutated-during-
    iteration RuntimeError voiding the incident's one recording."""
    if not enabled():
        return
    with _state.lock:
        _state.ring.append(record)


def snapshot_flight():
    """The ring's current contents, oldest first (tests/tools)."""
    if not enabled():
        return []
    with _state.lock:
        return list(_state.ring)


def _dump_path(reason):
    """flight-<reason>.jsonl next to the telemetry log (its directory
    is the run's one place artifacts land)."""
    from ..config import flags
    base = os.path.expanduser(flags.get('MXTPU_TELEMETRY_PATH')
                              or 'telemetry.jsonl')
    return os.path.join(os.path.dirname(base) or '.',
                        'flight-%s.jsonl' % reason)


def dump(reason, extra=None):
    """Write the ring to ``flight-<reason>.jsonl`` (overwriting a
    previous dump for the same reason — the newest incident's context
    wins; at most :data:`_MAX_DUMPS_PER_REASON` writes per reason).
    ``extra`` merges into the header record. Best-effort by contract:
    an incident path must never die of its own forensics. Returns the
    path, or None when off/bounded/failed."""
    if not enabled():
        return None
    with _state.lock:
        n = _state.dumps.get(reason, 0)
        if n >= _MAX_DUMPS_PER_REASON:
            return None
        _state.dumps[reason] = n + 1
        records = list(_state.ring)
    path = _dump_path(reason)
    head = {'type': 'flight', 'reason': reason, 't': time.time(),
            'records': len(records), 'ring_size': _state.size}
    if extra:
        head.update(extra)
    try:
        with open(path, 'w') as f:
            f.write(json.dumps(head) + '\n')
            for rec in records:
                try:
                    f.write(json.dumps(rec) + '\n')
                except (TypeError, ValueError):
                    continue   # a non-JSON-safe record must not void
                               # the rest of the recording
    except OSError as e:
        logging.warning('flight recorder: cannot write %s (%s)', path, e)
        return None
    logging.warning('flight recorder: dumped %d record(s) to %s '
                    '(reason: %s)', len(records), path, reason)
    return path


def _reset_for_tests():
    global _state
    _state = _FState()
