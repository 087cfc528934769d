"""Step timeline, the counterpart of ``mxnet_tpu/telemetry/timeline.py``:
what a training step is made of, by phase.

- **the step-phase ledger**: the fit loops already emit a span for every
  host-side phase (draw, put, dispatch, fetch, checkpoint, kvstore push
  and pull); :func:`note_span` adds each leaf span's time to its phase
  (:data:`PHASE_SPANS`) and :func:`note_step` counts the steps and the
  wall between them, so that the phases read as milliseconds a step;
- **the decomposition** (:func:`decompose`, :func:`attribute`): a step
  split into compute, collective wait, io (draw + put) and host-side
  (fetch + checkpoint + kvstore) time, and the phase that takes the most
  named (``timeline.critical_phase``); the pure functions give the JAX
  package's results for the same inputs.

The spans time the host. On the card a dispatch is the host's launch time,
and the device's time lands where the host first waits for it: the fused
window's ``fused_fit.fetch``, or in the per-batch loop the metric's read of
the outputs (``fit.metric``, which this ledger counts as fetch).

Not ported: the sync-round half (:func:`note_sync_exit` with its
clock-skew fault seam, :func:`local_slots`, :func:`publish_round` and the
per-host clock-offset rings), which waits for the cluster plane and
``faults.py`` (ROADMAP.md §1 items 12 and 13); reaching it raises
NotImplementedError. Without a sync round the end-of-run summary is this
host's own attribution (:func:`summarize`).

Gating: ``MXTPU_TIMELINE=1`` and ``MXTPU_TELEMETRY=1``. Off = one cached
bool check an entry point, no registry writes, no I/O.
"""
import math
import threading
import time

import numpy as np

__all__ = ['PHASES', 'PHASE_SPANS', 'SLOTS', 'enabled', 'note_span',
           'note_step', 'note_sync_exit', 'local_slots', 'estimate_offsets',
           'decompose', 'attribute', 'publish_round', 'summarize',
           'snapshot_timeline', 'phase_breakdown']

# the ledger's phases, in sync-vector slot order (SLOTS[2 + k] carries
# PHASES[k]); 'collective' and 'compute' are derived, never shipped
PHASES = ('draw', 'put', 'dispatch', 'fetch', 'checkpoint', 'kvstore')

# this plane's slots of cluster.SYNC_KEYS, in order: the clock pair, then
# each phase's milliseconds a step
SLOTS = ('clock_wall_s', 'clock_mono_s', 'tl_draw_ms', 'tl_put_ms',
         'tl_dispatch_ms', 'tl_fetch_ms', 'tl_ckpt_ms', 'tl_kv_ms')

# LEAF span -> phase. Only leaves: a parent like fit.batch would count its
# children's time twice.
PHASE_SPANS = {
    'fit.draw': 'draw', 'fused_fit.draw': 'draw',
    'fused_fit.put': 'put',
    'fit.dispatch': 'dispatch', 'fused_fit.dispatch': 'dispatch',
    'bench.dispatch': 'dispatch',
    'fused_fit.fetch': 'fetch', 'fit.metric': 'fetch',
    'ckpt.save': 'checkpoint', 'ckpt.capture': 'checkpoint',
    'kvstore.push': 'kvstore', 'kvstore.pull': 'kvstore',
}

# the float32-safe window of the clock samples (the JAX package's
# CLOCK_MOD): the offset math is circular over it
CLOCK_MOD = 64.0

_SYNC_HALF = ('the sync-round half of the step timeline (clock alignment '
              'across hosts) is not ported yet (ROADMAP.md §1 items 12 and '
              '13)')


def _wrap(d):
    """Centre a CLOCK_MOD-circular difference into [-32 s, +32 s)."""
    return float(d - CLOCK_MOD * np.floor(d / CLOCK_MOD + 0.5))


class _TState:
    __slots__ = ('decided', 'active', 'lock', 'steps', 'wall_ms', 'last_t',
                 'phase_ms', 'last')

    def __init__(self):
        self.decided = False
        self.active = False
        self.lock = threading.Lock()
        self.steps = 0
        self.wall_ms = 0.0          # wall between note_step calls
        self.last_t = None
        self.phase_ms = {p: 0.0 for p in PHASES}   # cumulative, run-long
        self.last = None            # the last attribution dict


_state = _TState()
_decide_lock = threading.Lock()


def _tele():
    """The telemetry package's state (deciding it from the flag first)."""
    from . import enabled as _tele_enabled, _state as st
    _tele_enabled()
    return st


def _decide():
    with _decide_lock:
        if _state.decided:
            return _state.active
        on = False
        if _tele().active:
            from ..config import flags
            flags.reload('MXTPU_TIMELINE')
            on = bool(flags.get('MXTPU_TIMELINE'))
        _state.active = on
        _state.decided = True
    return _state.active


def enabled():
    """Whether the timeline is on: MXTPU_TIMELINE=1 and MXTPU_TELEMETRY=1,
    decided once. One attribute check after the first call."""
    if _state.decided:
        return _state.active
    return _decide()


# ---------------------------------------------------------------------------
# the local ledger
# ---------------------------------------------------------------------------

def note_span(name, dur_ms):
    """The span tap (telemetry._Span.__exit__): add a finished leaf span's
    time to its phase. A span of no phase costs one dict miss."""
    if not enabled():
        return
    p = PHASE_SPANS.get(name)
    if p is None:
        return
    with _state.lock:
        _state.phase_ms[p] += dur_ms


def note_step(steps=1):
    """The fit loops' hook: count trained steps and the wall between calls,
    which the ledger divides by."""
    if not enabled():
        return
    now = time.time()
    st = _state
    with st.lock:
        if st.last_t is not None and steps > 0:
            st.wall_ms += (now - st.last_t) * 1e3
        st.last_t = now
        st.steps += steps


def note_sync_exit():
    raise NotImplementedError('timeline.note_sync_exit: ' + _SYNC_HALF)


def local_slots():
    raise NotImplementedError('timeline.local_slots: ' + _SYNC_HALF)


def publish_round(mat, host_ids, steps):
    raise NotImplementedError('timeline.publish_round: ' + _SYNC_HALF)


# ---------------------------------------------------------------------------
# the pure functions
# ---------------------------------------------------------------------------

def estimate_offsets(walls):
    """One round's wall samples -> each row's offset_ms against the fleet's
    median (NaN rows stay NaN). The samples arrive modulo CLOCK_MOD, so the
    math is circular: deltas against the first finite sample, centred into
    ±CLOCK_MOD/2, then re-based on their median."""
    walls = np.asarray(walls, np.float64)
    valid = np.isfinite(walls)
    if not valid.any():
        return [float('nan')] * len(walls)
    anchor = float(walls[valid][0])
    d = np.array([_wrap(w - anchor) for w in walls])
    ref = float(np.median(d[valid]))
    return [float((x - ref) * 1e3) if ok else float('nan')
            for x, ok in zip(d, valid)]


def _finite(v):
    try:
        return v is not None and math.isfinite(float(v))
    except (TypeError, ValueError):
        return False


def decompose(step_ms, phases, comm_pct=None):
    """One host's step decomposition (ms): collective wait from the comm
    share, io = draw + put, host-side = fetch + checkpoint + kvstore,
    compute = the clamped remainder."""
    step = float(step_ms) if _finite(step_ms) else None

    def f(name):
        v = phases.get(name)
        return float(v) if _finite(v) else 0.0
    coll = step * float(comm_pct) / 100.0 \
        if step is not None and _finite(comm_pct) else 0.0
    io = f('draw') + f('put')
    host = f('fetch') + f('checkpoint') + f('kvstore')
    compute = max(0.0, step - coll - io - host) if step is not None else 0.0
    return {'compute_ms': compute, 'collective_ms': coll, 'io_ms': io,
            'host_ms': host}


def attribute(mat, host_ids=None, step=None, offsets=None):
    """The critical-path attribution of one matrix of sync vectors (one row
    a host, cluster.SYNC_KEYS columns): each host's decomposition, the skew
    (slowest minus fastest step) and the gating host and phase: the phase on
    the slowest host with the largest excess over the fleet's best (on one
    host, the largest share)."""
    from . import cluster as _cluster
    mat = np.asarray(mat, np.float64)
    if mat.ndim == 1:
        mat = mat[None, :]
    n = mat.shape[0]
    if host_ids is None:
        host_ids = _cluster._host_ids(mat)
    keys = _cluster.SYNC_KEYS

    def col(name):
        j = keys.index(name)
        return [float(mat[i, j]) if j < mat.shape[1] else float('nan')
                for i in range(n)]

    times = col('step_time_ms')
    comms = col('comm_pct')
    phase_cols = {p: col(SLOTS[2 + k]) for k, p in enumerate(PHASES)}
    decomps = []
    per_host = []
    for i in range(n):
        phases = {p: phase_cols[p][i] for p in PHASES}
        d = decompose(times[i], phases,
                      comms[i] if _finite(comms[i]) else None)
        decomps.append(d)
        row = {'host': host_ids[i],
               'step_time_ms': round(times[i], 3) if _finite(times[i])
               else None}
        row.update({k: round(v, 3) for k, v in d.items()})
        row['phases'] = {p: round(phases[p], 3) if _finite(phases[p])
                         else None for p in PHASES}
        if offsets and host_ids[i] in offsets:
            row['clock_offset_ms'] = round(offsets[host_ids[i]], 3)
        per_host.append(row)
    out = {'hosts': n, 'per_host': per_host}
    if step is not None:
        out['step'] = int(step)
    valid = [i for i in range(n) if _finite(times[i])]
    if not valid:
        return out
    crit = max(valid, key=lambda i: times[i])
    tmax, tmin = times[crit], min(times[i] for i in valid)
    out['gang_step_ms'] = round(tmax, 3)
    out['skew_ms'] = round(tmax - tmin, 3) if len(valid) > 1 else 0.0
    out['critical_host'] = host_ids[crit]
    cand = {}
    series = {p: phase_cols[p] for p in PHASES}
    series['compute'] = [d['compute_ms'] for d in decomps]
    series['collective'] = [d['collective_ms'] for d in decomps]
    for name, vals in series.items():
        v = vals[crit]
        if not _finite(v):
            continue
        if len(valid) > 1:
            others = [vals[i] for i in valid if _finite(vals[i])]
            if not others:
                continue
            cand[name] = float(v) - min(float(o) for o in others)
        else:
            cand[name] = float(v)
    if cand:
        phase = max(sorted(cand), key=lambda k: cand[k])
        out['critical_phase'] = phase
        out['phase_excess_ms'] = round(max(0.0, cand[phase]), 3)
    return out


# ---------------------------------------------------------------------------
# publication and summary
# ---------------------------------------------------------------------------

def _publish_snapshot(out):
    """The gauges, the JSONL record and the stored snapshot of one
    attribution dict."""
    st = _tele()
    reg = st.registry
    if out.get('gang_step_ms') is not None:
        reg.gauge('timeline.gang_step_ms').set(out['gang_step_ms'])
    if out.get('skew_ms') is not None:
        reg.gauge('timeline.skew_ms').set(out['skew_ms'])
    if out.get('critical_host') is not None:
        reg.gauge('timeline.critical_host').set(out['critical_host'])
    if out.get('critical_phase') is not None:
        reg.gauge('timeline.critical_phase').set(out['critical_phase'])
    with _state.lock:
        _state.last = out
    if st.sink is not None:
        rec = {'type': 'timeline'}
        rec.update(out)
        st.sink.emit(rec)


def _local_attribution():
    """This host's attribution from its own ledger: the wall a step from
    the note_step stream, the phases from the span tap, no comm share (one
    card). None before any counted step."""
    st = _state
    with st.lock:
        steps = st.steps
        wall_ms = st.wall_ms
        phases = {p: st.phase_ms[p] for p in PHASES}
    if steps <= 0:
        return None
    from . import cluster as _cluster
    keys = _cluster.SYNC_KEYS
    row = [float('nan')] * len(keys)
    # the first note_step opens the wall window, so in the per-batch loop
    # wall_ms spans steps - 1 intervals; the fused loop notes whole
    # windows. As in the JAX package the denominator is the step count.
    if wall_ms > 0:
        step_ms = wall_ms / steps
    else:
        # a run that fits in one window never opened a wall interval: the
        # span histograms, normalised a step
        snap = _tele().registry.snapshot()
        hists, gauges = snap['histograms'], snap['gauges']
        h = hists.get('fit.batch')
        w = gauges.get('fused_fit.steps_per_call')
        if h and h.get('count') and h.get('p50') is not None:
            step_ms = float(h['p50'])
        elif w:
            h = hists.get('fused_fit.dispatch')
            step_ms = float(h['p50']) / float(w) \
                if h and h.get('count') and h.get('p50') is not None \
                else float('nan')
        else:
            step_ms = float('nan')
    row[keys.index('step_time_ms')] = step_ms
    row[keys.index('proc_index')] = float(_cluster.host_index())
    for k, p in enumerate(PHASES):
        row[keys.index(SLOTS[2 + k])] = phases[p] / steps
    return attribute([row], step=steps)


def summarize():
    """The end-of-run roll-up (telemetry.write_summary): the last published
    attribution, else this host's own from the local ledger, published.
    Returns the summary record's 'timeline' dict, or None."""
    if not enabled():
        return None
    with _state.lock:
        last = dict(_state.last) if _state.last else None
    if last is not None:
        return last
    out = _local_attribution()
    if out is None:
        return None
    _publish_snapshot(out)
    return out


def snapshot_timeline():
    """The last attribution, or None."""
    with _state.lock:
        return dict(_state.last) if _state.last else None


def phase_breakdown():
    """{compute,collective,io,host}_pct of the step, from the last
    attribution or a local one derived read-only. None while off or before
    any counted step."""
    if not enabled():
        return None
    out = snapshot_timeline() or _local_attribution()
    if not out or not out.get('per_host'):
        return None
    rows = out['per_host']
    crit = out.get('critical_host')
    row = next((r for r in rows if r.get('host') == crit), rows[0])
    step = row.get('step_time_ms')
    if not step:
        return None
    return {k + '_pct': round(100.0 * (row.get(k + '_ms') or 0.0) / step, 2)
            for k in ('compute', 'collective', 'io', 'host')}


def _reset_for_tests():
    global _state
    _state = _TState()
