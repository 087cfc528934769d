"""Goodput accounting, the counterpart of ``mxnet_tpu/telemetry/goodput.py``:
where every second of the run's wall clock went.

Every second of measured wall clock is classified into a named bucket:

- ``step``        productive training compute (dispatch and fetch)
- ``compile``     the port's own compiles: the ``cuda.compile_secs``
                  counter, fed by the lazy nvcc build of a kernel library
                  (``ops/_build.py``) and NVRTC (``ops/nvrtc.py``), the
                  counterpart of the JAX package's ``xla.compile_secs``
- ``input_wait``  the host waiting on or preparing input (draw and put)
- ``checkpoint``  checkpoint capture and save time
- ``eval``        the evaluation and inference loops
- ``comm``        the collective share of the step (none on one card:
                  ``comm_pct`` is None until the roofline plane is ported)
- ``rework``      steps trained again after a restart (:func:`note_rework`
                  has no caller until ``resilient_fit`` is ported)
- ``overhead``    everything unattributed: the wall minus the sum above

Buckets plus overhead sum to the wall clock exactly: overhead is the
unclamped remainder, so over-attribution shows as negative overhead. Only
LEAF spans feed the buckets (a parent such as ``fit.batch`` counted beside
its children would break the sum). The spans time the host: on the card a
dispatch is the host's launch time, and the device's time lands where the
host first waits for it (``fused_fit.fetch``, or the metric's read-back in
``fit.metric``, which no bucket takes and which stays in overhead, as in
the JAX package).

:func:`compute` is pure and gives the JAX package's dict for the same
snapshot (with this port's compile counter in place of XLA's).

Gating: ``MXTPU_GOODPUT`` (default on) and ``MXTPU_TELEMETRY=1``. Telemetry
off = no registry writes and no I/O.
"""
import threading
import time

__all__ = ['BUCKETS', 'COMPILE_COUNTER', 'enabled', 'compute', 'note_rework',
           'current', 'summarize', 'snapshot_goodput', 'local_stats']

# the order of the buckets is the contract: the summary block and the JSONL
# record render in it
BUCKETS = ('step', 'compile', 'input_wait', 'checkpoint', 'eval', 'comm',
           'rework', 'overhead')

# the counter of the port's compile seconds (ops/_build.py, ops/nvrtc.py)
COMPILE_COUNTER = 'cuda.compile_secs'

# leaf span families feeding each raw bucket (histogram sums are ms).
# fused_fit.build is where the fused window's programs are made, so
# compile seconds landing there are not counted twice.
STEP_SPANS = ('fit.dispatch', 'fused_fit.dispatch', 'fused_fit.fetch')
INPUT_SPANS = ('fit.draw', 'fused_fit.draw', 'fused_fit.put')
EVAL_SPANS = ('eval.dispatch', 'eval.metric', 'eval.fetch',
              'fused_eval.draw', 'fused_eval.put', 'fused_eval.dispatch',
              'fused_eval.fetch')
CKPT_SPANS = ('ckpt.save', 'ckpt.capture')
BUILD_SPANS = ('fused_fit.build',)


class _GState:
    __slots__ = ('decided', 'active', 'rework_steps', 'prior_lost_s',
                 'last', 'lock')

    def __init__(self):
        self.decided = False
        self.active = False
        self.rework_steps = 0
        self.prior_lost_s = 0.0
        self.last = None
        self.lock = threading.Lock()


_state = _GState()
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
        on, prior = False, 0.0
        if _tele().active:
            from ..config import flags
            flags.reload('MXTPU_GOODPUT')
            flags.reload('MXTPU_GOODPUT_LOST_S')
            on = bool(flags.get('MXTPU_GOODPUT'))
            prior = float(flags.get('MXTPU_GOODPUT_LOST_S'))
        _state.active = on
        _state.prior_lost_s = max(0.0, prior)
        _state.decided = True
    return _state.active


def enabled():
    return _state.active if _state.decided else _decide()


def _emit(rec):
    st = _tele()
    if st.active and st.sink is not None:
        st.sink.emit(rec)


# ---------------------------------------------------------------------------
# the pure arithmetic
# ---------------------------------------------------------------------------

def _span_sum_s(hists, names):
    total = 0.0
    for name in names:
        h = hists.get(name)
        if h:
            total += float(h.get('sum') or 0.0)
    return total / 1e3


def compute(snapshot, elapsed_s, rework_steps=0, total_steps=None,
            comm_pct=None, comm_source=None, prior_lost_s=0.0):
    """Classify ``elapsed_s`` wall-clock seconds into the named buckets from
    a registry snapshot (histogram ``sum`` values and counters). Pure: no
    registry access, no flag reads.

    - ``comm_pct``/``comm_source`` carve the collective share out of the
      step bucket, with its provenance (measured or modeled);
    - ``rework_steps`` prices that many steps at the run's mean cost a step
      and moves them from ``step`` to ``rework``;
    - ``overhead`` is the unclamped remainder, so the buckets and overhead
      always sum to ``elapsed_s``.
    """
    elapsed_s = max(0.0, float(elapsed_s or 0.0))
    hists = snapshot.get('histograms') or {}
    counters = snapshot.get('counters') or {}
    step_s = _span_sum_s(hists, STEP_SPANS)
    input_s = _span_sum_s(hists, INPUT_SPANS)
    eval_s = _span_sum_s(hists, EVAL_SPANS)
    ckpt_s = _span_sum_s(hists, CKPT_SPANS)
    build_s = _span_sum_s(hists, BUILD_SPANS)
    compile_s = float(counters.get(COMPILE_COUNTER) or 0.0)
    # compile overlap: a window's build has its own span (not otherwise
    # bucketed); a per-batch loop's kernel build happens inside the first
    # fit.dispatch. Compile seconds not covered by a build come out of the
    # step bucket, or they would count twice.
    in_build = min(compile_s, build_s)
    step_s = max(0.0, step_s - min(compile_s - in_build, step_s))
    comm_s = 0.0
    if comm_pct is not None and comm_pct > 0.0:
        comm_s = step_s * min(100.0, float(comm_pct)) / 100.0
        step_s -= comm_s
    rework_s = 0.0
    rework_steps = max(0, int(rework_steps or 0))
    if rework_steps and total_steps:
        per_step = step_s / max(1, int(total_steps))
        rework_s = min(step_s, per_step * rework_steps)
        step_s -= rework_s
    buckets = {
        'step': step_s,
        'compile': compile_s,
        'input_wait': input_s,
        'checkpoint': ckpt_s,
        'eval': eval_s,
        'comm': comm_s,
        'rework': rework_s,
    }
    attributed = sum(buckets.values())
    buckets['overhead'] = elapsed_s - attributed
    badput = [(v, k) for k, v in buckets.items()
              if k != 'step' and v > 0.0]
    out = {
        'wall_s': round(elapsed_s, 3),
        'buckets': {k: round(buckets[k], 3) for k in BUCKETS},
        'goodput_pct': round(100.0 * step_s / elapsed_s, 2)
        if elapsed_s > 0.0 else 0.0,
        'badput_top': max(badput)[1] if badput else None,
        'rework_steps': rework_steps,
    }
    if comm_pct is not None:
        out['comm_source'] = comm_source or 'modeled'
    prior_lost_s = max(0.0, float(prior_lost_s or 0.0))
    if prior_lost_s > 0.0:
        job_wall = elapsed_s + prior_lost_s
        out['prior_lost_s'] = round(prior_lost_s, 3)
        out['job_wall_s'] = round(job_wall, 3)
        out['job_goodput_pct'] = round(100.0 * step_s / job_wall, 2) \
            if job_wall > 0.0 else 0.0
    return out


# ---------------------------------------------------------------------------
# live feeds
# ---------------------------------------------------------------------------

def note_rework(steps):
    """Record ``steps`` steps trained again after a restart (the span
    between the restored checkpoint and the step the failed attempt had
    reached); their re-priced seconds land in the ``rework`` bucket."""
    if not enabled():
        return
    steps = max(0, int(steps))
    if not steps:
        return
    with _state.lock:
        _state.rework_steps += steps
        total = _state.rework_steps
    _tele().registry.gauge('goodput.rework_steps').set(total)


def _compute_live(snap, elapsed_s):
    with _state.lock:
        rework = _state.rework_steps
    total_steps = int((snap.get('counters') or {}).get('fit.steps') or 0)
    # one card has no collective: no comm share (the roofline plane that
    # would model one is not ported)
    return compute(snap, elapsed_s, rework_steps=rework,
                   total_steps=total_steps, comm_pct=None,
                   prior_lost_s=_state.prior_lost_s), rework


def current():
    """The goodput dict from the live registry now (no gauges published, no
    record emitted), or None while off."""
    if not enabled():
        return None
    st = _tele()
    return _compute_live(st.registry.snapshot(), time.time() - st.t_start)[0]


def local_stats():
    """``(goodput_pct, index of the top badput bucket in BUCKETS)``, NaN
    where not available: this host's share of the cluster's sync vector."""
    nan = float('nan')
    g = current()
    if g is None or not g['wall_s']:
        return nan, nan
    top = g.get('badput_top')
    return (float(g['goodput_pct']),
            float(BUCKETS.index(top)) if top in BUCKETS else nan)


def summarize(elapsed_s=None):
    """The end-of-run hook (telemetry.write_summary): compute the
    attribution, publish the ``goodput.*`` gauges and the ``goodput`` JSONL
    record, and return the dict (None while off)."""
    if not enabled():
        return None
    st = _tele()
    if elapsed_s is None:
        elapsed_s = time.time() - st.t_start
    out, rework = _compute_live(st.registry.snapshot(), elapsed_s)
    reg = st.registry
    reg.gauge('goodput.goodput_pct').set(out['goodput_pct'])
    for name in BUCKETS:
        reg.gauge('goodput.%s_s' % name).set(out['buckets'][name])
    if out.get('badput_top'):
        reg.gauge('goodput.badput_top').set(out['badput_top'])
    if rework:
        reg.gauge('goodput.rework_steps').set(rework)
    if out.get('prior_lost_s'):
        reg.gauge('goodput.prior_lost_s').set(out['prior_lost_s'])
        reg.gauge('goodput.job_goodput_pct').set(out['job_goodput_pct'])
    rec = {'type': 'goodput'}
    rec.update(out)
    _emit(rec)
    with _state.lock:
        _state.last = out
    return out


def snapshot_goodput():
    """The last summarize() result, or None."""
    with _state.lock:
        return dict(_state.last) if _state.last else None


def _reset_for_tests():
    global _state
    _state = _GState()
