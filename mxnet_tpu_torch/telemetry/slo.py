"""SLO plane, the counterpart of ``mxnet_tpu/telemetry/slo.py``:
latency/error objectives, burn rate, degraded /healthz.

Configurable service-level objectives over the serving request stream:

- ``MXTPU_SLO_LATENCY_MS`` — a request slower than this counts as bad,
  exactly like a server-side error;
- ``MXTPU_SLO_ERROR_PCT`` — the error budget: the allowed share (%) of
  bad requests. With only the latency objective set the budget defaults
  to :data:`_DEFAULT_BUDGET_PCT` (1%).

Every completed request feeds :func:`note_request`. Over a rolling
window of the last ``MXTPU_SLO_WINDOW`` requests the module derives the
**burn rate** (bad share / budget: 1.0 = burning the budget exactly as
fast as allowed) and publishes the ``slo.*`` gauges on ``/metrics``:
``slo.latency_objective_ms``, ``slo.error_budget_pct``, ``slo.bad_pct``
(rolling), ``slo.burn_rate`` (rolling), ``slo.budget_remaining_pct``
(cumulative since start), ``slo.window_requests``, ``slo.degraded``
(0/1).

Sustained burn (``burn_rate >= 1`` with at least :data:`_MIN_REQUESTS`
requests in the window) flips ``/healthz`` to the ``slo_degraded`` state
(503); it clears once fresh traffic meets the objectives again. Each
degraded transition emits an ``slo`` JSONL record and dumps the flight
recorder (``flight-slo-burn.jsonl``).

Gating: ``MXTPU_TELEMETRY=1`` *and* at least one objective set. Off =
one cached-bool check per request, no state, no gauges. Client-side
rejects (malformed bodies, 400s) do NOT burn the budget; only server-side
failures and objective-breaking latencies count.
"""
import collections
import logging
import threading
import time

__all__ = ['enabled', 'note_request', 'degraded', 'snapshot_slo']

_DEFAULT_BUDGET_PCT = 1.0   # budget when only the latency objective set
_MIN_REQUESTS = 16          # window floor before a degraded verdict
_DEGRADE_BURN = 1.0         # burn rate at/above which the state flips
_STALE_S = 120.0            # degraded + this long with NO requests =
                            # self-clear: a load balancer that pulls a
                            # 503 replica starves it of the fresh
                            # traffic recovery needs, so a frozen bad
                            # window must not pin the state forever


class _SState:
    __slots__ = ('decided', 'active', 'latency_ms', 'budget_pct',
                 'window', 'ring', 'total', 'total_bad', 'degraded',
                 'last_note', 'lock')

    def __init__(self):
        self.decided = False
        self.active = False
        self.latency_ms = 0.0
        self.budget_pct = 0.0
        self.window = 0
        self.ring = None          # deque of per-request bad bools
        self.total = 0
        self.total_bad = 0
        self.degraded = False
        self.last_note = None     # monotonic stamp of the last request
        self.lock = threading.Lock()


_state = _SState()
_decide_lock = threading.Lock()


def _tele():
    """The telemetry package state (deciding it from the flag first)."""
    from . import enabled as _tele_enabled, _state as st
    _tele_enabled()
    return st


def _decide():
    # decide telemetry before taking our lock (the telemetry decide
    # runs sink/flight side effects — same re-entrancy discipline as
    # flight._decide)
    tele_on = _tele().active
    with _decide_lock:
        if _state.decided:
            return _state.active
        lat = err = 0.0
        window = 128
        if tele_on:
            from ..config import flags
            for name in ('MXTPU_SLO_LATENCY_MS', 'MXTPU_SLO_ERROR_PCT',
                         'MXTPU_SLO_WINDOW'):
                flags.reload(name)
            lat = float(flags.get('MXTPU_SLO_LATENCY_MS'))
            err = float(flags.get('MXTPU_SLO_ERROR_PCT'))
            window = int(flags.get('MXTPU_SLO_WINDOW'))
        on = lat > 0.0 or err > 0.0
        _state.latency_ms = lat
        _state.budget_pct = err if err > 0.0 else \
            (_DEFAULT_BUDGET_PCT if lat > 0.0 else 0.0)
        _state.window = window
        if on:
            _state.ring = collections.deque(maxlen=window)
            reg = _tele().registry
            if lat > 0.0:
                reg.gauge('slo.latency_objective_ms').set(lat)
            reg.gauge('slo.error_budget_pct').set(_state.budget_pct)
        _state.active = on
        _state.decided = True
    return _state.active


def enabled():
    """Whether the SLO plane is armed: MXTPU_TELEMETRY=1 and at least
    one of MXTPU_SLO_LATENCY_MS / MXTPU_SLO_ERROR_PCT set, decided
    once. One attribute check after the first call — the serving
    loop's gate."""
    if _state.decided:
        return _state.active
    return _decide()


def note_request(latency_ms, error=False):
    """Feed one completed request: its latency (ms) and whether it
    failed server-side. Updates the rolling window, the ``slo.*``
    gauges and the degraded state; emits the transition record + the
    flight dump on a flip. Off = one cached-bool check."""
    if not enabled():
        return None
    st = _state
    bad = bool(error) or (st.latency_ms > 0.0
                          and float(latency_ms) > st.latency_ms)
    flipped = None
    with st.lock:
        st.last_note = time.monotonic()
        st.ring.append(bad)
        st.total += 1
        st.total_bad += int(bad)
        n = len(st.ring)
        n_bad = sum(st.ring)
        bad_pct = 100.0 * n_bad / n
        burn = bad_pct / st.budget_pct if st.budget_pct else 0.0
        # cumulative budget remaining: how much of the allowed bad
        # share the run has consumed since start (floored at 0)
        allowed = st.total * st.budget_pct / 100.0
        remaining = max(0.0, 1.0 - (st.total_bad / allowed)) * 100.0 \
            if allowed > 0 else 100.0
        want_degraded = n >= _MIN_REQUESTS and burn >= _DEGRADE_BURN
        if want_degraded != st.degraded:
            st.degraded = want_degraded
            flipped = want_degraded
    reg = _tele().registry
    reg.gauge('slo.bad_pct').set(round(bad_pct, 2))
    reg.gauge('slo.burn_rate').set(round(burn, 3))
    reg.gauge('slo.budget_remaining_pct').set(round(remaining, 2))
    reg.gauge('slo.window_requests').set(n)
    reg.gauge('slo.degraded').set(int(st.degraded))
    if flipped is not None:
        _transition(flipped, bad_pct, burn)
    return bad


def _transition(now_degraded, bad_pct, burn):
    """One degraded/recovered flip: JSONL record, log line, and (on
    the way DOWN) the flight dump — the window before the burn is
    exactly what the postmortem wants. Guarded throughout: this runs
    inside note_request, which the batcher's failure path calls while
    resolving per-request futures — a forensics error here must never
    strand a caller."""
    try:
        st = _tele()
        rec = {'type': 'slo',
               'event': 'degraded' if now_degraded else 'recovered',
               'bad_pct': round(bad_pct, 2),
               'burn_rate': round(burn, 3),
               'latency_objective_ms': _state.latency_ms or None,
               'error_budget_pct': _state.budget_pct}
        if st.sink is not None:
            st.sink.emit(rec)
            st.sink.flush()
        if now_degraded:
            logging.warning(
                'slo: error budget burning at %.1fx (%.1f%% bad '
                'requests against a %.1f%% budget) — /healthz now '
                'answers slo_degraded', burn, bad_pct,
                _state.budget_pct)
            from . import flight
            flight.dump('slo-burn')
        else:
            logging.warning('slo: burn recovered (%.1f%% bad, burn '
                            '%.2fx) — /healthz back to ok', bad_pct,
                            burn)
    except Exception as e:  # noqa: BLE001 — see docstring
        logging.debug('slo: transition reporting failed: %s', e)


def degraded():
    """The active SLO-degraded digest (burn >= 1 sustained over the
    rolling window), or None. telemetry/serve.py answers /healthz 503
    with status ``slo_degraded`` on it — distinct from ``hung``
    (watchdog).

    Staleness decay: a degraded replica a load balancer pulled on the
    503 receives no fresh traffic, and the frozen bad window would
    otherwise pin it out of service forever; after :data:`_STALE_S`
    seconds with zero requests the state (and the stale window)
    self-clears so the replica can rejoin and be re-judged on live
    traffic."""
    if not enabled() or not _state.degraded:
        return None
    st = _state
    cleared = False
    with st.lock:
        if st.degraded and st.last_note is not None and \
                time.monotonic() - st.last_note > _STALE_S:
            st.degraded = False
            st.ring.clear()
            cleared = True
    if cleared:
        _tele().registry.gauge('slo.degraded').set(0)
        logging.warning('slo: degraded state stale (%.0fs with no '
                        'requests) — clearing so the replica can '
                        'rejoin and be re-judged', _STALE_S)
        return None
    return snapshot_slo()


def snapshot_slo():
    """Point-in-time SLO dict (JSON-safe) for /healthz, /summary and
    the watch CLI; None while the plane is off."""
    if not enabled():
        return None
    st = _state
    with st.lock:
        n = len(st.ring)
        n_bad = sum(st.ring)
        bad_pct = 100.0 * n_bad / n if n else 0.0
        burn = bad_pct / st.budget_pct if st.budget_pct else 0.0
        allowed = st.total * st.budget_pct / 100.0
        remaining = max(0.0, 1.0 - (st.total_bad / allowed)) * 100.0 \
            if allowed > 0 else 100.0
        return {'latency_objective_ms': st.latency_ms or None,
                'error_budget_pct': st.budget_pct,
                'window_requests': n,
                'bad_pct': round(bad_pct, 2),
                'burn_rate': round(burn, 3),
                'budget_remaining_pct': round(remaining, 2),
                'degraded': bool(st.degraded)}


def _reset_for_tests():
    global _state
    _state = _SState()
