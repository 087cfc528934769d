"""Training-health sentinels, the counterpart of
``mxnet_tpu/telemetry/health.py``: why a run went bad, not just where the
time went.

The fused fit window runs W steps from one host call and fetches their
results once, so a NaN born at window step 3 would surface steps later as
a garbage loss with no attribution. Three pieces fix that:

- **sentinels on the step's device** (:func:`step_stats`): the global
  grad-norm, param-norm, update/param ratio and one finite flag per output,
  packed into one small f32 vector a step by a few stacked reductions
  (``torch._foreach_norm``) on the tensors where they live. The fused
  window stacks one row a step into a (W, k) matrix that comes home in the
  window's existing fetch, so a mid-window NaN keeps its exact step while
  the host still fetches once a window; the per-batch executor checks its
  row after each backward (that loop synchronises a batch anyway);
- **the first-bad-layer bisect**: on a non-finite flag, a once-a-process
  diagnostic replays the offending batch node by node
  (:meth:`~mxnet_tpu_torch.executor.Executor.first_nonfinite_node`) and
  names the first symbol whose value is non-finite;
- **anomaly detectors** (:class:`SpikeDetector`): rolling median/MAD
  detectors over step time, loss and grad-norm (a spike is k robust
  deviations from the trailing window's median), plus the input-bound
  classifier over the ``io.prefetch_wait`` spans, emitting ``health`` and
  ``anomaly`` JSONL records, ``health.*`` metrics and a "run health" block
  in the end-of-run summary.

Gating: ``MXTPU_HEALTH=1`` *and* ``MXTPU_TELEMETRY=1``. Off, this module
is a no-op: no registry writes, no I/O, no reduction on the device.
``MXTPU_HEALTH_ACTION`` picks what a non-finite incident does: ``warn``
(default) logs it, ``record`` only writes the JSONL record, ``raise``
raises :class:`TrainingHealthError` with the diagnostic attached. Spike
anomalies never raise.
"""
import collections
import logging
import threading

import numpy as np
import torch

__all__ = ['TrainingHealthError', 'enabled', 'step_stats', 'decode',
           'note_batch', 'note_step', 'note_window', 'note_step_time',
           'note_loss', 'note_restart', 'detector', 'SpikeDetector',
           'finite_report', 'has_nonfinite', 'summarize',
           'snapshot_health']

# fixed head of the sentinel vector; per-output finite flags follow
N_FIXED = 4
_IDX_FINITE, _IDX_GRAD, _IDX_PARAM, _IDX_RATIO = range(N_FIXED)

# warn-rate caps: incidents and per-detector anomalies log loudly a few
# times, then drop to debug (a fully-NaN epoch must not flood stderr)
_MAX_INCIDENT_WARNINGS = 3
_MAX_ANOMALY_WARNINGS = 3
_MAX_INCIDENTS_KEPT = 16    # incident dicts kept; the counter keeps the total

_INPUT_BOUND_PCT = 30.0   # io-wait share of the loops' time that classifies
                          # a run as input-bound

# span families whose summed time is the input-bound denominator
FUSED_FIT_LOOP_SPANS = ('fused_fit.draw', 'fused_fit.put',
                        'fused_fit.dispatch', 'fused_fit.fetch')
EVAL_LOOP_SPANS = ('eval.dispatch', 'eval.metric', 'eval.fetch',
                   'fused_eval.draw', 'fused_eval.put',
                   'fused_eval.dispatch', 'fused_eval.fetch')


class TrainingHealthError(RuntimeError):
    """Raised by MXTPU_HEALTH_ACTION=raise on a non-finite incident.
    ``diagnostic`` carries the incident record (source, step, window_step,
    first_bad_layer, the sentinel values)."""

    def __init__(self, message, diagnostic=None):
        super().__init__(message)
        self.diagnostic = dict(diagnostic or {})


class _HState:
    __slots__ = ('decided', 'active', 'action', 'incidents', 'anomaly_counts',
                 'last_anomaly', 'bisect_done', 'incident_warnings',
                 'anomaly_warnings', 'detectors', 'input_bound_noted',
                 'cur_step', 'lock')

    def __init__(self):
        self.decided = False
        self.active = False
        self.action = 'warn'
        self.incidents = []
        self.anomaly_counts = {}
        self.last_anomaly = None
        self.bisect_done = False
        self.incident_warnings = 0
        self.anomaly_warnings = {}
        self.detectors = {}
        self.input_bound_noted = False
        self.cur_step = None
        self.lock = threading.Lock()


_state = _HState()
_decide_lock = threading.Lock()


def _tele():
    """The telemetry package state (deciding it from the flag first)."""
    from . import enabled as _tele_enabled, _state as st
    _tele_enabled()
    return st


def _decide():
    with _decide_lock:
        if _state.decided:
            return _state.active
        on, action = False, 'warn'
        if _tele().active:
            from ..config import flags
            flags.reload('MXTPU_HEALTH')
            flags.reload('MXTPU_HEALTH_ACTION')
            on = bool(flags.get('MXTPU_HEALTH'))
            action = flags.get('MXTPU_HEALTH_ACTION')
        _state.active = on
        _state.action = action
        _state.decided = True
    return _state.active


def enabled():
    """Whether the health sentinels are on: MXTPU_TELEMETRY=1 *and*
    MXTPU_HEALTH=1, decided once; then one attribute check."""
    if _state.decided:
        return _state.active
    return _decide()


def _flag(name):
    from ..config import flags
    flags.reload(name)
    return flags.get(name)


# ---------------------------------------------------------------------------
# sentinels on the step's device
# ---------------------------------------------------------------------------

def _f32(ts):
    return [t.detach().float() for t in ts]


def _sum_sq(ts, device):
    """The sum of squares of every element of ``ts`` as an f32 0-d tensor:
    one stacked reduction over the per-tensor norms. The norms accumulate
    in f64 (one pass over the f32 values either way): torch's f32 norm on
    the CPU sums serially and loses up to ~1e-5 relative on a layer of a
    few hundred thousand values, where jnp's pairwise sum keeps ~1e-7."""
    if not ts:
        return torch.zeros((), dtype=torch.float32, device=device)
    norms = torch._foreach_norm(_f32(ts), 2, dtype=torch.float64)
    return torch.stack(norms).square().sum().float()


def _device(outs, grads, params):
    for group in (outs, grads, params):
        for t in group or ():
            return t.device
    return torch.device('cpu')


def step_stats(outs, grads=None, params=None, new_params=None):
    """The per-step sentinel vector, computed on the step's device with no
    host synchronisation.

    Layout (f32, length ``N_FIXED + len(outs)``):

    - ``[0]`` all-finite flag: 1.0 iff every output and the statistics
      below are finite;
    - ``[1]`` global gradient L2 norm (0 without gradients);
    - ``[2]`` global parameter L2 norm (0 without parameters);
    - ``[3]`` update/param ratio ``||new_params - params|| / ||params||``
      when the update ran in the step (the fused window), else the pre-lr
      proxy ``grad_norm / param_norm`` (the per-batch executor, where the
      optimizer update runs after it);
    - ``[4:]`` one finite flag per output.

    A few stacked reductions (``torch._foreach_norm``) on the step's
    device, with no copy to the host: the fused window stacks the rows and
    brings them home with its one fetch.
    """
    grads = list(grads or ())
    params = list(params or ())
    dev = _device(outs, grads, params)
    eps = 1e-12
    grad_norm = _sum_sq(grads, dev).sqrt()
    param_norm = _sum_sq(params, dev).sqrt()
    if new_params is not None and params:
        delta = torch._foreach_sub(_f32(new_params), _f32(params))
        ratio = _sum_sq(delta, dev).sqrt() / (param_norm + eps)
    else:
        ratio = grad_norm / (param_norm + eps)
    out_flags = [torch.isfinite(o.detach().float()).all() for o in outs]
    head = torch.stack([grad_norm, param_norm, ratio])
    all_finite = torch.isfinite(head).all()
    if out_flags:
        all_finite = all_finite & torch.stack(out_flags).all()
    return torch.cat([all_finite.reshape(1).float(), head,
                      torch.stack(out_flags).float() if out_flags
                      else head.new_zeros(0)])


def decode(row):
    """Host-side decode of one sentinel row -> plain dict (the per-output
    finite flags are the row's tail past N_FIXED). Non-finite statistics
    decode to None (strict-JSON safe; the all_finite flag says so)."""
    row = np.asarray(row, np.float64)
    flags = row[N_FIXED:]
    bad_outs = [int(i) for i, f in enumerate(flags) if not f]

    def _f(v):
        v = float(v)
        return v if np.isfinite(v) else None

    return {'all_finite': bool(row[_IDX_FINITE]),
            'grad_norm': _f(row[_IDX_GRAD]),
            'param_norm': _f(row[_IDX_PARAM]),
            'update_ratio': _f(row[_IDX_RATIO]),
            'outputs_nonfinite': bad_outs}


# ---------------------------------------------------------------------------
# incident pipeline (host side)
# ---------------------------------------------------------------------------

def _emit(rec):
    st = _tele()
    if st.active and st.sink is not None:
        st.sink.emit(rec)


def _set_gauges(info):
    reg = _tele().registry
    for k in ('grad_norm', 'param_norm', 'update_ratio'):
        v = info.get(k)
        if v is not None and np.isfinite(v):
            reg.gauge('health.%s' % k).set(round(v, 6))


def _incident(info, bisect=None):
    """One non-finite step: record it, run the once-a-process
    first-bad-layer bisect, and apply MXTPU_HEALTH_ACTION."""
    reg = _tele().registry
    reg.counter('health.nonfinite_steps').inc()
    run_bisect = False
    with _state.lock:
        if not _state.bisect_done:
            _state.bisect_done = True
            run_bisect = True
    if run_bisect and bisect is not None:
        try:
            bad = bisect()
        except Exception as e:  # noqa: BLE001 — diagnostics must not kill
            logging.debug('health: first-bad-layer bisect failed: %s', e)
            bad = None
        if bad is not None:
            name, out_idx = bad
            info['first_bad_layer'] = name
            info['first_bad_output'] = out_idx
    rec = {'type': 'health', 'event': 'nonfinite'}
    rec.update(info)
    _emit(rec)
    # the flight recorder: the records BEFORE the first bad step (dumps
    # are bounded a reason, so a permanently-NaN run cannot spam)
    try:
        from . import flight
        flight.dump('nonfinite', extra={'step': info.get('step')})
    except Exception:  # noqa: BLE001 — forensics must not add a crash
        pass
    with _state.lock:
        if len(_state.incidents) < _MAX_INCIDENTS_KEPT:
            _state.incidents.append(dict(info))
        warn_ok = _state.incident_warnings < _MAX_INCIDENT_WARNINGS
        if warn_ok:
            _state.incident_warnings += 1
    msg = ('training health: non-finite values in %s step'
           % info.get('source', '?'))
    where = info.get('step')
    if where is not None:
        msg += ' %s' % where
    if info.get('window_step') is not None:
        msg += ' (window step %d)' % info['window_step']
    if info.get('first_bad_layer'):
        msg += ' — first non-finite symbol: %s' % info['first_bad_layer']
    if info.get('outputs_nonfinite'):
        msg += ' (non-finite outputs: %s)' % info['outputs_nonfinite']
    if _state.action == 'raise':
        raise TrainingHealthError(msg, diagnostic=info)
    if _state.action == 'warn':
        if warn_ok:
            logging.warning('%s', msg)
        else:
            logging.debug('%s', msg)


def note_batch(step):
    """Publish the fit loop's CURRENT batch index (None clears it): the
    executor has no loop context, so :func:`note_step` falls back to this
    one, and executor incidents name the real step."""
    _state.cur_step = None if step is None else int(step)


def note_step(hv, source='executor', step=None, bisect=None):
    """Check one step's sentinel vector (the per-batch executor path; the
    copy of ``hv`` to the host is its one added sync, in a loop that
    synchronises a batch for its metric anyway). ``step=None`` falls back
    to the fit loop's :func:`note_batch` context."""
    if not enabled():
        return None
    row = hv.detach().cpu().numpy() if isinstance(hv, torch.Tensor) \
        else np.asarray(hv)
    info = decode(row)
    _set_gauges(info)
    _tele().registry.counter('health.steps').inc()
    if info['grad_norm'] is not None:
        _observe('grad_norm', info['grad_norm'])
    if not info['all_finite']:
        info['source'] = source
        if step is None:
            step = _state.cur_step
        if step is not None:
            info['step'] = step
        _incident(info, bisect=bisect)
    return info


def note_window(hmat, source, nbatch_base=0, bisect=None,
                has_grads=True):
    """Check a fused window's (W, k) sentinel matrix, fetched with the
    window's one host fetch. A non-finite step is attributed to its exact
    window step; ``bisect`` (if given) takes the bad window step's index
    and replays that batch. ``has_grads=False`` (the eval window: forward
    only, the norms are zero) keeps the rows out of the grad-norm detector
    and the norm gauges."""
    if not enabled():
        return None
    mat = hmat.detach().cpu().numpy() if isinstance(hmat, torch.Tensor) \
        else np.asarray(hmat)
    if mat.ndim == 1:
        mat = mat[None, :]
    reg = _tele().registry
    reg.counter('health.steps').inc(mat.shape[0])
    if has_grads:
        for row in mat:
            g = float(row[_IDX_GRAD])
            if np.isfinite(g):
                _observe('grad_norm', g)
        _set_gauges(decode(mat[-1]))
    bad_rows = np.flatnonzero(mat[:, _IDX_FINITE] == 0.0)
    if bad_rows.size == 0:
        return None
    # every bad step counts (the per-batch path counts a step at a time;
    # a window with 3 bad rows is 3 bad steps, one incident)
    reg.counter('health.nonfinite_steps').inc(int(bad_rows.size) - 1)
    i = int(bad_rows[0])
    info = decode(mat[i])
    info['source'] = source
    info['step'] = nbatch_base + i
    info['window_step'] = i
    info['nonfinite_steps_in_window'] = int(bad_rows.size)
    _incident(info, bisect=(lambda: bisect(i)) if bisect is not None
              else None)
    return info


# ---------------------------------------------------------------------------
# anomaly detectors
# ---------------------------------------------------------------------------

class SpikeDetector:
    """Rolling-baseline spike detector: an observation is anomalous when
    it sits more than ``k`` robust deviations (MAD, floored so that a
    near-constant baseline cannot alarm on noise) from the median of the
    trailing ``window`` observations. Observations, spikes included (a
    level shift stops alarming once it is the new baseline), enter the
    window after the test."""

    def __init__(self, name, window=None, k=None, min_count=8):
        self.name = name
        self.window = int(window if window is not None
                          else _flag('MXTPU_HEALTH_WINDOW'))
        self.k = float(k if k is not None else _flag('MXTPU_HEALTH_K'))
        self.min_count = min_count
        self._vals = collections.deque(maxlen=self.window)
        self._lock = threading.Lock()

    def observe(self, v):
        """Feed one observation; returns the anomaly dict (value, baseline,
        mad, k) when it spikes, else None. Non-finite values are ignored
        (the finite sentinels own those)."""
        v = float(v)
        if not np.isfinite(v):
            return None
        anomaly = None
        with self._lock:
            if len(self._vals) >= self.min_count:
                vals = np.asarray(self._vals, np.float64)
                med = float(np.median(vals))
                mad = float(np.median(np.abs(vals - med)))
                floor = max(mad, abs(med) * 0.01, 1e-9)
                if abs(v - med) > self.k * floor:
                    anomaly = {'detector': self.name, 'value': round(v, 6),
                               'baseline': round(med, 6),
                               'mad': round(mad, 6), 'k': self.k}
            self._vals.append(v)
        return anomaly


def detector(name):
    """The process-wide detector registered under ``name`` (made at first
    use with the MXTPU_HEALTH_WINDOW / MXTPU_HEALTH_K configuration)."""
    with _state.lock:
        d = _state.detectors.get(name)
        if d is None:
            d = _state.detectors[name] = SpikeDetector(name)
        return d


def _observe(name, value):
    """Feed a detector and publish any anomaly it returns."""
    a = detector(name).observe(value)
    if a is None:
        return None
    return publish_anomaly(a)


def publish_anomaly(a):
    """Publish one anomaly dict: the counters, the ``anomaly`` JSONL
    record and the last-anomaly state."""
    name = a['detector']
    reg = _tele().registry
    reg.counter('health.anomalies').inc()
    reg.counter('health.anomalies.%s' % name).inc()
    rec = {'type': 'anomaly'}
    rec.update(a)
    _emit(rec)
    with _state.lock:
        _state.anomaly_counts[name] = _state.anomaly_counts.get(name, 0) + 1
        _state.last_anomaly = dict(a)
        n_warned = _state.anomaly_warnings.get(name, 0)
        if n_warned < _MAX_ANOMALY_WARNINGS:
            _state.anomaly_warnings[name] = n_warned + 1
    msg = ('training health: %s spike — %.6g vs rolling baseline %.6g '
           '(k=%g, MAD=%.6g)' % (name, a['value'], a['baseline'],
                                 a['k'], a['mad']))
    # spikes never raise: MXTPU_HEALTH_ACTION=raise is for non-finite
    # incidents; a noisy loss curve must not kill a healthy run
    if _state.action != 'record' and n_warned < _MAX_ANOMALY_WARNINGS:
        logging.warning('%s', msg)
    else:
        logging.debug('%s', msg)
    return a


def note_step_time(seconds, steps=1):
    """Feed the step-time detector (ms a step; the fused loop feeds one
    observation a window, wall / W)."""
    if not enabled():
        return
    ms = seconds * 1e3 / max(1, steps)
    _tele().registry.gauge('health.step_time_ms').set(round(ms, 3))
    _observe('step_time', ms)


def note_restart(attempt, reason=None, message=None, restore_step=None,
                 diagnostic=None):
    """Record one supervised restart (module/resilient_fit.py): a
    ``restart`` JSONL record and the ``health.restarts`` counter. Works
    whenever telemetry is on: a restart is a run-level event, not a
    sentinel."""
    st = _tele()
    if not st.active:
        return
    st.registry.counter('health.restarts').inc()
    rec = {'type': 'restart', 'attempt': int(attempt)}
    if reason:
        rec['reason'] = reason
    if message:
        rec['message'] = message
    if restore_step is not None:
        rec['restore_step'] = int(restore_step)
    if diagnostic:
        rec['diagnostic'] = dict(diagnostic)
    _emit(rec)
    # the flight recorder: what led up to the restart, before the restore
    # wipes the in-memory trail
    try:
        from . import flight
        flight.dump('restart', extra={'attempt': int(attempt),
                                      'reason': reason})
    except Exception:  # noqa: BLE001 — forensics must not add a crash
        pass


def note_loss(value):
    """Feed the loss detector (a batch's loss; the fused stats mode feeds
    it from the CrossEntropy statistics)."""
    if not enabled():
        return
    _observe('loss', float(value))


# ---------------------------------------------------------------------------
# host checks, the input-bound classifier, the summary
# ---------------------------------------------------------------------------

def _finite_mask(a):
    """np.isfinite, through f32 for the types numpy cannot test; None for a
    non-numeric array (always finite)."""
    try:
        return np.isfinite(a)
    except TypeError:
        try:
            return np.isfinite(a.astype(np.float32))
        except (TypeError, ValueError):
            return None


def has_nonfinite(a):
    """True when the array holds any NaN or Inf. A tensor is tested where
    it lives (one reduction and a one-element copy); anything else as a
    numpy array. The bisect's per-node test and finite_report's core."""
    if isinstance(a, torch.Tensor):
        if a.numel() == 0 or not (a.is_floating_point() or a.is_complex()):
            return False
        return not bool(torch.isfinite(a).all())
    a = np.asarray(a)
    if a.size == 0 or a.dtype.kind in 'biu?SU':
        return False
    mask = _finite_mask(a)
    return mask is not None and not mask.all()


def finite_report(a):
    """The host half of the finite-flag sentinel, as a Monitor stat string:
    'ok' when every element is finite, else 'nan=<n> inf=<n> of <size>'
    (:meth:`mxnet_tpu_torch.monitor.Monitor.nan_watch`)."""
    a = np.asarray(a)
    if not has_nonfinite(a):
        return 'ok'
    if a.dtype.kind not in 'fc':
        a = a.astype(np.float32)
    n_nan = int(np.isnan(a).sum())
    n_bad = int(a.size - _finite_mask(a).sum())
    return 'nan=%d inf=%d of %d' % (n_nan, n_bad - n_nan, int(a.size))


def input_bound_pct():
    """Share (%) of the driven loops' time spent waiting on the input
    pipeline: the io.prefetch_wait histogram against the fit and eval
    loops' own span time. None when the run recorded no loop time. Works
    whenever telemetry is on."""
    st = _tele()
    if not st.active:
        return None
    reg = st.registry
    io_h = reg.get('io.prefetch_wait')
    if io_h is None or not io_h.count:
        return None
    batch_h = reg.get('fit.batch')
    denom = batch_h.sum if batch_h is not None else 0.0
    if not denom:
        for name in FUSED_FIT_LOOP_SPANS:
            h = reg.get(name)
            if h is not None:
                denom += h.sum
    for name in EVAL_LOOP_SPANS:
        h = reg.get(name)
        if h is not None:
            denom += h.sum
    if denom <= 0.0:
        return None
    return min(100.0, 100.0 * io_h.sum / denom)


def summarize():
    """End-of-run hook (telemetry.write_summary): publish the
    ``fit.input_bound_pct`` gauge (whenever telemetry is on), run the
    input-bound classifier, and return the run-health snapshot (None while
    MXTPU_HEALTH is off)."""
    st = _tele()
    if not st.active:
        return None
    on = enabled()
    pct = input_bound_pct()
    if pct is not None:
        st.registry.gauge('fit.input_bound_pct').set(round(pct, 1))
    if not on:
        return None
    if pct is not None and pct >= _INPUT_BOUND_PCT:
        with _state.lock:
            first = not _state.input_bound_noted
            _state.input_bound_noted = True
        if first:
            _emit({'type': 'health', 'event': 'input_bound',
                   'input_bound_pct': round(pct, 1)})
            logging.warning(
                'training health: run is input-bound — %.1f%% of fit '
                'time spent waiting on the input pipeline '
                '(io.prefetch_wait); the device is starved', pct)
    return snapshot_health(input_bound=pct)


def snapshot_health(input_bound=None):
    """Point-in-time run-health dict (JSON-serializable): the summary
    record's ``health`` key and the summary table's input. None while the
    sentinels are off."""
    if not _state.active:
        return None
    reg = _tele().registry
    with _state.lock:
        out = {
            'nonfinite_steps': int(reg.counter(
                'health.nonfinite_steps').value),
            'incidents': [dict(i) for i in _state.incidents[:8]],
            'anomaly_counts': dict(_state.anomaly_counts),
            'last_anomaly': dict(_state.last_anomaly)
            if _state.last_anomaly else None,
            'action': _state.action,
        }
    restarts = int(reg.counter('health.restarts').value)
    if restarts:
        out['restarts'] = restarts
    hangs = int(reg.counter('watchdog.hangs').value)
    if hangs:
        out['hangs'] = hangs
    if input_bound is not None:
        out['input_bound_pct'] = round(input_bound, 1)
    return out


def _reset_for_tests():
    global _state
    _state = _HState()
