"""Per-layer training dynamics, the counterpart of
``mxnet_tpu/telemetry/dynamics.py``: watch the model's layers, not only the
run as a system.

The health sentinel packs one global grad-norm, so a head whose gradients
vanish or a layer that silently dies stays invisible until the final
metric. This plane computes, a step and a parameter, the gradient L2 norm,
the parameter L2 norm and the update ratio ``||dw|| / ||w||`` (the delta
of the step on the fused window, the ``||g|| / ||w||`` pre-lr proxy on the
per-batch executor, where the optimizer runs after it), and a graph
output's activation zero-fraction (a ReLU head whose output is mostly
zeros is dying). It is one f32 vector a step, ``N_STATS * n_layers +
n_outputs`` floats, computed on the step's device by stacked reductions
(``torch._foreach_norm``) and stacked by the fused window into a (W, k)
matrix that comes home in the window's existing fetch: no added sync.

Host side, each row:

- feeds every layer's grad-norm and update ratio into the health plane's
  :class:`~mxnet_tpu_torch.telemetry.health.SpikeDetector` (detectors
  ``grad_norm.<layer>`` and ``update_ratio.<layer>``);
- raises a named-layer ``dynamics`` incident on a non-finite per-layer
  statistic (``event=layer_nonfinite``, the first bad layer named);
- publishes ``dynamics.<layer>.*`` gauges, the worst-layer roll-up
  (``dynamics.worst_layer``, ``worst_update_ratio``, ``dead_frac_max``)
  and a ``dynamics`` JSONL record at the ``MXTPU_SCALARS_EVERY`` cadence.

Gating: ``MXTPU_DYNAMICS=1`` *and* ``MXTPU_TELEMETRY=1``. Off, every entry
point is one cached-bool check and nothing runs on the device.
"""
import logging
import threading

import numpy as np
import torch

__all__ = ['enabled', 'every', 'step_stats', 'decode', 'note_step',
           'note_window', 'snapshot_dynamics', 'N_STATS']

N_STATS = 3
_IDX_GRAD, _IDX_PARAM, _IDX_RATIO = range(N_STATS)

_MAX_INCIDENT_WARNINGS = 3
_MAX_INCIDENTS_KEPT = 16    # dicts kept; the counter keeps the total
_DEAD_DEFAULT_EVERY = 25    # the cadence when MXTPU_SCALARS_EVERY=0


class _DState:
    __slots__ = ('decided', 'active', 'every', 'seen', 'incidents',
                 'incident_warnings', 'last', 'lock')

    def __init__(self):
        self.decided = False
        self.active = False
        self.every = _DEAD_DEFAULT_EVERY
        self.seen = 0           # rows observed (== trained steps)
        self.incidents = []
        self.incident_warnings = 0
        self.last = None        # the last decoded {'layers':…, 'outputs':…}
        self.lock = threading.Lock()


_state = _DState()
_decide_lock = threading.Lock()


def _tele():
    from . import enabled as _tele_enabled, _state as st
    _tele_enabled()
    return st


def _decide():
    with _decide_lock:
        if _state.decided:
            return _state.active
        on, ev = False, _DEAD_DEFAULT_EVERY
        if _tele().active:
            from ..config import flags
            flags.reload('MXTPU_DYNAMICS')
            flags.reload('MXTPU_SCALARS_EVERY')
            on = bool(flags.get('MXTPU_DYNAMICS'))
            ev = int(flags.get('MXTPU_SCALARS_EVERY')) or _DEAD_DEFAULT_EVERY
        _state.active = on
        _state.every = ev
        _state.decided = True
    return _state.active


def enabled():
    """Whether the per-layer dynamics plane is on: MXTPU_TELEMETRY=1 *and*
    MXTPU_DYNAMICS=1, decided once; then one attribute check."""
    if _state.decided:
        return _state.active
    return _decide()


def every():
    """The publication cadence (steps): MXTPU_SCALARS_EVERY, or its
    default when that is 0."""
    enabled()
    return _state.every


# ---------------------------------------------------------------------------
# statistics on the step's device
# ---------------------------------------------------------------------------

def _norms(ts):
    """Each tensor's L2 norm, f32, accumulated in f64 (as the health
    plane's)."""
    return torch.stack(torch._foreach_norm(
        [t.detach().float() for t in ts], 2, dtype=torch.float64)).float()


def step_stats(outs, grads, params, new_params=None):
    """The per-step per-layer dynamics vector, computed on the step's
    device. Layout (f32, length ``N_STATS * len(params) + len(outs)``):

    - ``[3*i + 0]`` layer i gradient L2 norm;
    - ``[3*i + 1]`` layer i parameter L2 norm;
    - ``[3*i + 2]`` layer i update ratio ``||new - old|| / ||old||`` when
      the update ran in the step (the fused window), else the pre-lr proxy
      ``||g|| / ||w||`` (the per-batch executor);
    - ``[3*n:]`` one activation zero-fraction per graph output.
    """
    eps = 1e-12
    parts = []
    if params:
        gn = _norms(grads)
        pn = _norms(params)
        if new_params is not None:
            delta = torch._foreach_sub(
                [t.detach().float() for t in new_params],
                [t.detach().float() for t in params])
            ratio = _norms(delta) / (pn + eps)
        else:
            ratio = gn / (pn + eps)
        parts.append(torch.stack([gn, pn, ratio], dim=1).reshape(-1))
    if outs:
        parts.append(torch.stack([(o.detach().float() == 0).float().mean()
                                  for o in outs]))
    if not parts:
        return torch.zeros(0, dtype=torch.float32)
    return torch.cat(parts)


def decode(row, layer_names, out_names):
    """Host-side decode of one dynamics row -> plain dict. Non-finite
    statistics decode to None (the incident path reports them)."""
    row = np.asarray(row, np.float64)

    def _f(v):
        v = float(v)
        return round(v, 8) if np.isfinite(v) else None

    layers = {}
    for i, n in enumerate(layer_names):
        base = N_STATS * i
        layers[n] = {'grad_norm': _f(row[base + _IDX_GRAD]),
                     'param_norm': _f(row[base + _IDX_PARAM]),
                     'update_ratio': _f(row[base + _IDX_RATIO])}
    tail = row[N_STATS * len(layer_names):]
    outputs = {n: _f(tail[i]) for i, n in enumerate(out_names)}
    return {'layers': layers, 'outputs': outputs}


# ---------------------------------------------------------------------------
# host-side pipeline
# ---------------------------------------------------------------------------

def _emit(rec):
    st = _tele()
    if st.active and st.sink is not None:
        st.sink.emit(rec)


def _first_bad_layer(info):
    """(layer, stat) of the first non-finite per-layer statistic, or
    None."""
    for n, stats in info['layers'].items():
        for stat in ('grad_norm', 'param_norm', 'update_ratio'):
            if stats[stat] is None:
                return n, stat
    return None


def _incident(layer, stat, step):
    """A named layer's non-finite statistic: a ``dynamics`` JSONL record,
    the counter and a rate-limited warning."""
    reg = _tele().registry
    reg.counter('dynamics.layer_incidents').inc()
    info = {'type': 'dynamics', 'event': 'layer_nonfinite',
            'layer': layer, 'stat': stat}
    if step is not None:
        info['step'] = int(step)
    _emit(info)
    with _state.lock:
        if len(_state.incidents) < _MAX_INCIDENTS_KEPT:
            _state.incidents.append({k: v for k, v in info.items()
                                     if k != 'type'})
        warn_ok = _state.incident_warnings < _MAX_INCIDENT_WARNINGS
        if warn_ok:
            _state.incident_warnings += 1
    msg = ('training dynamics: non-finite %s in layer %s%s'
           % (stat, layer, '' if step is None else ' at step %s' % step))
    if warn_ok:
        logging.warning('%s', msg)
    else:
        logging.debug('%s', msg)


def _feed_detectors(info):
    """Per-layer spike detection through the health plane's detectors
    (``grad_norm.<layer>``, ``update_ratio.<layer>``), only while that
    plane is on."""
    from . import health as _health
    if not _health.enabled():
        return
    for n, stats in info['layers'].items():
        g = stats['grad_norm']
        if g is not None:
            _health._observe('grad_norm.%s' % n, g)
        r = stats['update_ratio']
        if r is not None:
            _health._observe('update_ratio.%s' % n, r)


def _worst(info):
    """(worst_layer, worst_update_ratio, dead_frac_max) of one decoded row:
    the layer changing fastest relative to its size, and the deadest
    output."""
    worst_layer, worst_ratio = None, None
    for n, stats in info['layers'].items():
        r = stats['update_ratio']
        if r is not None and (worst_ratio is None or r > worst_ratio):
            worst_layer, worst_ratio = n, r
    dead = [v for v in info['outputs'].values() if v is not None]
    return worst_layer, worst_ratio, (max(dead) if dead else None)


def _publish(info, step):
    """The cadence's publication: per-layer gauges, the ``dynamics`` JSONL
    record and the worst-layer roll-up."""
    reg = _tele().registry
    for n, stats in info['layers'].items():
        for stat, v in stats.items():
            if v is not None:
                reg.gauge('dynamics.%s.%s' % (n, stat)).set(round(v, 6))
    for n, v in info['outputs'].items():
        if v is not None:
            reg.gauge('dynamics.out.%s.zero_frac' % n).set(round(v, 4))
    worst_layer, worst_ratio, dead_max = _worst(info)
    if worst_layer is not None:
        reg.gauge('dynamics.worst_layer').set(worst_layer)
        reg.gauge('dynamics.worst_update_ratio').set(round(worst_ratio, 8))
    if dead_max is not None:
        reg.gauge('dynamics.dead_frac_max').set(round(dead_max, 4))
    rec = {'type': 'dynamics', 'layers': info['layers'],
           'outputs': info['outputs']}
    if step is not None:
        rec['step'] = int(step)
    if worst_layer is not None:
        rec['worst_layer'] = worst_layer
        rec['worst_update_ratio'] = round(worst_ratio, 8)
    if dead_max is not None:
        rec['dead_frac_max'] = round(dead_max, 4)
    _emit(rec)


def _note_row(row, layer_names, out_names, step):
    """Decode one row and feed the detectors; returns (info, first_bad).
    The caller emits the incident (one a window, as the health plane)."""
    info = decode(row, layer_names, out_names)
    _feed_detectors(info)
    with _state.lock:
        _state.seen += 1
        _state.last = info
        due = (_state.seen % _state.every) == 0 or _state.seen == 1
    if due:
        _publish(info, step)
    return info, _first_bad_layer(info)


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def note_step(dv, layer_names, out_names, step=None):
    """Check one step's dynamics vector (the per-batch executor path; it
    rides the sync the health sentinel already pays). ``step=None`` falls
    back to the fit loop's health.note_batch context."""
    if not enabled():
        return None
    if step is None:
        from . import health as _health
        step = _health._state.cur_step
    info, bad = _note_row(_host(dv), layer_names, out_names, step)
    if bad is not None:
        _incident(bad[0], bad[1], step)
    return info


def note_window(dmat, layer_names, out_names, nbatch_base=0):
    """Check a fused window's (W, k) dynamics matrix, fetched with the
    window's one fetch; each row keeps its exact step. A window with many
    bad steps raises ONE incident (the first bad row)."""
    if not enabled():
        return None
    mat = _host(dmat)
    if mat.ndim == 1:
        mat = mat[None, :]
    last = None
    first_bad = None
    for i, row in enumerate(mat):
        last, bad = _note_row(row, layer_names, out_names,
                              nbatch_base + i)
        if bad is not None and first_bad is None:
            first_bad = (bad[0], bad[1], nbatch_base + i)
    if first_bad is not None:
        _incident(*first_bad)
    return last


def snapshot_dynamics():
    """Point-in-time per-layer dynamics dict (JSON-serializable). None
    while the plane is off or before the first observed step."""
    if not enabled():
        return None
    with _state.lock:
        if _state.last is None:
            return None
        info = _state.last
        out = {'steps': _state.seen,
               'layers': {n: dict(s) for n, s in info['layers'].items()},
               'outputs': dict(info['outputs']),
               'incidents': [dict(i) for i in _state.incidents[:8]]}
    reg = _tele().registry
    n_inc = int(reg.counter('dynamics.layer_incidents').value)
    if n_inc:
        out['layer_incidents'] = n_inc
    worst_layer, worst_ratio, dead_max = _worst(info)
    if worst_layer is not None:
        out['worst_layer'] = worst_layer
        out['worst_update_ratio'] = round(worst_ratio, 8)
    if dead_max is not None:
        out['dead_frac_max'] = round(dead_max, 4)
    return out


def _reset_for_tests():
    global _state
    _state = _DState()
