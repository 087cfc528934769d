"""Monitor, per-op output statistics during execution: the counterpart of
``mxnet_tpu/monitor.py`` (MXNet's python/mxnet/monitor.py).

``install`` hooks an executor's monitor callback; ``tic`` opens a window
every ``interval`` steps and ``toc`` drains it with the matching arguments.
``Module.fit(..., monitor=mon)`` calls ``tic``/``toc_print`` around each
batch. ``stat_func`` is one callable or a list: with a list, each matched
array is copied to the host once and every function gets the same host
NDArray; a single function runs on the array where it lives (the default
RMS is one reduction on the card and a scalar copy).

:meth:`Monitor.nan_watch` flags NaN/Inf in every matched tensor with
:func:`finite_report`. :func:`has_nonfinite` and :func:`finite_report` are
the port's copies of the JAX package's host checks
(``telemetry/health.py``; the rest of that plane is not ported), and
:func:`has_nonfinite` also takes a tensor, which it checks where it lives
(the executor's bisect, ``Executor.first_nonfinite_node``).
"""
import logging
import re
from collections import namedtuple
from math import sqrt

import numpy as np
import torch

__all__ = ['Monitor', 'has_nonfinite', 'finite_report']

_Record = namedtuple('_Record', ['step', 'name', 'stat'])


def _finite_mask(a):
    """np.isfinite, through f32 for the types numpy cannot test (bf16);
    None for a non-numeric array (always finite)."""
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
    numpy array."""
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
    """'ok' when every element is finite, else 'nan=<n> inf=<n> of
    <size>' (a Monitor stat string)."""
    a = np.asarray(a)
    if not has_nonfinite(a):
        return 'ok'
    if a.dtype.kind not in 'fc':
        a = a.astype(np.float32)
    n_nan = int(np.isnan(a).sum())
    n_bad = int(a.size - _finite_mask(a).sum())
    return 'nan=%d inf=%d of %d' % (n_nan, n_bad - n_nan, int(a.size))


def _rms_stat(x):
    """Default statistic: the RMS of the tensor, as a string; 'nan' for an
    empty one."""
    if x.size == 0:
        return 'nan'
    return str((x.norm() / sqrt(x.size)).asscalar())


def _host_fetch(array):
    """One copy to the host, as an NDArray on the CPU, so that the stat
    functions keep the NDArray API without touching the card again."""
    from .context import cpu
    from .ndarray.ndarray import NDArray
    t = array._data.detach()
    return NDArray(t.to('cpu', copy=True), cpu())


class Monitor:
    """Collects statistics for every executor output whose name matches
    ``pattern``, on every ``interval``-th step between tic() and toc()."""

    def __init__(self, interval, stat_func=None, pattern='.*', sort=False):
        self.interval = interval
        if stat_func is None:
            stat_funcs = [_rms_stat]
        elif callable(stat_func):
            stat_funcs = [stat_func]
        else:
            stat_funcs = list(stat_func)
        self.stat_func = stat_funcs[0]       # the reference's attribute
        self.stat_funcs = stat_funcs
        self.sort = sort
        self.re_prog = re.compile(pattern)
        self.step = 0
        self.exes = []
        self.activated = False
        self.queue = []

        monitor = self

        def stat_helper(name, array):
            # called by the executor for every op output while armed
            if monitor.activated and monitor.re_prog.match(name):
                monitor._collect(name, array)
        self.stat_helper = stat_helper

    def _funcs(self):
        # `mon.stat_func = fn` after construction (the reference's
        # pattern) wins over the list taken at __init__
        if callable(self.stat_func) and self.stat_func \
                is not self.stat_funcs[0]:
            return [self.stat_func]
        return self.stat_funcs

    def _collect(self, name, array):
        funcs = self._funcs()
        host = _host_fetch(array) if len(funcs) > 1 else array
        for fn in funcs:
            self.queue.append(_Record(self.step, name, fn(host)))

    @classmethod
    def nan_watch(cls, interval=1, pattern='.*'):
        """A Monitor whose rows read 'ok' or 'nan=<n> inf=<n> of <size>'
        for each matched op output, and for the matched arguments at
        toc()."""
        return cls(interval, stat_func=lambda x: finite_report(x.asnumpy()),
                   pattern=pattern)

    def install(self, exe):
        """Register with an executor; may be called for many executors."""
        exe.set_monitor_callback(self.stat_helper)
        self.exes.append(exe)

    def _barrier(self):
        for exe in self.exes:
            for array in exe.arg_arrays:
                array.wait_to_read()

    def tic(self):
        """Open a collection window if this step is on the interval."""
        if self.step % self.interval == 0:
            self._barrier()
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """Close the window: sample the matching arguments too, then
        return [(step, name, tab-joined stat string), ...]."""
        if not self.activated:
            return []
        self._barrier()
        for exe in self.exes:
            for name, array in exe.arg_dict.items():
                if self.re_prog.match(name):
                    self._collect(name, array)
        self.activated = False
        pending = sorted(self.queue, key=lambda r: r.name) if self.sort \
            else self.queue
        results = [(r.step, r.name, self._render(r.stat)) for r in pending]
        self.queue = []
        return results

    @staticmethod
    def _render(stat):
        values = stat if isinstance(stat, list) else [stat]
        return ''.join(str(v) + '\t' for v in values)

    def toc_print(self):
        """toc() and log each row."""
        for step, name, stat in self.toc():
            logging.info('Batch: {:7d} {:30s} {:s}'.format(step, name, stat))
