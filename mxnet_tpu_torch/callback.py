"""Training callbacks: the counterpart of ``mxnet_tpu/callback.py``
(``module_checkpoint``, ``do_checkpoint``, ``log_train_metric``,
``Speedometer``, ``ProgressBar``, ``LogValidationMetricsCallback``), with
the JAX package's log line formats. ``Speedometer`` also sets the
``speedometer.samples_per_sec`` telemetry gauge (a no-op with telemetry
off).

``Speedometer`` times the host's wall clock between the batch-end calls
that ``Module.fit`` makes after each batch's metric update; that update
reads the batch's outputs back from the card, so each window's time
includes the device's work for its batches.
"""
import logging
import math
import sys
import time

from . import telemetry

__all__ = ['Speedometer', 'do_checkpoint', 'module_checkpoint',
           'log_train_metric', 'ProgressBar', 'LogValidationMetricsCallback']


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)
    return _callback


def do_checkpoint(prefix, period=1):
    from .model import save_checkpoint
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _callback


def log_train_metric(period, auto_reset=False):
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                logging.info('Iter[%d] Batch[%d] Train-%s=%f',
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()
    return _callback


class Speedometer:
    """Logs samples/sec every `frequent` batches (the role of reference
    callback.py's Speedometer; the `Speed:` line format is pinned —
    downstream scripts and the compat tests parse it).

    Implemented as a rolling measurement window: the window opens on
    the first batch of an epoch (a rewinding batch counter re-opens
    it), and every time the batch counter lands on a multiple of
    `frequent` the window's throughput is reported and a fresh window
    opens.
    """

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self._window_open = None   # wall-clock when the window opened
        self._prev_batch = None

    def __call__(self, param):
        now = time.time()
        rewound = (self._prev_batch is not None
                   and param.nbatch < self._prev_batch)
        self._prev_batch = param.nbatch
        if self._window_open is None or rewound:
            self._window_open = now
            return
        if param.nbatch % self.frequent:
            return
        speed = self.frequent * self.batch_size / (now - self._window_open)
        # the measurement's telemetry mirror; the pinned `Speed:` line below
        # is unchanged
        telemetry.gauge('speedometer.samples_per_sec').set(round(speed, 2))
        metric = param.eval_metric
        if metric is None:
            logging.info('Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec',
                         param.epoch, param.nbatch, speed)
        else:
            pairs = metric.get_name_value()
            if self.auto_reset:
                metric.reset()
            fields = [param.epoch, param.nbatch, speed]
            for name, value in pairs:
                fields.extend((name, value))
            logging.info('Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec'
                         + '\t%s=%f' * len(pairs), *fields)
        self._window_open = time.time()


class ProgressBar:
    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        prog_bar = '=' * filled_len + '-' * (self.bar_len - filled_len)
        sys.stdout.write('[%s] %s%s\r' % (prog_bar, percents, '%'))


class LogValidationMetricsCallback:
    """Epoch-end eval logger; the `Validation-` line format is pinned
    (parsed by downstream scripts, so only the internals differ from
    the reference's)."""

    def __call__(self, param):
        metric = param.eval_metric
        if metric is None:
            return
        for name, value in metric.get_name_value():
            logging.info('Epoch[%d] Validation-%s=%f',
                         param.epoch, name, value)
