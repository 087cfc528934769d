"""BaseModule and its loops: the counterpart of
``mxnet_tpu/module/base_module.py``.

``fit`` binds, initialises the parameters and the optimizer, then runs each
epoch: through the fused window of W steps a host call
(:class:`.fused_fit.FusedFitLoop`) where the module is eligible, as in the
JAX package, else through the per-batch loop (``forward_backward``,
``update``, the next batch drawn, the metric, the batch-end callbacks);
each epoch ends in ``_fit_epoch_end`` (the metric's log line, the
parameters synced back, the epoch-end callbacks, a ``score`` of the
validation data). ``score``, ``iter_predict`` and ``predict`` take the
fused eval window (:class:`.fused_eval.FusedEvalLoop`) where they can, else
the per-batch forward loops. ``MXTPU_FUSED_FIT=0`` and
``MXTPU_FUSED_EVAL=0`` force the per-batch loops.

The loops report to the telemetry (``MXTPU_TELEMETRY=1``; each site a
no-op while it is off) with the JAX package's names: the per-batch fit's
``fit.batch`` span around its leaves ``fit.dispatch``, ``fit.draw``,
``fit.metric`` and ``fit.callback``, the ``fit.steps`` and ``fit.epochs``
counters, the watchdog's ``fit.step`` and ``fit.epoch_end`` marks, the
profiler's step count (``MXTPU_XPROF``) and the step timeline's; the
per-batch eval's ``eval.dispatch``, ``eval.metric`` and ``eval.fetch``
spans, the ``eval.batches`` counter and the ``eval_samples_per_sec``
gauge. The watchdog is suspended as fit and each eval pass end.

The resilience tier rides the same loops, as in the JAX package: the
periodic checkpoints and restart from the last good one
(``module/checkpointing.py``, ``MXTPU_CKPT_*``: built before the first
epoch, which may restore; each trained step noted; a final save at the
end, and a drain and certification when fit dies), the fault-injection
seams (:mod:`..faults`, ``MXTPU_FAULT_INJECT``: the batch draw and the
step counter here, the dispatch seams in the executor, the window and the
kvstore) and the health and dynamics sentinels (``MXTPU_HEALTH``,
``MXTPU_DYNAMICS``: each batch's index published for the executor's
incidents, and the step time). The JAX package's run ledger, cluster
aggregation and sharded or compressed update are not ported; a flag that
would turn the last two on raises NotImplementedError naming its
ROADMAP.md item (:func:`_check_unported_flags`).
"""
import logging
import os
import time
import warnings

from .. import faults as _faults
from .. import metric as metric_mod
from .. import ndarray as nd
from .. import profiler as _profiler
from .. import telemetry as _tele
from ..config import flags
from ..initializer import Uniform
from ..io import DataDesc
from ..model import BatchEndParam

__all__ = ['BaseModule']

# flags of the JAX package's fit and eval whose paths are not ported, and
# where each waits
_UNPORTED_FLAGS = (
    ('MXTPU_SHARDED_UPDATE', 'the sharded weight update of the SPMD fit '
     'window (fused_fit.py)', 'ROADMAP.md §1 item 11'),
    ('MXTPU_GRAD_COMPRESS', 'quantized gradient collectives '
     '(parallel/compression.py)', 'ROADMAP.md §1 item 11'),
)


def _check_unported_flags():
    """Raise NotImplementedError for a flag set in the environment to a
    value that turns on a path that is not ported (MXTPU_SHARDED_UPDATE
    defaults on in both packages, but engages only where it is asked for;
    MXTPU_GRAD_COMPRESS is off at 'off')."""
    for name, what, item in _UNPORTED_FLAGS:
        flags.reload(name)
        if name in os.environ and flags.get(name) not in (False, '', 'off'):
            raise NotImplementedError(
                '%s is set, but %s is not ported yet (%s)' % (name, what, item))


def _check_input_names(symbol, names, typename, throw):
    args = symbol.list_arguments()
    for name in names:
        if name in args:
            continue
        candidates = [arg for arg in args if not arg.endswith('_weight') and
                      not arg.endswith('_bias') and not arg.endswith('_gamma')
                      and not arg.endswith('_beta')]
        msg = "\033[91mYou created Module with Module(..., %s_names=%s) but " \
              "input with name '%s' is not found in symbol.list_arguments(). " \
              "Did you mean one of:\n\t%s\033[0m" % (
                  typename, str(names), name, '\n\t'.join(candidates))
        if throw:
            raise ValueError(msg)
        logging.warning(msg)


def _check_names_match(data_names, data_shapes, name, throw):
    """The descriptors' names must match the module's declared names:
    data names raise, label names only warn (a module for prediction binds
    without labels)."""
    actual = [x[0] for x in data_shapes]
    if sorted(data_names) != sorted(actual):
        msg = "Data provided by %s_shapes don't match names specified by " \
              "%s_names (%s vs. %s)" % (name, name, str(data_shapes),
                                        str(data_names))
        if throw:
            raise ValueError(msg)
        warnings.warn(msg)


def _parse_data_desc(data_names, label_names, data_shapes, label_shapes):
    data_shapes = [x if isinstance(x, DataDesc) else DataDesc(*x)
                   for x in data_shapes]
    _check_names_match(data_names, data_shapes, 'data', True)
    if label_shapes is not None:
        label_shapes = [x if isinstance(x, DataDesc) else DataDesc(*x)
                        for x in label_shapes]
        _check_names_match(label_names, label_shapes, 'label', False)
    else:
        _check_names_match(label_names, [], 'label', False)
    return data_shapes, label_shapes


class BaseModule:
    """The training and prediction loops over a module's forward,
    backward, update and metric."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # -- high-level API ---------------------------------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        """``eval_metric`` over the batches of ``eval_data``, forward in
        prediction; returns its ``get_name_value()``."""
        assert self.binded and self.params_initialized
        _check_unported_flags()
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        tic = time.time()
        # the fused window: W forwards a host call and one fetch a window,
        # where the module and metric allow it (module/fused_eval.py)
        from .fused_eval import FusedEvalLoop
        fused = FusedEvalLoop.build_cached(self, eval_metric,
                                           logger=self.logger)
        if fused is not None:
            actual_num_batch = fused.run_score(eval_data, eval_metric,
                                               num_batch, batch_end_callback,
                                               epoch)
        else:
            actual_num_batch = 0
            for nbatch, eval_batch in enumerate(eval_data):
                if num_batch is not None and nbatch == num_batch:
                    break
                with _tele.span('eval.dispatch', 'eval'):
                    self.forward(eval_batch, is_train=False)
                with _tele.span('eval.metric', 'eval'):
                    self.update_metric(eval_metric, eval_batch.label)
                _tele.counter('eval.batches').inc()
                _tele.watchdog.note_progress('eval.step')
                if batch_end_callback is not None:
                    params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                           eval_metric=eval_metric,
                                           locals=locals())
                    for callback in _as_list(batch_end_callback):
                        callback(params)
                actual_num_batch += 1
        _set_eval_rate(actual_num_batch, getattr(eval_data, 'batch_size', 0),
                       tic)
        if score_end_callback:
            params = BatchEndParam(epoch=epoch, nbatch=actual_num_batch,
                                   eval_metric=eval_metric, locals=locals())
            for callback in _as_list(score_end_callback):
                callback(params)
        # the eval pass's marks armed the watchdog: disarm it, so that host
        # work after a standalone score cannot trip it (inside fit the next
        # epoch's first mark re-arms it)
        _tele.watchdog.suspend()
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Yield ``(outputs, nbatch, batch)`` for each batch, the outputs
        without the batch's padding."""
        assert self.binded and self.params_initialized
        _check_unported_flags()
        if reset:
            eval_data.reset()
        try:
            from .fused_eval import FusedEvalLoop
            fused = FusedEvalLoop.build_cached(self, None,
                                               logger=self.logger)
            if fused is not None:
                yield from fused.iter_windows(eval_data, num_batch)
                return
            for nbatch, eval_batch in enumerate(eval_data):
                if num_batch is not None and nbatch == num_batch:
                    break
                with _tele.span('eval.dispatch', 'eval'):
                    self.forward(eval_batch, is_train=False)
                pad = eval_batch.pad
                with _tele.span('eval.fetch', 'eval'):
                    outputs = [out[0:out.shape[0] - pad]
                               for out in self.get_outputs()]
                _tele.counter('eval.batches').inc()
                yield (outputs, nbatch, eval_batch)
        finally:
            # the windows marked the watchdog: disarm it when the consumer
            # stops (exhaustion or an early close of the generator)
            _tele.watchdog.suspend()

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """The outputs over ``eval_data`` (padding dropped), joined over the
        batches with ``merge_batches``."""
        assert self.binded and self.params_initialized
        _check_unported_flags()
        if reset:
            eval_data.reset()
        tic = time.time()
        from .fused_eval import FusedEvalLoop
        fused = FusedEvalLoop.build_cached(self, None, logger=self.logger)
        if fused is not None:
            # the outputs come a batch at a time, trimmed and on the host,
            # fetched once a window
            output_list = [outputs for outputs, _, _ in
                           fused.iter_windows(eval_data, num_batch)]
        else:
            output_list = []
            for nbatch, eval_batch in enumerate(eval_data):
                if num_batch is not None and nbatch == num_batch:
                    break
                with _tele.span('eval.dispatch', 'eval'):
                    self.forward(eval_batch, is_train=False)
                pad = eval_batch.pad
                with _tele.span('eval.fetch', 'eval'):
                    outputs = [out[0:out.shape[0] - pad].copy()
                               for out in self.get_outputs()]
                _tele.counter('eval.batches').inc()
                output_list.append(outputs)
        _set_eval_rate(len(output_list), getattr(eval_data, 'batch_size', 0),
                       tic)
        # as score(): predict's windows marked the watchdog
        _tele.watchdog.suspend()
        if len(output_list) == 0:
            return output_list
        if merge_batches:
            num_outputs = len(output_list[0])
            for out in output_list:
                assert len(out) == num_outputs, \
                    'Cannot merge batches, as num of outputs is not the same ' \
                    'in mini-batches. Maybe bucketing is used?'
            output_list2 = [nd.concatenate([out[i] for out in output_list])
                            for i in range(num_outputs)]
            if num_outputs == 1 and not always_output_list:
                return output_list2[0]
            return output_list2
        return output_list

    def fit(self, train_data, eval_data=None, eval_metric='acc',
            epoch_end_callback=None, batch_end_callback=None, kvstore='local',
            optimizer='sgd', optimizer_params=(('learning_rate', 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=Uniform(0.01), arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None):
        """Train for epochs ``begin_epoch`` to ``num_epoch``, one batch at
        a time."""
        assert num_epoch is not None, 'please specify number of epochs'
        _check_unported_flags()
        _tele.enabled()     # decided before the first build is counted
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)

        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)

        # the resilience tier (module/checkpointing.py): periodic
        # checkpoints and the restore from the last good one, built from
        # the MXTPU_CKPT_* flags before the first epoch. Flags off = None
        from .checkpointing import TrainCheckpointer
        ckpt = TrainCheckpointer.for_fit(self, eval_metric,
                                         logger=self.logger)
        # fault injection (faults.py): one cached bool; every seam below is
        # dead code while the flag is unset
        faults_on = _faults.enabled()

        # the fused window: W steps a host call and one fetch of the metric
        # a window, where the module, optimizer and metric allow it
        # (module/fused_fit.py)
        fused = None
        if monitor is None:
            from .fused_fit import FusedFitLoop
            fused = FusedFitLoop.build_cached(self, eval_metric,
                                              logger=self.logger)

        # one cached bool each: the watchdog's progress marks, the step
        # timeline's step count (its phases ride the spans below), and the
        # health and dynamics planes (the sentinels ride the executor's
        # backward; here the batch's index and the step time)
        wd_on = _tele.watchdog.enabled()
        tl_on = _tele.timeline.enabled()
        health_on = _tele.health.enabled()
        dyn_on = _tele.dynamics.enabled()
        try:
            for epoch in range(begin_epoch, num_epoch):
                tic = time.time()
                eval_metric.reset()
                if ckpt is not None and not ckpt.begin_epoch(
                        epoch, eval_metric, train_data):
                    # resumed past this epoch: skip it without touching the
                    # data or running its eval
                    continue
                if fused is not None:
                    fused.run_epoch(train_data, eval_metric, epoch,
                                    batch_end_callback, ckpt=ckpt)
                    self._fit_epoch_end(epoch, eval_metric, tic,
                                        epoch_end_callback, eval_data,
                                        validation_metric, eval_end_callback,
                                        eval_batch_end_callback)
                    train_data.reset()
                    continue
                # a resumed epoch's first batch IS batch r_step
                nbatch = ckpt.epoch_nbatch_base if ckpt is not None else 0
                data_iter = iter(train_data)
                end_of_batch = False
                next_data_batch = None
                try:
                    next_data_batch = next(data_iter)
                except StopIteration:
                    if ckpt is None or not ckpt.allow_empty_epoch(epoch):
                        raise
                    # the restore point was this epoch's boundary: the
                    # skip consumed every batch
                    end_of_batch = True
                while not end_of_batch:
                    data_batch = next_data_batch
                    if faults_on:
                        # the nan-grad draw seam (batches in step order)
                        data_batch = _faults.maybe_poison_batch(data_batch)
                    if monitor is not None:
                        monitor.tic()
                    t_step = time.time() if health_on else 0.0
                    if health_on or dyn_on:
                        # the executor's incidents carry the batch's index
                        _tele.health.note_batch(nbatch)
                    # the batch's host time by part (each a no-op unless
                    # telemetry is on or the profiler runs)
                    with _tele.span('fit.batch', 'fit'):
                        with _tele.span('fit.dispatch', 'fit'):
                            self.forward_backward(data_batch)
                            self.update()
                        _tele.counter('fit.steps').inc()
                        if wd_on:
                            _tele.watchdog.note_progress('fit.step')
                        # the MXTPU_XPROF step window
                        _profiler.note_step()
                        try:
                            with _tele.span('fit.draw', 'fit'):
                                next_data_batch = next(data_iter)
                            self.prepare(next_data_batch)
                        except StopIteration:
                            end_of_batch = True
                        with _tele.span('fit.metric', 'fit'):
                            self.update_metric(eval_metric, data_batch.label)
                        if monitor is not None:
                            monitor.toc_print()
                        if batch_end_callback is not None:
                            batch_end_params = BatchEndParam(
                                epoch=epoch, nbatch=nbatch,
                                eval_metric=eval_metric, locals=locals())
                            with _tele.span('fit.callback', 'fit'):
                                for callback in _as_list(batch_end_callback):
                                    callback(batch_end_params)
                    if health_on:
                        _tele.health.note_step_time(time.time() - t_step)
                    if ckpt is not None:
                        # the sentinel check ran in the backward: health
                        # trails by nothing (lag=0)
                        ckpt.note_steps(1)
                    if faults_on:
                        _faults.note_steps(1, device=self._fault_device())
                    if tl_on:
                        _tele.timeline.note_step(1)
                    nbatch += 1

                self._fit_epoch_end(epoch, eval_metric, tic,
                                    epoch_end_callback, eval_data,
                                    validation_metric, eval_end_callback,
                                    eval_batch_end_callback)
                train_data.reset()
        except BaseException as e:
            if ckpt is not None:
                # the run is dying with a save possibly in flight: drain
                # and certify now, while the interpreter is whole, so that
                # a relaunch has something to restore (idempotent:
                # resilient_fit's call after this finds nothing pending)
                diag = getattr(e, 'diagnostic', None)
                try:
                    ckpt.handle_failure(dict(diag) if diag else None)
                except Exception:  # noqa: BLE001 — never mask the failure
                    pass
            # fit is over, however it ended: stop expecting marks, so that
            # host work after training cannot trip the watchdog
            if wd_on:
                _tele.watchdog.suspend()
            raise
        if ckpt is not None:
            # the final save, the writer drained, last-good certified (its
            # commit is a progress mark: suspend after it)
            ckpt.finish()
        if wd_on:
            _tele.watchdog.suspend()

    def _fault_device(self):
        """The torch device of the module's batches (mem-hog's leak goes
        there)."""
        execs = getattr(getattr(self, '_exec_group', None), 'execs', None)
        return execs[0]._ctx.torch_device() if execs else None

    def _fit_epoch_end(self, epoch, eval_metric, tic, epoch_end_callback,
                       eval_data, validation_metric, eval_end_callback,
                       eval_batch_end_callback):
        """The metric's log line, the parameters synced from the devices,
        the epoch-end callbacks and the validation score."""
        # the batch loop is over: clear the executor incidents' step
        # context (one attribute store, safe while health is off)
        _tele.health.note_batch(None)
        _tele.counter('fit.epochs').inc()
        name_vals = eval_metric.get_name_value()
        for name, val in name_vals:
            self.logger.info('Epoch[%d] Train-%s=%f', epoch, name, val)
        toc = time.time()
        self.logger.info('Epoch[%d] Time cost=%.3f', epoch, (toc - tic))

        arg_params_, aux_params_ = self.get_params()
        self.set_params(arg_params_, aux_params_)
        if epoch_end_callback is not None:
            for callback in _as_list(epoch_end_callback):
                callback(epoch, self.symbol, arg_params_, aux_params_)

        if eval_data:
            res = self.score(eval_data, validation_metric,
                             score_end_callback=eval_end_callback,
                             batch_end_callback=eval_batch_end_callback,
                             epoch=epoch)
            for name, val in res:
                self.logger.info('Epoch[%d] Validation-%s=%f',
                                 epoch, name, val)
        # score() suspends the watchdog as it ends; within fit the next
        # epoch is coming, so re-arm it here
        _tele.watchdog.note_progress('fit.epoch_end')

    # -- parameter contract (implemented by subclasses) --------------------
    @property
    def symbol(self):
        return self._symbol

    @property
    def data_names(self):
        raise NotImplementedError()

    @property
    def output_names(self):
        raise NotImplementedError()

    @property
    def data_shapes(self):
        raise NotImplementedError()

    @property
    def label_shapes(self):
        raise NotImplementedError()

    @property
    def output_shapes(self):
        raise NotImplementedError()

    def get_params(self):
        raise NotImplementedError()

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        raise NotImplementedError()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def save_params(self, fname):
        arg_params, aux_params = self.get_params()
        save_dict = {('arg:%s' % k): v for k, v in arg_params.items()}
        save_dict.update({('aux:%s' % k): v for k, v in aux_params.items()})
        nd.save(fname, save_dict)

    def load_params(self, fname):
        save_dict = nd.load(fname)
        arg_params = {}
        aux_params = {}
        for k, value in save_dict.items():
            arg_type, name = k.split(':', 1)
            if arg_type == 'arg':
                arg_params[name] = value
            elif arg_type == 'aux':
                aux_params[name] = value
            else:
                raise ValueError('Invalid param file ' + fname)
        self.set_params(arg_params, aux_params)

    def get_states(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        assert not merge_multi_context
        return []

    def set_states(self, states=None, value=None):
        assert self.binded and self.params_initialized
        assert not states and not value

    def install_monitor(self, mon):
        raise NotImplementedError()

    def prepare(self, data_batch):
        pass

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError()

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req='write'):
        raise NotImplementedError()

    def init_optimizer(self, kvstore='local', optimizer='sgd',
                       optimizer_params=(('learning_rate', 0.01),),
                       force_init=False):
        raise NotImplementedError()


def _set_eval_rate(nbatches, batch_size, tic):
    """The eval loops' ``eval_samples_per_sec`` gauge, the eval twin of the
    Speedometer's (a no-op while telemetry is off)."""
    if nbatches and batch_size:
        dt = time.time() - tic
        if dt > 0:
            _tele.gauge('eval_samples_per_sec').set(
                round(nbatches * batch_size / dt, 2))


def _as_list(obj):
    if isinstance(obj, list):
        return obj
    return [obj]
