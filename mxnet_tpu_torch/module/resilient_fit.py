"""Supervised training: fit() under a restart-from-last-good loop, the
counterpart of ``mxnet_tpu/module/resilient_fit.py``.

``resilient_fit(module, train_data, ...)`` runs :meth:`BaseModule.fit`
and, when the run dies of something survivable (a
:class:`~mxnet_tpu_torch.telemetry.health.TrainingHealthError` raised by
the sentinels under MXTPU_HEALTH_ACTION=raise, an injected or real
dispatch failure, a runtime error), certifies the checkpointer's pending
saves against the failure's diagnostic, backs off, and enters fit() again,
which restores from the last-good checkpoint and resumes mid-epoch
(``module/checkpointing.py``: parameters, optimizer states, RNG streams
and the iterator's cursor all come back, so that the replay reaches the
uninterrupted run's final state). Every restart is a ``restart`` JSONL
record, counted under ``health.restarts``, and its rework (the steps
between the restore point and where the attempt had reached) goes to the
goodput plane.

Budget: ``MXTPU_RESTART_MAX`` attempts, ``MXTPU_RESTART_BACKOFF *
2^(k-1)`` seconds apart (capped at 60 s); a failure past the budget, or
one that is not retryable (assertion, keyboard interrupt, shape and user
errors), re-raises unchanged. A CUDA error that poisons the context (an
illegal address) is a RuntimeError and is retried like any other; every
retry then fails and the budget ends the run: that case belongs to the
process tier, ``train_supervisor.py``, which relaunches the whole process.
"""
import logging
import time

from .. import telemetry as _tele
from ..faults import FaultInjected
from ..telemetry.health import TrainingHealthError

__all__ = ['resilient_fit', 'is_retryable']

_BACKOFF_CAP_S = 60.0

# the error families worth a restore and retry: health incidents, injected
# faults, runtime and device errors (torch's CUDA errors are
# RuntimeErrors), lost connections. User and shape errors (ValueError,
# TypeError, AssertionError) re-raise at once.
_RETRYABLE = (TrainingHealthError, FaultInjected, RuntimeError,
              ConnectionError, TimeoutError, OSError)
_FATAL = (KeyboardInterrupt, SystemExit, MemoryError)


def is_retryable(exc):
    if isinstance(exc, _FATAL):
        return False
    return isinstance(exc, _RETRYABLE)


def _budget():
    from ..config import flags
    flags.reload('MXTPU_RESTART_MAX')
    flags.reload('MXTPU_RESTART_BACKOFF')
    return flags.get('MXTPU_RESTART_MAX'), flags.get('MXTPU_RESTART_BACKOFF')


def resilient_fit(module, train_data, restart_max=None,
                  restart_backoff=None, logger=logging, **fit_kwargs):
    """Run ``module.fit(train_data, **fit_kwargs)`` under supervision.

    Returns the number of restarts it took (0 = a clean first run). The
    checkpoint cadence and restore come from the MXTPU_CKPT_* flags; with
    them unset this still retries, but every retry starts from epoch 0."""
    max_restarts, backoff = _budget()
    if restart_max is not None:
        max_restarts = int(restart_max)
    if restart_backoff is not None:
        backoff = float(restart_backoff)
    attempts = 0
    while True:
        try:
            module.fit(train_data, **fit_kwargs)
            return attempts
        except Exception as e:  # noqa: BLE001 — filtered right below
            if not is_retryable(e) or attempts >= max_restarts:
                raise
            attempts += 1
            diag = dict(getattr(e, 'diagnostic', None) or {})
            ckpt = module.__dict__.get('_mxtpu_ckpt')
            restore_from = None
            if ckpt is not None:
                # drain the writer and certify the pending saves against
                # the incident before the next attempt reads the pointer
                try:
                    ckpt.handle_failure(diag)
                except Exception:  # noqa: BLE001 — never mask the retry
                    pass
                restore_from = ckpt.last_good
                # every step between the restore point and where the
                # attempt had reached is trained again: rework
                reached = int(getattr(ckpt, 'global_step', 0) or 0)
                _tele.goodput.note_rework(reached - int(restore_from or 0))
            _tele.health.note_restart(
                attempt=attempts, reason=type(e).__name__,
                message=str(e)[:200], restore_step=restore_from,
                diagnostic=diag or None)
            delay = min(_BACKOFF_CAP_S, backoff * (2.0 ** (attempts - 1)))
            logger.warning(
                'resilient_fit: attempt %d/%d failed (%s: %s) — '
                'restoring from %s and retrying in %.1fs',
                attempts, max_restarts, type(e).__name__, str(e)[:200],
                'step %s' % restore_from if restore_from is not None
                else 'scratch (no certified checkpoint)', delay)
            if delay:
                time.sleep(delay)
            # the attempt left the iterator mid-epoch; the next fit() draws
            # the epoch from the top, so that the skip lands on the right
            # batches
            try:
                train_data.reset()
            except Exception:  # noqa: BLE001
                pass
