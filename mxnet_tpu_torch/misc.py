"""The pre-lr_scheduler names some old scripts import: the counterpart of
``mxnet_tpu/misc.py`` (MXNet's python/mxnet/misc.py)."""
from .lr_scheduler import FactorScheduler, LRScheduler

__all__ = ['FactorScheduler', 'LearningRateScheduler']

# the old name of the scheduler base class
LearningRateScheduler = LRScheduler
