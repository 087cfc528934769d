"""The Module training API: the counterpart of ``mxnet_tpu/module/`` for
``BaseModule``, ``Module`` and ``DataParallelExecutorGroup``. The
bucketing, sequential and python modules are not ported yet."""
from .base_module import BaseModule
from .module import Module
from .executor_group import DataParallelExecutorGroup
