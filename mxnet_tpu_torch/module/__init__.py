"""The Module training API: the counterpart of ``mxnet_tpu/module/`` for
``BaseModule``, ``Module``, ``DataParallelExecutorGroup``,
``BucketingModule``, ``SequentialModule``, ``PythonModule`` and
``PythonLossModule``."""
from .base_module import BaseModule
from .module import Module
from .executor_group import DataParallelExecutorGroup
from .bucketing_module import BucketingModule
from .sequential_module import SequentialModule
from .python_module import PythonModule, PythonLossModule
