"""The parallel tier: the counterpart of ``mxnet_tpu/parallel/``.

Only the one-process half of ``checkpoint.py`` is ported
(:mod:`.checkpoint`, the store of the periodic training checkpoints). The
mesh, sharding, collectives, multi-host agreement, ring attention, the
5-D and pipeline schedules and the compressed collectives wait for
ROADMAP.md §1 item 11.
"""
from . import checkpoint  # noqa: F401  (public submodule)

__all__ = ['checkpoint']
