"""Gluon's data API: the counterpart of ``mxnet_tpu/gluon/data/``
(datasets, samplers, the DataLoader and the vision datasets)."""
from .dataset import *     # noqa: F401,F403
from .sampler import *     # noqa: F401,F403
from .dataloader import *  # noqa: F401,F403
from . import vision       # noqa: F401
