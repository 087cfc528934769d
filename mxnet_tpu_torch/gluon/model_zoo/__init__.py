"""Gluon model zoo: the counterpart of ``mxnet_tpu/gluon/model_zoo/``
(the vision ResNets)."""
from . import vision
from .vision import get_model  # noqa: F401
