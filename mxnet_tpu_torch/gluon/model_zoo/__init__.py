"""Gluon model zoo: the counterpart of ``mxnet_tpu/gluon/model_zoo/``
(every family of ``vision``, ``custom_layers`` and ``model_store``)."""
from . import custom_layers, model_store, vision  # noqa: F401
from .vision import get_model  # noqa: F401
