"""Automatic naming for the symbolic API: the counterpart of
``mxnet_tpu/name.py``. The namers live in :mod:`.attribute` beside
``AttrScope`` (one scope stack); this module keeps the import path."""
from .attribute import NameManager, Prefix

__all__ = ['NameManager', 'Prefix']
