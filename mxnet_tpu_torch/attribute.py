"""Attribute and name scoping for symbols: the counterpart of
``mxnet_tpu/attribute.py`` (``AttrScope``, which carries user attrs such
as ``ctx_group`` and ``lr_mult`` onto the nodes built inside it, and the
auto-namers ``NameManager`` and ``Prefix``). Gluon's parameter names come
from these counters (``resnetv10_conv0_weight``), so they count exactly as
the JAX package's do.
"""
import threading

__all__ = ['AttrScope', 'NameManager', 'Prefix']

_local = threading.local()


class AttrScope:
    def __init__(self, **kwargs):
        for v in kwargs.values():
            if not isinstance(v, str):
                raise ValueError('Attributes need to be strings')
        self._attr = kwargs

    def get(self, attr):
        out = dict(self._attr)
        if attr:
            out.update(attr)
        return out

    def __enter__(self):
        if not hasattr(_local, 'attr_stack'):
            _local.attr_stack = [AttrScope()]
        merged = dict(_local.attr_stack[-1]._attr)
        merged.update(self._attr)
        scope = AttrScope.__new__(AttrScope)
        scope._attr = merged
        _local.attr_stack.append(scope)
        return self

    def __exit__(self, *args):
        _local.attr_stack.pop()

    @staticmethod
    def current():
        if not hasattr(_local, 'attr_stack'):
            _local.attr_stack = [AttrScope()]
        return _local.attr_stack[-1]


class NameManager:
    """Auto-namer for symbols: ``hint`` lowered, then a per-hint count."""

    def __init__(self):
        self._counter = {}

    def get(self, name, hint):
        if name:
            return name
        hint = hint.lower()
        idx = self._counter.get(hint, 0)
        self._counter[hint] = idx + 1
        return '%s%d' % (hint, idx)

    def __enter__(self):
        if not hasattr(_local, 'name_stack'):
            _local.name_stack = [NameManager()]
        _local.name_stack.append(self)
        return self

    def __exit__(self, *args):
        _local.name_stack.pop()

    @staticmethod
    def current():
        if not hasattr(_local, 'name_stack'):
            _local.name_stack = [NameManager()]
        return _local.name_stack[-1]


class Prefix(NameManager):
    """Prepends a prefix to every auto-generated name."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return name if name else self._prefix + super().get(None, hint)
