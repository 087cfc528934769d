"""The generic class registry behind ``create`` factories: the counterpart
of ``mxnet_tpu/registry.py`` (MXNet's python/mxnet/registry.py)."""
import json

from .base import string_types

__all__ = ['get_register_func', 'get_alias_func', 'get_create_func']

_REGISTRIES = {}


def _registry(base_class, nickname):
    return _REGISTRIES.setdefault((base_class, nickname), {})


def get_register_func(base_class, nickname):
    """A decorator registering subclasses of ``base_class`` by their
    lower-cased name (or the given one)."""
    registry = _registry(base_class, nickname)

    def register(klass, name=None):
        assert issubclass(klass, base_class), \
            'Can only register subclass of %s' % base_class.__name__
        if name is None:
            name = klass.__name__
        name = name.lower()
        registry[name] = klass
        klass.__registered_name__ = name
        return klass
    register.__doc__ = 'Register %s to the %s factory' % (
        base_class.__name__, nickname)
    return register


def get_alias_func(base_class, nickname):
    """A decorator registering a class under several names."""
    register = get_register_func(base_class, nickname)

    def alias(*aliases):
        def reg(klass):
            for name in aliases:
                register(klass, name)
            return klass
        return reg
    return alias


def get_create_func(base_class, nickname):
    """``create(name_or_instance_or_config, *args, **kwargs)``: an
    instance, passed through; a dict or a JSON '[name, kwargs]' string of a
    config; or a registered name and its arguments."""
    registry = _registry(base_class, nickname)

    def create(*args, **kwargs):
        if len(args):
            name = args[0]
            args = args[1:]
        else:
            name = kwargs.pop(nickname)
        if isinstance(name, base_class):
            assert len(args) == 0 and len(kwargs) == 0, \
                '%s is already an instance. Additional arguments are ' \
                'invalid' % nickname
            return name
        if isinstance(name, dict):
            return create(**name)
        assert isinstance(name, string_types), \
            '%s must be of string type' % nickname
        if name.startswith('['):
            assert not args and not kwargs
            name, kwargs = json.loads(name)
            return create(name, **kwargs)
        name = name.lower()
        assert name in registry, \
            '%s is not registered. Known %ss: %s' % (
                name, nickname, ', '.join(registry))
        return registry[name](*args, **kwargs)
    create.__doc__ = 'Create a %s instance from config' % nickname
    return create
