"""Device context: the PyTorch counterpart of ``mxnet_tpu/context.py``.

A Context names a torch device. ``gpu(i)`` is the i-th CUDA card and the
default context; ``cpu()`` is the host. There is no fallback between
them: asking for a card on a machine without one raises, so a run that
was meant for the card never lands quietly on the CPU.
"""
import threading

import torch

__all__ = ['Context', 'cpu', 'gpu', 'current_context', 'as_torch_device']

_thread_local = threading.local()


class Context:
    """Execution device. Immutable, hashable, usable as a ``with`` scope."""

    devtype2str = {1: 'cpu', 2: 'gpu'}
    devstr2type = {'cpu': 1, 'gpu': 2}

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, device_type.device_id
        if isinstance(device_type, str):
            if device_type not in self.devstr2type:
                raise ValueError('unknown device type %r (expected cpu or gpu)'
                                 % device_type)
            device_type = self.devstr2type[device_type]
        if device_type not in self.devtype2str:
            raise ValueError('unknown device type id %r' % device_type)
        self.device_typeid = device_type
        self.device_id = int(device_id)

    @property
    def device_type(self):
        return self.devtype2str[self.device_typeid]

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __repr__(self):
        return '%s(%d)' % (self.device_type, self.device_id)

    def __enter__(self):
        if not hasattr(_thread_local, 'stack'):
            _thread_local.stack = []
        _thread_local.stack.append(self)
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        _thread_local.stack.pop()

    def torch_device(self):
        """The torch.device this context names. Raises for a card that
        this machine does not have."""
        if self.device_type == 'cpu':
            return torch.device('cpu')
        if not torch.cuda.is_available():
            raise RuntimeError('%r requested but CUDA is not available; '
                               'pass cpu() explicitly to run on the host'
                               % self)
        n = torch.cuda.device_count()
        if self.device_id >= n:
            raise RuntimeError('%r requested but only %d CUDA device(s) '
                               'are visible' % (self, n))
        return torch.device('cuda', self.device_id)


def cpu(device_id=0):
    return Context('cpu', device_id)


def gpu(device_id=0):
    """The ``device_id``-th CUDA card. Raises when CUDA is not available."""
    ctx = Context('gpu', device_id)
    ctx.torch_device()
    return ctx


def current_context():
    """The innermost ``with ctx:`` scope, else ``gpu(0)``."""
    if getattr(_thread_local, 'stack', None):
        return _thread_local.stack[-1]
    return gpu(0)


def as_torch_device(device):
    """``device`` (a Context, a torch.device, a string or None for the
    current context) as a torch.device. A CUDA device is checked to
    exist; there is no fallback to the CPU."""
    if device is None:
        device = current_context()
    if isinstance(device, Context):
        return device.torch_device()
    device = torch.device(device)
    if device.type == 'cuda':
        return Context('gpu', device.index or 0).torch_device()
    if device.type != 'cpu':
        raise ValueError('unsupported device %s (expected cpu or cuda)'
                         % device)
    return device
