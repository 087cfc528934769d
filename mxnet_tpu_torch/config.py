"""Typed environment flags: the counterpart of the flag registry of
``mxnet_tpu/config.py`` (``Flag``, ``FlagRegistry``, ``flags``), with its
``flags.get``/``flags.reload`` surface and its parsing and validation
(the JAX registry's MXNET_* aliases, enum choices and catalog text are
not ported: no ported flag uses them).

Only the flags that the ported modules read are declared. Their names are
the JAX package's, so one environment drives both packages:

- ``MXTPU_SERVE_MAX_BATCH``: the serving engine's largest batch bucket;
- ``MXTPU_FORCE_PALLAS``: take the kernel branch of the registry ops for
  CPU tensors too (their plain versions there), as the JAX package takes
  its Pallas kernels in interpret mode off the TPU.
"""
import os
import threading

__all__ = ['Flag', 'FlagRegistry', 'flags']


class Flag:
    def __init__(self, name, type_, default, doc, min_value=None,
                 max_value=None):
        self.name = name
        self.type = type_
        self.default = default
        self.doc = doc
        self.min_value = min_value
        self.max_value = max_value

    def parse(self, raw):
        if raw is None:
            return self.default
        try:
            if self.type is bool:
                val = raw.strip().lower() not in ('', '0', 'false', 'no')
            else:
                val = self.type(raw)
        except (TypeError, ValueError):
            raise ValueError(
                'env %s=%r: expected %s' % (self.name, raw,
                                            self.type.__name__))
        if self.min_value is not None and val < self.min_value:
            raise ValueError('env %s=%r: must be >= %s'
                             % (self.name, raw, self.min_value))
        if self.max_value is not None and val > self.max_value:
            raise ValueError('env %s=%r: must be <= %s'
                             % (self.name, raw, self.max_value))
        return val


class FlagRegistry:
    def __init__(self):
        self._flags = {}
        self._cache = {}
        self._lock = threading.Lock()

    def declare(self, name, type_, default, doc, **kwargs):
        flag = Flag(name, type_, default, doc, **kwargs)
        self._flags[name] = flag
        return flag

    def get(self, name):
        """Parsed + validated value of a declared flag (cached)."""
        with self._lock:
            if name in self._cache:
                return self._cache[name]
            flag = self._flags[name]  # KeyError = undeclared flag: a bug
            val = flag.parse(os.environ.get(flag.name))
            self._cache[name] = val
            return val

    def reload(self, name=None):
        """Drop cached values (tests mutate os.environ)."""
        with self._lock:
            if name is None:
                self._cache.clear()
            else:
                self._cache.pop(name, None)


flags = FlagRegistry()

flags.declare('MXTPU_FORCE_PALLAS', bool, False,
              'Dispatch LayerNorm/softmax/softmax_cross_entropy to their '
              'kernel branch for CPU tensors too, where the kernel wrappers '
              'run their plain versions (exercises that branch in CPU '
              'tests). CUDA tensors always take the kernels.')
flags.declare('MXTPU_SERVE_MAX_BATCH', int, 32,
              'Largest serving batch bucket (mxnet_tpu_torch/serving): the '
              'engine keeps one bucket per power of two up to this size, '
              'and requests pad up to the smallest covering bucket or are '
              'cut into chunks of the largest',
              min_value=1, max_value=65536)
