"""Weight initializers: the counterpart of ``mxnet_tpu/initializer.py``
(the Initializer base with its dispatch on the parameter's name, InitDesc,
the registry, Zero/One/Constant/Uniform/Normal/Orthogonal/Xavier/MSRAPrelu/
Bilinear/LSTMBias/FusedRNN, Load and Mixed).

The random ones draw on the host from :func:`..random.host_rng`, a numpy
``RandomState`` as in the JAX package, and write through
``arr[:] = values``; so after ``random.seed(s)`` the same initializers in
the same order give the same weights as the JAX package's. ``Load`` takes
a dict of arrays or a file that ``nd.save`` wrote.
"""
import json
import re

import numpy as np

from . import ndarray as nd
from . import random as _random

__all__ = ['InitDesc', 'Initializer', 'Uniform', 'Normal', 'Orthogonal',
           'LSTMBias', 'Xavier', 'MSRAPrelu', 'Bilinear', 'One', 'Zero',
           'Constant', 'FusedRNN', 'Load', 'Mixed', 'register', 'init',
           'create']

_INIT_REGISTRY = {}


def register(klass):
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


class InitDesc(str):
    """A parameter's name with its attrs (``__init__`` holds a per-parameter
    initializer in JSON) and the global initializer."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer:
    """Base class; ``__call__`` dispatches on the name's suffix."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs
        self._verbose = False
        self._print_func = None

    def set_verbosity(self, verbose=False, print_func=None):
        self._verbose = verbose
        self._print_func = print_func
        return self

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, str):
            raise TypeError('desc must be a string or InitDesc')
        if isinstance(desc, InitDesc) and desc.global_init is None:
            desc.global_init = self
        init = desc.attrs.get('__init__', '') if isinstance(desc, InitDesc) \
            else ''
        if init:
            klass, kwargs = json.loads(init)
            _INIT_REGISTRY[klass.lower()](**kwargs)._init_weight(desc, arr)
            return
        name = str(desc)
        if name.endswith('weight') or name.endswith('parameters'):
            self._init_weight(name, arr)
        elif name.endswith('bias'):
            self._init_bias(name, arr)
        elif name.endswith('gamma'):
            self._init_gamma(name, arr)
        elif name.endswith('beta'):
            self._init_beta(name, arr)
        elif name.endswith('moving_mean') or name.endswith('running_mean'):
            self._init_zero(name, arr)
        elif name.endswith('moving_var') or name.endswith('running_var'):
            self._init_one(name, arr)
        elif name.endswith('moving_inv_var') or name.endswith('moving_avg'):
            self._init_zero(name, arr)
        elif name.endswith('min') or name.endswith('max'):
            self._init_zero(name, arr)
        else:
            self._init_default(name, arr)

    def _init_bias(self, _, arr):
        arr[:] = 0.0

    def _init_gamma(self, _, arr):
        arr[:] = 1.0

    def _init_beta(self, _, arr):
        arr[:] = 0.0

    def _init_zero(self, _, arr):
        arr[:] = 0.0

    def _init_one(self, _, arr):
        arr[:] = 1.0

    def _init_weight(self, name, arr):
        raise NotImplementedError()

    def _init_default(self, name, arr):
        raise ValueError(
            'Unknown initialization pattern for %s. Default initialization '
            'is limited to "weight", "bias", "gamma" (1.0), and "beta" (0.0).'
            % name)


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 0.0

    _init_default = _init_weight


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 1.0

    _init_default = _init_weight


@register
class LSTMBias(Initializer):
    """All LSTM biases 0 except the forget gate's, ``forget_bias``."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        arr[:] = 0.0
        num_hidden = int(arr.shape[0] / 4)
        arr[num_hidden:2 * num_hidden] = self.forget_bias

    _init_bias = _init_weight
    _init_default = _init_weight


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        arr[:] = self.value

    _init_default = _init_weight


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        arr[:] = _random.host_rng().uniform(-self.scale, self.scale, arr.shape)


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        arr[:] = _random.host_rng().normal(0, self.sigma, arr.shape)


@register
class Orthogonal(Initializer):
    def __init__(self, scale=1.414, rand_type='uniform'):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        if self.rand_type == 'uniform':
            tmp = _random.host_rng().uniform(-1.0, 1.0, (nout, nin))
        else:
            tmp = _random.host_rng().normal(0.0, 1.0, (nout, nin))
        u, _, v = np.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        arr[:] = self.scale * q.reshape(arr.shape)


@register
class Xavier(Initializer):
    """Xavier/Glorot: gaussian or uniform, over the fan avg, in or out."""

    def __init__(self, rnd_type='uniform', factor_type='avg', magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        hw_scale = 1.
        if len(shape) < 2:
            raise ValueError('Xavier initializer cannot be applied to vector '
                             '%s. This may be due to missing shape info' % name)
        if len(shape) > 2:
            hw_scale = np.prod(shape[2:])
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = fan_in
        if self.factor_type == 'avg':
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == 'out':
            factor = fan_out
        scale = np.sqrt(self.magnitude / factor)
        if self.rnd_type == 'uniform':
            arr[:] = _random.host_rng().uniform(-scale, scale, arr.shape)
        else:
            arr[:] = _random.host_rng().normal(0, scale, arr.shape)


@register
class MSRAPrelu(Xavier):
    def __init__(self, factor_type='avg', slope=0.25):
        magnitude = 2. / (1 + slope ** 2)
        super().__init__('gaussian', factor_type, magnitude)
        self._kwargs = {'factor_type': factor_type, 'slope': slope}


@register
class Bilinear(Initializer):
    def _init_weight(self, _, arr):
        weight = np.zeros(arr.size, dtype='float32')
        shape = arr.shape
        f = np.ceil(shape[3] / 2.)
        c = (2 * f - 1 - f % 2) / (2. * f)
        for i in range(arr.size):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        arr[:] = weight.reshape(shape)


class Load:
    """Initialise from a dict of arrays or a file of them (``nd.load``;
    names may carry the ``arg:`` and ``aux:`` prefixes), else by
    ``default_init``."""

    def __init__(self, param, default_init=None, verbose=False):
        if isinstance(param, str):
            param = nd.load(param)
        self.param = {}
        for name, arr in param.items():
            if name.startswith('arg:') or name.startswith('aux:'):
                self.param[name[4:]] = arr
            else:
                self.param[name] = arr
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        if name in self.param:
            if arr.shape != self.param[name].shape:
                raise ValueError('Parameter %s cannot be initialized from '
                                 'loading. Shape mismatch, target %s vs loaded %s'
                                 % (name, str(arr.shape),
                                    str(self.param[name].shape)))
            arr[:] = self.param[name]
        else:
            if self.default_init is None:
                raise ValueError('Cannot Initialize parameter: %s' % name)
            self.default_init(name, arr)


class Mixed:
    """The first pattern (a regex matched at the start of the name) picks
    the initializer."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise ValueError('patterns and initializers must have same length')
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr):
        for prog, i in self.map:
            if prog.match(name):
                i(name, arr)
                return
        raise ValueError('Parameter name %s did not match any pattern' % name)


def _rnn_gates(mode):
    return {'rnn_relu': 1, 'rnn_tanh': 1, 'lstm': 4, 'gru': 3}[mode]


@register
class FusedRNN(Initializer):
    """Fills a fused RNN's flat parameter vector by ``init``, with the LSTM
    forget-gate biases at ``forget_bias / 2`` each (the biases are the
    vector's last ``L * dirs * gates * H * 2`` entries)."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0):
        if isinstance(init, str):
            klass, kwargs = json.loads(init)
            init = _INIT_REGISTRY[klass.lower()](**kwargs)
        super().__init__(init=init.dumps() if init is not None else None,
                         num_hidden=num_hidden, num_layers=num_layers,
                         mode=mode, bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._init = init
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        arr[:] = _random.host_rng().uniform(-0.07, 0.07, arr.shape) \
            if self._init is None else arr.asnumpy()
        if self._init is not None:
            tmp = nd.array(np.zeros(arr.shape, dtype='float32'),
                           ctx=arr.context)
            self._init(InitDesc('weight'), tmp)
            arr[:] = tmp
        if self._mode == 'lstm':
            H = self._num_hidden
            dirs = 2 if self._bidirectional else 1
            g = _rnn_gates(self._mode)
            a = arr.asnumpy().copy()
            bias_start = arr.size - self._num_layers * dirs * g * H * 2
            for ld in range(self._num_layers * dirs):
                for which in range(2):  # bW, bR
                    base = bias_start + ld * g * H * 2 + which * g * H
                    a[base + H: base + 2 * H] = self._forget_bias / 2.0
            arr[:] = a


def init(name):
    return _INIT_REGISTRY[name.lower()]


_STRING_ALIASES = {'zeros': 'zero', 'ones': 'one'}


def create(spec):
    """An initializer from a spec: an Initializer passes through; a string
    ('normal', 'xavier', 'zeros', ...) resolves through the registry."""
    if spec is None or not isinstance(spec, str):
        return spec
    key = _STRING_ALIASES.get(spec.lower(), spec.lower())
    try:
        return _INIT_REGISTRY[key]()
    except KeyError:
        raise ValueError('unknown initializer %r (known: %s)'
                         % (spec, ', '.join(sorted(_INIT_REGISTRY))))
