"""Single operator registry: the counterpart of ``mxnet_tpu/ops/registry.py``.

Each op declares a PyTorch implementation ``fn(attrs, *tensors)``. The
NDArray frontend (``mxnet_tpu_torch.ndarray``) generates one function per
registered op from its ``input_names`` and ``param_defaults``.

Conventions kept from the JAX registry:

- ``fn`` returns a single tensor or a tuple of tensors.
- ops mutating inputs in the reference declare ``mutate_inputs``: a dict
  {input_index: extra_output_index}; the invoke layer writes those extra
  outputs back into the input NDArrays.
- ``train_aware`` ops receive ``__is_train__`` in attrs.
- ``needs_rng`` ops receive a ``torch.Generator`` as their LAST argument
  (``None`` during shape inference, where their tensors are on ``meta``).
- ``variadic`` ops take any number of inputs (``add_n``); the attr named by
  ``key_var_num_args`` carries their count.
- ``differentiable=False`` ops are never recorded by autograd;
  ``aux_inputs`` names the inputs that are auxiliary states (BatchNorm's
  moving statistics) in a Symbol; ``optional_inputs`` maps an input to the
  attr that gates it; ``arg_names_fn(attrs)`` gives the inputs a Symbol
  creates for the op (FullyConnected without a bias has two).
- ``host`` and ``shape_fn`` describe host ops (Python on concrete arrays,
  with their output shapes from ``shape_fn``): the image codecs ``_cv*``
  of ``legacy_ops.py``. The executor raises NotImplementedError for a
  graph that holds one.

What the JAX registry has and this one does not: PyTorch runs eagerly, so
``jitted`` (a cached ``jax.jit`` closure per op and attrs) has no
counterpart and an op is a plain call; ``host_bridge`` (host ops inside
traced programs) and the execution-coverage bookkeeping come with the rest
of the op library.
"""
__all__ = ['OpDef', 'register', 'register_alias', 'get', 'exists',
           'list_ops', 'apply_op', 'lazy_op_module']

_OPS = {}


class OpDef:
    def __init__(self, name, fn, num_outputs=1, input_names=None,
                 param_defaults=None, mutate_inputs=None, needs_rng=False,
                 num_visible_outputs=None, train_aware=False, variadic=False,
                 key_var_num_args=None, differentiable=True, aux_inputs=(),
                 host=False, shape_fn=None, optional_inputs=None,
                 arg_names_fn=None, doc=None):
        self.name = name
        self.fn = fn
        self.num_outputs = num_outputs  # int or callable(attrs)->int
        # an explicit [] means a nullary op; only None falls back to the
        # single-'data' convention
        self.input_names = (['data'] if input_names is None
                            else list(input_names))
        self.param_defaults = param_defaults or {}
        self.mutate_inputs = mutate_inputs or {}
        self.needs_rng = needs_rng
        self.num_visible_outputs = num_visible_outputs  # int or callable
        self.train_aware = train_aware
        self.variadic = variadic  # takes *args (add_n style)
        self.key_var_num_args = key_var_num_args  # attr naming the input count
        self.differentiable = differentiable
        self.aux_inputs = tuple(aux_inputs)
        self.host = host
        self.shape_fn = shape_fn
        self.optional_inputs = dict(optional_inputs or {})
        self.arg_names_fn = arg_names_fn
        self.doc = doc or (fn.__doc__ or '')

    def n_outputs(self, attrs):
        n = self.num_outputs
        return n(attrs) if callable(n) else n

    def n_visible_outputs(self, attrs):
        n = self.num_visible_outputs
        if n is None:
            return self.n_outputs(attrs)
        return n(attrs) if callable(n) else n

    def arg_names(self, attrs=None, num_args=None):
        """The inputs a Symbol node of this op takes: variadic ops expand
        arg0..argN-1; ``arg_names_fn`` decides where the op has one;
        optional inputs are dropped unless their gate attr is truthy."""
        if self.variadic:
            return ['arg%d' % i for i in range(num_args or 0)]
        attrs = attrs or {}
        if self.arg_names_fn is not None:
            return list(self.arg_names_fn(attrs))
        names = list(self.input_names)
        if self.optional_inputs:
            def _on(gate):
                v = attrs.get(gate, self.param_defaults.get(gate, False))
                return v not in (False, 'False', '0', 0, None, 'false')
            names = [n for n in names if n not in self.optional_inputs
                     or _on(self.optional_inputs[n])]
        return names


def register(name, **kwargs):
    """Decorator registering ``fn(attrs, *tensors)`` as operator ``name``."""
    def deco(fn):
        _OPS[name] = OpDef(name, fn, **kwargs)
        return fn
    return deco


def register_alias(alias, name):
    _OPS[alias] = _OPS[name]


def get(name):
    op = _OPS.get(name)
    if op is None:
        raise KeyError('operator %r is not registered' % (name,))
    return op


def exists(name):
    return name in _OPS


def list_ops():
    return sorted(_OPS)


def apply_op(name, attrs, *tensors):
    """Apply op ``name`` to torch tensors directly."""
    return get(name).fn(attrs, *tensors)


def lazy_op_module(module_globals, make_fn):
    """Build (__getattr__, __dir__) for a generated-op module path
    (``nd.op``). Resolved functions are cached into the module's globals."""
    def __getattr__(name):
        if exists(name):
            fn = make_fn(name)
            module_globals[name] = fn
            return fn
        raise AttributeError('operator %r is not registered' % (name,))

    def __dir__():
        return list_ops()
    return __getattr__, __dir__
