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
  of ``legacy_ops.py`` and the Python-callback ops (``Custom``,
  ``_Native``, ``_NDArray``, ``_CustomFunction``). A graph runs them
  through :func:`host_bridge`; an op may carry ``legacy_backward(attrs,
  out_grads, inputs, outputs)``, the user's backward.

What the JAX registry has and this one does not: PyTorch runs eagerly, so
``jitted`` (a cached ``jax.jit`` closure per op and attrs) has no
counterpart and an op is a plain call, and :func:`host_bridge` needs no
callback into the host: it is a ``torch.autograd.Function`` around the
op's call. The execution-coverage bookkeeping is not ported.
"""
import torch

__all__ = ['OpDef', 'register', 'register_alias', 'get', 'exists',
           'list_ops', 'apply_op', 'lazy_op_module', 'host_bridge',
           'bridge_apply']

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


def lazy_op_module(module_globals, make_fn, underscore_only=False):
    """Build (__getattr__, __dir__) for a generated-op module path
    (``nd.op``, ``nd._internal``). Resolved functions are cached into the
    module's globals."""
    def __getattr__(name):
        if exists(name):
            fn = make_fn(name)
            module_globals[name] = fn
            return fn
        raise AttributeError('operator %r is not registered' % (name,))

    def __dir__():
        ops = list_ops()
        return [n for n in ops if n.startswith('_')] \
            if underscore_only else ops
    return __getattr__, __dir__


class _HostBridge(torch.autograd.Function):
    """One host call as a node of torch's graph: the forward runs
    ``fwd(*tensors)``; the backward runs ``bwd(out_grads, inputs,
    outputs)`` where there is one (missing output gradients are zeros),
    else passes zero gradients. Floating inputs take their gradient in
    their own device and dtype; other inputs take none."""

    @staticmethod
    def forward(ctx, fwd, bwd, *tensors):
        outs = fwd(*tensors)
        single = not isinstance(outs, (tuple, list))
        outs = (outs,) if single else tuple(outs)
        ctx.bwd = bwd
        ctx.n_in = len(tensors)
        ctx.save_for_backward(*tensors, *outs)
        ctx.mark_non_differentiable(*[o for o in outs
                                      if not o.is_floating_point()])
        return outs[0] if single else outs

    @staticmethod
    def backward(ctx, *gouts):
        saved = ctx.saved_tensors
        ins, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        if ctx.bwd is None:
            grads = [torch.zeros_like(t) for t in ins]
        else:
            gouts = [torch.zeros_like(o) if g is None else g
                     for g, o in zip(gouts, outs)]
            grads = ctx.bwd(gouts, ins, outs)
        rets = []
        for g, t in zip(grads, ins):
            if not t.is_floating_point():
                rets.append(None)
            elif g is None:
                rets.append(torch.zeros_like(t))
            elif isinstance(g, torch.Tensor):
                rets.append(g.detach().to(t.device, t.dtype))
            else:
                rets.append(torch.as_tensor(g).to(t.device, t.dtype))
        rets += [None] * (len(ins) - len(rets))
        return (None, None) + tuple(rets)


def host_scope(tensors):
    """The Context of the first tensor, for a ``with`` around a host call:
    what the callback allocates lands on its node's device. Nothing for a
    call without tensors, which takes the current context."""
    import contextlib
    from ..context import Context
    if not tensors:
        return contextlib.nullcontext()
    d = tensors[0].device
    return Context('gpu', d.index or 0) if d.type == 'cuda' else \
        Context('cpu', 0)


def bridge_apply(fwd, bwd, tensors):
    """Run ``fwd`` on ``tensors`` as one recorded node whose backward is
    ``bwd`` (None: zero gradients). Both run with autograd's recording
    off, inside the first tensor's Context, on tensors outside any graph.
    Errors propagate; nothing falls back."""
    from .. import autograd as _ag

    def run(fn, scope, *args):
        prev = _ag.set_recording(False)
        try:
            with host_scope(scope):
                return fn(*args)
        finally:
            _ag.set_recording(prev)

    def fwd_(*ts):
        ts = [t.detach() for t in ts]
        return run(fwd, ts, *ts)

    def bwd_(gouts, ins, outs):
        ins = [t.detach() for t in ins]
        return run(bwd, ins, [g.detach() for g in gouts], ins,
                   [o.detach() for o in outs])
    return _HostBridge.apply(fwd_, bwd_ if bwd is not None else None,
                             *tensors)


def host_bridge(op, attrs):
    """A host op as a callable on tensors, for a graph's runner: the op's
    ``fn`` with its outputs moved onto the first input's device (a host
    callback returns to the graph's device), and the op's
    ``legacy_backward`` as its gradient, zero gradients where it has none
    (the codecs). ``attrs`` is passed to both, so an op may keep state on
    it between its forward and its backward (Custom's operator
    instance)."""
    backward = getattr(op, 'legacy_backward', None)

    def fwd(*ts):
        outs = op.fn(attrs, *ts)
        if not ts:
            return outs
        dev = ts[0].device
        if isinstance(outs, (tuple, list)):
            return tuple(o.to(dev) for o in outs)
        return outs.to(dev)

    def bwd(gouts, ins, outs):
        return backward(attrs, gouts, ins, outs)

    def call(*tensors):
        return bridge_apply(fwd, bwd if backward is not None else None,
                            tensors)
    return call
