"""Imperative autograd: the counterpart of ``mxnet_tpu/autograd.py``.

The JAX package records a tape of ``jax.vjp`` closures and walks it
backward. Here torch's own autograd graph is the tape: while
:func:`is_recording`, ``ndarray.invoke`` runs a differentiable op with
grad enabled, so each output tensor carries its ``grad_fn``; a marked
variable's tensor is a leaf that requires grad (``NDArray._data`` keeps it
one whenever the array is rebound). :func:`backward` finds the marked
variables under the heads by walking the graph from their ``grad_fn`` to
its leaves, takes their gradients with ``torch.autograd.grad`` and writes
them by each variable's ``grad_req``, exactly as the JAX tape does:
'write' writes the first gradient after ``attach_grad`` and adds the
later ones (until ``attach_grad`` again), 'add' always adds, 'null' skips.

The train/predict flag (:func:`is_training`) is separate from recording,
as in the JAX package: it drives BatchNorm and Dropout.

Alongside the graph each recorded output keeps a small record of its op,
attrs and parents (``NDArray._hist``), from which :func:`get_symbol`
builds a Symbol of the recorded history.
"""
import threading
import weakref

import torch

__all__ = ['record', 'pause', 'train_mode', 'predict_mode', 'is_recording',
           'is_training', 'mark_variables', 'backward', 'grad_and_loss',
           'grad', 'Function', 'get_symbol', 'set_recording',
           'set_training']

_state = threading.local()


def _st():
    if not hasattr(_state, 'recording'):
        _state.recording = False
        _state.training = False
    return _state


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def set_recording(flag):
    prev = _st().recording
    _state.recording = flag
    return prev


def set_training(flag):
    prev = _st().training
    _state.training = flag
    return prev


class _RecordingScope:
    def __init__(self, recording, training):
        self._recording = recording
        self._training = training

    def __enter__(self):
        st = _st()
        self._prev = (st.recording, st.training)
        if self._recording is not None:
            st.recording = self._recording
        if self._training is not None:
            st.training = self._training
        return self

    def __exit__(self, *args):
        _state.recording, _state.training = self._prev


def record(train_mode=True):
    """``with autograd.record():`` records the ops run inside it."""
    return _RecordingScope(True, train_mode)


def pause(train_mode=False):
    return _RecordingScope(False, train_mode)


def train_mode():
    return _RecordingScope(None, True)


def predict_mode():
    return _RecordingScope(None, False)


# ---------------------------------------------------------------------------
# variables and the backward walk
# ---------------------------------------------------------------------------

class _Record:
    """One recorded op, for :func:`get_symbol`: its name, attrs and the
    history entries of its inputs (a parent's ``(_Record, index)``, a
    marked variable's NDArray, or None for an unrecorded input)."""
    __slots__ = ('op_name', 'attrs', 'parents', 'n_outputs')

    def __init__(self, op_name, attrs, parents, n_outputs):
        self.op_name = op_name
        self.attrs = attrs
        self.parents = parents
        self.n_outputs = n_outputs


def history_of(arr):
    """The history entry an input contributes to a recorded op."""
    if arr._hist is not None:
        return arr._hist
    return arr if arr._grad_req is not None else None


def make_leaf(arr, tensor):
    """``tensor`` as the leaf of the marked variable ``arr``: a detached
    tensor that requires grad and knows its owner (floating types only;
    an integer array is marked but takes no gradient)."""
    if not tensor.is_floating_point():
        return tensor
    if not (tensor.is_leaf and tensor.requires_grad):
        tensor = tensor.detach().requires_grad_()
    tensor._mx_owner = weakref.ref(arr)
    return tensor


def mark_variables(variables, gradients, grad_reqs='write'):
    """Attach gradient buffers to variables: each becomes a leaf of the
    graphs recorded after this."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, grad, req in zip(variables, gradients, grad_reqs):
        var._grad = grad
        var._grad_req = req
        var._data = var._data        # the setter makes it a leaf


def _leaves(roots):
    """The marked NDArrays whose leaf tensors the graphs of ``roots`` reach
    (in the order found), and those tensors."""
    seen, stack, found = set(), [t.grad_fn for t in roots], {}
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        var = getattr(fn, 'variable', None)
        if var is not None:
            ref = getattr(var, '_mx_owner', None)
            owner = ref() if ref is not None else None
            if owner is not None:
                found.setdefault(id(var), (owner, var))
            continue
        stack.extend(nxt for nxt, _ in fn.next_functions)
    return list(found.values())


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Run the recorded graph backward from head NDArrays into the marked
    variables' gradients. A head outside any recorded graph raises."""
    from .ndarray.ndarray import NDArray
    if isinstance(heads, NDArray):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, NDArray):
        head_grads = [head_grads]
    outs, cots = [], []
    for h, hg in zip(heads, head_grads):
        t = h._data
        g = hg._data if hg is not None else torch.ones_like(t)
        if t.grad_fn is None:
            if h._grad_req is not None and h._grad is not None:
                _accumulate_leaf(h, g.detach())
                continue
            raise ValueError(
                'cannot run backward: the array is not part of a recorded '
                'computation graph (compute it inside autograd.record())')
        outs.append(t)
        cots.append(g.detach().to(t.dtype))
    if outs:
        pairs = _leaves(outs)
        if pairs:
            grads = torch.autograd.grad(outs, [t for _, t in pairs], cots,
                                        retain_graph=retain_graph,
                                        allow_unused=True)
            for (owner, _), g in zip(pairs, grads):
                if g is not None:
                    _accumulate_leaf(owner, g)
    if not retain_graph:
        for h in heads:
            h._hist = None


def _accumulate_leaf(var, g):
    if var._grad is None or var._grad_req in (None, 'null'):
        return
    dst = var._grad
    g = g.to(dst._data.dtype)
    if var._grad_req == 'add':
        dst._data = dst._data + g
    elif var._fresh_grad:
        dst._data = g.expand(dst.shape).clone() if g.shape != dst._data.shape \
            else g
        var._fresh_grad = False
    else:
        dst._data = dst._data + g


def grad_and_loss(func, argnum=None):
    """A function computing both the gradients and the loss of ``func``."""
    def wrapped(*args):
        variables = list(args)
        if argnum is not None:
            argnums = [argnum] if isinstance(argnum, int) else argnum
            variables = [args[i] for i in argnums]
        for v in variables:
            v.attach_grad()
        with record():
            outputs = func(*args)
        backward([outputs] if not isinstance(outputs, (list, tuple))
                 else list(outputs))
        return [v.grad for v in variables], outputs
    return wrapped


def grad(func, argnum=None):
    def wrapped(*args):
        return grad_and_loss(func, argnum)(*args)[0]
    return wrapped


def get_symbol(x):
    """The recorded history of ``x`` as a Symbol: each recorded op becomes
    a node, marked variables and unrecorded inputs become Variables."""
    from .symbol import Variable
    from .symbol.symbol import _invoke_sym
    if x._hist is None:
        return Variable('var0')
    memo, counter = {}, [0]

    def build(entry):
        if not isinstance(entry, tuple):
            key = id(entry) if entry is not None else ('anon', counter[0])
            if key not in memo:
                memo[key] = Variable('var%d' % counter[0])
                counter[0] += 1
            return memo[key]
        rec, idx = entry
        if id(rec) not in memo:
            attrs = {k: v for k, v in rec.attrs.items()
                     if not k.startswith('__')}
            memo[id(rec)] = _invoke_sym(
                rec.op_name, [build(p) for p in rec.parents], attrs)
        sym = memo[id(rec)]
        return sym[idx] if rec.n_outputs > 1 else sym
    return build(x._hist)


class _FunctionBridge(torch.autograd.Function):
    """A user :class:`Function` as one node of torch's graph: its forward
    runs the user's forward, its backward the user's backward."""

    @staticmethod
    def forward(ctx, fn, holder, *tensors):
        from .ndarray.ndarray import NDArray
        outputs = fn.forward(*holder['inputs'])
        holder['outputs'] = outputs
        outs = (outputs,) if isinstance(outputs, NDArray) else tuple(outputs)
        ctx.fn = fn
        ctx.n_in = len(tensors)
        ctx.out_ctx = [o._ctx for o in outs]
        return tuple(o._data.detach() for o in outs)

    @staticmethod
    def backward(ctx, *cots):
        from .ndarray.ndarray import NDArray
        prev = set_recording(False)
        try:
            rets = ctx.fn.backward(*[NDArray(c, x) for c, x
                                     in zip(cots, ctx.out_ctx)])
        finally:
            set_recording(prev)
        if isinstance(rets, NDArray):
            rets = (rets,)
        assert len(rets) == ctx.n_in, (
            '%s.backward must return exactly as many NDArrays as forward '
            'takes arguments (expected %d, got %d)'
            % (type(ctx.fn).__name__, ctx.n_in, len(rets)))
        return (None, None) + tuple(r._data for r in rets)


class Function:
    """User-defined differentiable function: define ``forward`` and
    ``backward`` over NDArrays; when gradients are computed the custom
    backward replaces the chain rule. Example::

        class sigmoid(Function):
            def forward(self, x):
                y = 1 / (1 + mx.nd.exp(-x))
                self.save_for_backward(y)
                return y

            def backward(self, dy):
                y, = self.saved_tensors
                return dy * y * (1 - y)
    """

    def __init__(self):
        self._used = False
        self.saved_tensors = ()

    def save_for_backward(self, *args):
        self.saved_tensors = args

    def forward(self, *inputs):
        raise NotImplementedError()

    def backward(self, *output_grads):
        raise NotImplementedError()

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        assert not self._used, \
            'Each Function instance can only be called once. ' \
            'Please create another instance.'
        self._used = True
        if not is_recording():
            return self.forward(*inputs)
        holder = {'inputs': inputs}
        set_recording(False)
        try:
            tensors = _FunctionBridge.apply(self, holder,
                                            *[i._data for i in inputs])
        finally:
            set_recording(True)
        outputs = holder['outputs']
        outs = (outputs,) if isinstance(outputs, NDArray) else tuple(outputs)
        rec = _Record('_CustomFunction', {}, [history_of(i) for i in inputs],
                      len(outs))
        for i, (o, t) in enumerate(zip(outs, tensors)):
            o._data = t
            o._hist = (rec, i)
        return outputs
