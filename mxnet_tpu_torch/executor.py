"""Executor, a bound symbol graph: the counterpart of
``mxnet_tpu/executor.py``.

:class:`_GraphProgram` holds a symbol's canonical input orders and
:meth:`_GraphProgram.make_runner` builds ``run(args, aux, seed, is_train)
-> (outputs, new_aux)``: the graph's ops called in topological order on
torch tensors, each inside ``torch.profiler.record_function`` under its
node's name (the JAX package's ``jax.named_scope``), a ``needs_rng`` node
drawing from a generator seeded by the run's seed and its index (as the
JAX runner folds the node's index into the step's key), and the aux
states an op mutates (BatchNorm's moving statistics) returned as new
values. Where the JAX package jits the runner and takes ``jax.vjp`` of it,
the port runs it eagerly and differentiates it with torch autograd.

The JAX package's staged mode (a second, per-node interpreter for
``group2ctx``, monitor callbacks and host ops) is here the same runner
with per-node hooks (:meth:`_GraphProgram.make_node_exec`): a node-device
function moves each node's inputs onto its ``ctx_group``'s device, an
observer sees each node's values (the monitor, the NaN bisect), and a host
op (``Custom``, the legacy Python ops, the codecs) runs through
``registry.host_bridge``. A run with hooks is the plain run's ops in the
same order with the same draws, so its results are the plain run's bit
for bit where the devices are the same.

:func:`mirror_wrap` is ``MXTPU_BACKWARD_DO_MIRROR`` (or the reference's
``MXNET_BACKWARD_DO_MIRROR``): the forward recomputed in the backward by
``torch.utils.checkpoint``, all of it, or all but the convolution and
matmul results with ``dots``. The gradients are the same either way.

:class:`Executor` binds a symbol to arrays: forward, backward with
``grad_req`` write/add/null, the outputs and the arg/grad/aux/output
dicts, ``copy_params_from``, ``reshape``, ``set_monitor_callback``,
``partial_forward`` (one op node a call) and ``first_nonfinite_node`` (the
first NaN/Inf value of a replay). With the health or dynamics plane on
(``MXTPU_HEALTH``, ``MXTPU_DYNAMICS``) a backward also computes the step's
sentinel vectors on the device from its gradients and weights and checks
them (``telemetry.health.note_step``, the bisect on a non-finite flag,
before the optimizer's update runs); the ``executor`` seam of fault
injection sits at the backward's start. A training forward keeps its graph
for the backward that follows it (with a monitor too: the JAX package's staged
backward runs the forward again under a fresh key, ROADMAP.md §3); a
backward without one runs the forward first. Forward and backward are the
``executor.forward`` and ``executor.backward`` telemetry spans (host time:
the kernels they launch run on after they return), which the profiler's
trace also takes.
"""
import functools

import torch

from . import faults as _faults
from . import random as _random
from . import telemetry as _tele
from .base import MXNetError, np_dtype
from .context import Context
from .ops import registry as _reg
from .ndarray.ndarray import NDArray, zeros as nd_zeros

__all__ = ['Executor', 'simple_bind', 'mirror_wrap']

# the ops whose results 'dots' keeps: the convolutions and matmuls
_DOTS = None


def _dots():
    global _DOTS
    if _DOTS is None:
        aten = torch.ops.aten
        _DOTS = {aten.convolution.default, aten.mm.default, aten.bmm.default,
                 aten.addmm.default, aten.matmul.default,
                 aten._convolution.default, aten.cudnn_convolution.default}
    return _DOTS


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    if op in _dots():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def mirror_wrap(f):
    """``f`` with its forward recomputed in the backward, by the flag:
    '1' (any truthy value) all of it, 'dots' all but the convolution and
    matmul results, '0'/''/'false' not at all (``f`` itself)."""
    from .config import flags as _flags
    val = _flags.get('MXTPU_BACKWARD_DO_MIRROR')
    if val in ('', '0', 'false', 'False'):
        return f
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    kwargs = {'use_reentrant': False}
    if val == 'dots':
        kwargs['context_fn'] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)

    @functools.wraps(f)
    def wrapped(*args):
        if not torch.is_grad_enabled():
            return f(*args)
        return checkpoint(f, *args, **kwargs)
    return wrapped


def _entry_key(node, idx):
    return (id(node), idx)


class _GraphProgram:
    """A symbol's canonical input orders and its runner."""

    def __init__(self, symbol):
        self.symbol = symbol
        self.topo = symbol._topo()
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.outputs = list(symbol._outputs)
        self.has_host_ops = any(not n.is_variable() and n.opdef().host
                                for n in self.topo)
        self.op_nodes = [n for n in self.topo if not n.is_variable()]
        self.topo_index = {n: i for i, n in enumerate(self.topo)}
        # profiler ranges carry the symbol's layer names
        self.scope_names = [n.name for n in self.topo]

    def make_node_exec(self, node_device=None, observe=None):
        """``exec_node(env, new_aux, ni, arg_tensors, aux_tensors, seed,
        is_train)``: node ``ni`` of the topological order run into ``env``
        (a variable takes its value), its mutated aux states into
        ``new_aux``; returns the node's values.

        The per-node hooks, each None on the plain path: ``node_device(node)``
        is the device a node runs on (its inputs cross with ``.to``, which
        the graph records, so gradients flow back across the copy);
        ``observe(node, values)`` sees every node's values, variables
        included, as they are made. A host op runs through
        ``registry.host_bridge`` with one attrs dict per node for the
        runner's life (a Custom op keeps its operator instance there).
        """
        topo = self.topo
        arg_index = {n: i for i, n in enumerate(self.arg_names)}
        aux_index = {n: i for i, n in enumerate(self.aux_names)}
        scope_names = self.scope_names
        record_function = torch.profiler.record_function
        host_attrs = {ni: dict(n.attrs) for ni, n in enumerate(topo)
                      if not n.is_variable() and n.opdef().host}
        host_calls = {ni: _reg.host_bridge(topo[ni].opdef(), a)
                      for ni, a in host_attrs.items()}

        def exec_node(env, new_aux, ni, arg_arrays, aux_arrays, seed,
                      is_train):
            node = topo[ni]
            dev = node_device(node) if node_device is not None else None
            if node.is_variable():
                if node.name in aux_index:
                    t = aux_arrays[aux_index[node.name]]
                else:
                    t = arg_arrays[arg_index[node.name]]
                if dev is not None:
                    t = t.to(dev)
                env[_entry_key(node, 0)] = t
                if observe is not None:
                    observe(node, (t,))
                return (t,)
            op = node.opdef()
            call = host_calls.get(ni)
            attrs = node.attrs if call is None else host_attrs[ni]
            if op.train_aware:
                if call is None:
                    attrs = dict(attrs)
                attrs['__is_train__'] = is_train
            ins = [env[_entry_key(p, i)] for p, i in node.inputs]
            if dev is not None:
                ins = [x.to(dev) for x in ins]
            if op.needs_rng:
                ins.append(_random.node_generator(
                    ins[0].device if ins else
                    _first_device(arg_arrays, aux_arrays), seed, ni))
            with record_function(scope_names[ni]):
                if call is not None:
                    outs = call(*ins)
                else:
                    outs = op.fn(attrs, *ins)
            if not isinstance(outs, (tuple, list)):
                outs = (outs,)
            for i, o in enumerate(outs):
                env[_entry_key(node, i)] = o
            for in_idx, out_idx in op.mutate_inputs.items():
                if in_idx < len(node.inputs):
                    src, _ = node.inputs[in_idx]
                    if src.is_variable() and src.name in aux_index:
                        new_aux[aux_index[src.name]] = \
                            outs[out_idx].detach()
            if observe is not None:
                observe(node, outs)
            return outs

        return exec_node

    def make_runner(self, node_device=None, observe=None):
        """``run(arg_tensors, aux_tensors, seed, is_train) -> (outputs,
        new_aux)``, both tuples of tensors: every node of the topological
        order through :meth:`make_node_exec` with the same hooks. A run
        with hooks is the plain run's ops in the same order with the same
        draws."""
        exec_node = self.make_node_exec(node_device, observe)
        outputs = self.outputs
        n_nodes = len(self.topo)
        n_aux = len(self.aux_names)

        def run(arg_arrays, aux_arrays, seed, is_train):
            env, new_aux = {}, {}
            for ni in range(n_nodes):
                exec_node(env, new_aux, ni, arg_arrays, aux_arrays, seed,
                          is_train)
            out_arrays = tuple(env[_entry_key(n, i)] for n, i in outputs)
            aux_out = tuple(new_aux.get(i, aux_arrays[i]) for i in range(n_aux))
            return out_arrays, aux_out

        return run


def _first_device(arg_arrays, aux_arrays):
    for t in tuple(arg_arrays) + tuple(aux_arrays):
        return t.device
    return None


class _Found(Exception):
    """Ends the bisect's replay at the first non-finite value."""

    def __init__(self, name, index):
        super().__init__(name, index)
        self.where = (name, index)


class Executor:
    """A symbol bound to argument, gradient and aux arrays."""

    def __init__(self, symbol, ctx, args, args_grad=None, grad_req='write',
                 aux_states=None, group2ctx=None):
        self._symbol = symbol
        self._ctx = ctx if isinstance(ctx, Context) else Context(ctx)
        self._prog = _GraphProgram(symbol)
        self.arg_arrays = self._canon_args(args, self._prog.arg_names, 'args')
        self.aux_arrays = self._canon_args(aux_states or [],
                                           self._prog.aux_names, 'aux_states')
        self.arg_dict = dict(zip(self._prog.arg_names, self.arg_arrays))
        self.aux_dict = dict(zip(self._prog.aux_names, self.aux_arrays))
        if isinstance(grad_req, str):
            self._grad_req = {n: grad_req for n in self._prog.arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self._grad_req = dict(zip(self._prog.arg_names, grad_req))
        else:
            self._grad_req = {n: grad_req.get(n, 'null')
                              for n in self._prog.arg_names}
        if args_grad is None:
            self.grad_arrays = [None] * len(self.arg_arrays)
        else:
            self.grad_arrays = self._canon_args(
                args_grad, self._prog.arg_names, 'args_grad',
                allow_missing=True)
        self.grad_dict = dict(zip(self._prog.arg_names, self.grad_arrays))
        self._grad_names = [n for n in self._prog.arg_names
                            if self._grad_req.get(n, 'null') != 'null'
                            and self.grad_dict.get(n) is not None]
        self._grad_idx = [self._prog.arg_names.index(n)
                          for n in self._grad_names]
        self._group2ctx = dict(group2ctx) if group2ctx else None
        self._monitor = None
        self._observing = False     # a forward's monitor window is open
        self._run = self._make_run()
        self.outputs_cached = None
        self._pending = None    # (outputs, wrt) of a training forward
        self._partial = None    # partial_forward's stepping state

    def _canon_args(self, args, names, what, allow_missing=False):
        if isinstance(args, dict):
            out = []
            for n in names:
                if n in args:
                    out.append(args[n])
                elif allow_missing:
                    out.append(None)
                else:
                    raise MXNetError('missing %s: %s' % (what, n))
            return out
        args = list(args)
        if len(args) != len(names):
            raise MXNetError('length of %s (%d) != expected (%d: %s)'
                             % (what, len(args), len(names), names))
        return args

    # -- forward ----------------------------------------------------------
    def _run_graph(self, is_train, record):
        """Run the graph; with ``record``, the arguments to differentiate
        are fresh leaves, and the graph is kept for the backward."""
        args = [a._data.detach() for a in self.arg_arrays]
        wrt = []                # None for an argument that takes no gradient
        if record:
            for i in self._grad_idx:
                if args[i].is_floating_point():
                    args[i] = args[i].requires_grad_()
                    wrt.append(args[i])
                else:           # integer labels: a zero gradient
                    wrt.append(None)
        aux = tuple(a._data for a in self.aux_arrays)
        seed = _random.next_seed()
        # the monitor sees this forward only, not mirror's recompute of it
        # in the backward
        self._observing = True
        try:
            with torch.set_grad_enabled(record):
                outs, new_aux = mirror_wrap(self._run)(tuple(args), aux, seed,
                                                       bool(is_train))
        finally:
            self._observing = False
        if is_train:
            self._write_aux(new_aux)
        self.outputs_cached = self._wrap_outputs(outs)
        return outs, wrt

    def _write_aux(self, new_aux):
        for a, v in zip(self.aux_arrays, new_aux):
            a._data = v.to(a._data.device)

    def _wrap_outputs(self, outs):
        """The outputs as NDArrays, each in its node's context: its group's
        under group2ctx, else the executor's."""
        return [NDArray(o.detach(), self._node_ctx(n))
                for o, (n, _) in zip(outs, self._prog.outputs)]

    def _node_ctx(self, node):
        grp = node.attr_dict.get('ctx_group') if self._group2ctx else None
        return self._group2ctx.get(grp, self._ctx) if grp else self._ctx

    def forward(self, is_train=False, **kwargs):
        """Run the graph; ``kwargs`` write argument values first. A training
        forward of an executor with gradients keeps its graph for the
        backward."""
        with _tele.span('executor.forward', 'executor'):
            return self._forward_impl(is_train, **kwargs)

    def _forward_impl(self, is_train, **kwargs):
        for k, v in kwargs.items():
            if k in self.arg_dict:
                if isinstance(v, NDArray):
                    self.arg_dict[k]._data = v._data
                else:
                    self.arg_dict[k]._data = torch.as_tensor(v).to(
                        self._ctx.torch_device())
        self._partial = None    # a full forward ends a stepping pass
        record = bool(is_train) and bool(self._grad_names)
        outs, wrt = self._run_graph(is_train, record)
        self._pending = (outs, wrt) if record else None
        return self.outputs_cached

    @property
    def outputs(self):
        if self.outputs_cached is None:
            self.forward(False)
        return self.outputs_cached

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    # -- backward ---------------------------------------------------------
    def backward(self, out_grads=None, is_train=True):
        """Gradients of the outputs (by ``out_grads``, ones by default) into
        the gradient arrays, by each argument's ``grad_req``."""
        with _tele.span('executor.backward', 'executor'):
            self._backward_impl(out_grads, is_train)

    def _backward_impl(self, out_grads, is_train):
        if not self._grad_names:
            return
        if _faults.enabled():
            # the dispatch-exception seam: the per-batch loop's backward is
            # about to train one step
            _faults.maybe_raise('executor')
        if self._pending is None:
            self._pending = self._run_graph(is_train, True)
        outs, wrt = self._pending
        self._pending = None
        if out_grads is None:
            heads = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            if len(out_grads) != len(outs):
                raise ValueError('backward got %d head gradients for %d '
                                 'outputs' % (len(out_grads), len(outs)))
            heads = [(g._data if isinstance(g, NDArray)
                      else torch.as_tensor(g)).to(o.device, o.dtype)
                     for g, o in zip(out_grads, outs)]
        pairs = [(o, h) for o, h in zip(outs, heads) if o.requires_grad]
        leaves = [w for w in wrt if w is not None]
        grads = iter(torch.autograd.grad(
            [o for o, _ in pairs], leaves, [h for _, h in pairs],
            allow_unused=True) if pairs and leaves else [None] * len(leaves))
        health_on = _tele.health.enabled()
        dyn_on = _tele.dynamics.enabled()
        step_grads = []
        for name, w in zip(self._grad_names, wrt):
            dst = self.grad_dict[name]
            g = next(grads) if w is not None else None
            if g is None:
                g = torch.zeros_like(dst._data)
            g = g.to(dst._data.device, dst._data.dtype)
            step_grads.append(g)
            if self._grad_req[name] == 'add':
                dst._data = dst._data + g
            else:
                dst._data = g
        if health_on or dyn_on:
            self._check_step(outs, step_grads, health_on, dyn_on)

    def _check_step(self, outs, grads, health_on, dyn_on):
        """The sentinels of one per-batch step: the vectors are computed on
        the device from this backward's gradients and the weights it ran
        with, then copied to the host and checked (the per-batch loop's one
        added sync; it synchronises a batch for its metric anyway). On a
        non-finite flag the offending batch is still bound, so the bisect
        replays it directly."""
        params = [self.arg_dict[n]._data for n in self._grad_names]
        outs = [o.detach() for o in outs]
        if health_on:
            _tele.health.note_step(
                _tele.health.step_stats(outs, grads=grads, params=params),
                source='executor', bisect=self.first_nonfinite_node)
        if dyn_on:
            _tele.dynamics.note_step(
                _tele.dynamics.step_stats(outs, grads, params),
                self._grad_names, self._symbol.list_outputs())

    # -- the staged per-node path: group2ctx, monitor, stepping, bisect ---
    def _use_staged(self):
        """Whether a run of this executor goes beyond the plain graph: a
        group2ctx placement, a monitor or a host op. The fused windows
        decline such an executor, as in the JAX package."""
        return (self._group2ctx is not None or self._monitor is not None
                or self._prog.has_host_ops)

    def _node_device(self, node):
        return self._node_ctx(node).torch_device()

    def _observe(self, node, values):
        """The monitor's hook: ``<node>_output`` (``<node>_output<i>`` for
        a node of several visible outputs) and a detached NDArray of each
        value, for op nodes of a forward."""
        if not self._observing or node.is_variable():
            return
        nvis = node.opdef().n_visible_outputs(node.attrs)
        for i in range(nvis):
            v = values[i].detach()
            self._monitor('%s_output' % node.name if nvis == 1 else
                          '%s_output%d' % (node.name, i),
                          NDArray(v, self._node_ctx(node)))

    def _hooks(self):
        node_device = self._node_device if self._group2ctx else None
        observe = self._observe if self._monitor is not None else None
        return node_device, observe

    def _make_run(self):
        return self._prog.make_runner(*self._hooks())

    def set_monitor_callback(self, callback, monitor_all=False):
        """Call ``callback(name, NDArray)`` for each op output of every
        forward (the reference's ExecuteMonCallback); None removes it.
        ``monitor_all`` (inputs too, in later MXNet) is accepted and, as in
        the JAX package, changes nothing."""
        self._monitor = callback
        self._run = self._make_run()

    def partial_forward(self, is_train, step):
        """Run one op node a call (the reference's PartialForward): call
        from step 0 and count up until the return value, the steps left,
        is 0. The values stay in an env between calls; variables are read
        when a pass starts. A call at another step than the next restarts
        the pass and replays up to it; a step out of range does nothing
        and returns 0. The last step writes the outputs (and, in training,
        the aux states)."""
        prog = self._prog
        n_steps = len(prog.op_nodes)
        step = int(step)
        if n_steps == 0:
            self.outputs_cached = self._wrap_outputs(
                [self.arg_dict[n.name]._data if n.name in self.arg_dict
                 else self.aux_dict[n.name]._data for n, _ in prog.outputs])
            return 0
        if step < 0 or step >= n_steps:
            return 0
        st = self._partial
        if st is None or st['next'] != step:
            st = self._partial = {
                'env': {}, 'new_aux': {}, 'next': 0, 'pos': 0,
                'seed': _random.next_seed(),
                'args': tuple(a._data.detach() for a in self.arg_arrays),
                'aux': tuple(a._data for a in self.aux_arrays),
                'exec': prog.make_node_exec(*self._hooks())}
            lo = 0
        else:
            lo = step
        self._observing = True
        try:
            with torch.no_grad():
                for k in range(lo, step + 1):
                    target = prog.topo_index[prog.op_nodes[k]]
                    while st['pos'] <= target:
                        st['exec'](st['env'], st['new_aux'], st['pos'],
                                   st['args'], st['aux'], st['seed'],
                                   bool(is_train))
                        st['pos'] += 1
        finally:
            self._observing = False
        st['next'] = step + 1
        left = n_steps - step - 1
        if left == 0:
            self._pending = None
            self.outputs_cached = self._wrap_outputs(
                [st['env'][_entry_key(n, i)] for n, i in prog.outputs])
            if is_train:
                self._write_aux([st['new_aux'].get(i, a._data) for i, a
                                 in enumerate(self.aux_arrays)])
            self._partial = None
        return left

    def first_nonfinite_node(self, overrides=None, is_train=True):
        """Replay the graph node by node and return the first symbol whose
        value holds a NaN or an Inf, as ``(name, output_index)``, or None.
        Variables are checked too, so a poisoned weight or input is named
        itself. ``overrides`` maps variable names to values (NDArrays,
        tensors or numpy) that replace the bound ones for the replay. The
        monitor is not called; nothing is written back."""
        from .telemetry.health import has_nonfinite
        prog = self._prog
        overrides = overrides or {}

        def value(name, arr):
            if name not in overrides:
                return arr._data.detach()
            v = overrides[name]
            v = v._data if isinstance(v, NDArray) else torch.as_tensor(v)
            return v.to(arr._data.device)

        def check(node, values):
            for i, v in enumerate(values):
                if has_nonfinite(v):
                    raise _Found(node.name, i)

        node_device = self._node_device if self._group2ctx else None
        run = prog.make_runner(node_device, check)
        args = tuple(value(n, a) for n, a in zip(prog.arg_names,
                                                 self.arg_arrays))
        aux = tuple(value(n, a) for n, a in zip(prog.aux_names,
                                                self.aux_arrays))
        try:
            with torch.no_grad():
                run(args, aux, _random.next_seed(), bool(is_train))
        except _Found as found:
            return found.where
        return None

    # -- misc API ---------------------------------------------------------
    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        self._partial = None    # a parameter write ends a stepping pass
        dev = self._ctx.torch_device()
        for name, arr in arg_params.items():
            if name in self.arg_dict:
                dst = self.arg_dict[name]
                dst._data = arr._data.detach().to(dev, dst._data.dtype)
            elif not allow_extra_params:
                raise ValueError('Found name "%s" that is not in the '
                                 'arguments' % name)
        for name, arr in (aux_params or {}).items():
            if name in self.aux_dict:
                dst = self.aux_dict[name]
                dst._data = arr._data.detach().to(dev, dst._data.dtype)
            elif not allow_extra_params:
                raise ValueError('Found name "%s" that is not in the '
                                 'auxiliary states' % name)

    def reshape(self, partial_shaping=False, allow_up_sizing=False, **kwargs):
        """A new executor for new input shapes: arrays whose shape did not
        change are shared, the others are new zeros."""
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)
        new_args = {}
        for name, sh in zip(self._prog.arg_names, arg_shapes):
            cur = self.arg_dict[name]
            new_args[name] = cur if tuple(cur.shape) == tuple(sh) else \
                nd_zeros(sh, ctx=self._ctx, dtype=cur.dtype)
        new_aux = {}
        for name, sh in zip(self._prog.aux_names, aux_shapes):
            cur = self.aux_dict[name]
            new_aux[name] = cur if tuple(cur.shape) == tuple(sh) else \
                nd_zeros(sh, ctx=self._ctx, dtype=cur.dtype)
        grads = None
        if any(g is not None for g in self.grad_arrays):
            grads = {n: nd_zeros(new_args[n].shape, ctx=self._ctx,
                                 dtype=new_args[n].dtype)
                     for n in self._grad_names}
        return Executor(self._symbol, self._ctx, new_args, grads,
                        self._grad_req, new_aux, group2ctx=self._group2ctx)


def simple_bind(symbol, ctx, grad_req='write', type_dict=None, group2ctx=None,
                shared_exec=None, **kwargs):
    """Infer the shapes and types from ``kwargs`` and ``type_dict``, then
    bind zeros of them on ``ctx``."""
    arg_shapes, _, aux_shapes = symbol.infer_shape(**kwargs)
    if arg_shapes is None:
        raise MXNetError('cannot infer shapes')
    type_dict = type_dict or {}
    arg_names = symbol.list_arguments()
    aux_names = symbol.list_auxiliary_states()
    arg_types, _, aux_types = symbol.infer_type(**type_dict)
    args = {name: nd_zeros(sh, ctx=ctx, dtype=np_dtype(type_dict.get(name, it)))
            for name, sh, it in zip(arg_names, arg_shapes, arg_types)}
    aux = {name: nd_zeros(sh, ctx=ctx, dtype=np_dtype(it))
           for name, sh, it in zip(aux_names, aux_shapes, aux_types)}
    grads = None
    if isinstance(grad_req, str):
        req_of = lambda n: grad_req                          # noqa: E731
    elif isinstance(grad_req, (list, tuple)):
        req_of = lambda n: grad_req[arg_names.index(n)]      # noqa: E731
    else:
        req_of = lambda n: grad_req.get(n, 'null')           # noqa: E731
    if grad_req != 'null':
        grads = {name: nd_zeros(sh, ctx=ctx, dtype=args[name].dtype)
                 for name, sh in zip(arg_names, arg_shapes)
                 if req_of(name) != 'null'}
    return Executor(symbol, ctx, args, grads, grad_req, aux,
                    group2ctx=group2ctx)
