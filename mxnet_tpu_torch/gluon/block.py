"""Gluon Block and HybridBlock: the counterpart of
``mxnet_tpu/gluon/block.py`` (Block with its name and parameter scopes,
HybridBlock with its imperative forward, ``hybridize`` through
``_get_graph`` (hybrid_forward traced with Symbol proxies),
``_build_cache`` and ``_call_cached_op``, ``infer_shape`` and deferred
initialisation, and SymbolBlock).

A hybridized block runs its traced graph through the executor's runner
(:class:`..executor._GraphProgram`) as one call, under
:func:`..executor.mirror_wrap`. Where the JAX package jits the graph and
records one ``jax.vjp`` of it on its tape, the port runs the graph's ops
eagerly with grad enabled while recording, so torch's graph of the call
connects the block's inputs and parameters to its outputs;
``loss.backward()`` runs back through it.
"""
import copy
import threading

import torch

from .. import autograd
from .. import ndarray as nd
from ..attribute import NameManager, Prefix
from ..context import current_context
from ..executor import _GraphProgram, mirror_wrap
from ..ndarray import NDArray
from .parameter import Parameter, ParameterDict, DeferredInitializationError

__all__ = ['Block', 'HybridBlock', 'SymbolBlock']


class _BlockScope:
    """Name and parameter scoping of a Block's children."""
    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None
        self._name_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, 'value', None)
        if current is None:
            if prefix is None:
                prefix = NameManager.current().get(None, hint) + '_'
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = '%s%d_' % (hint, count)
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        self._old_scope = getattr(_BlockScope._current, 'value', None)
        _BlockScope._current.value = self
        self._name_scope = Prefix(self._block.prefix)
        self._name_scope.__enter__()
        return self

    def __exit__(self, ptype, value, trace):
        self._name_scope.__exit__(ptype, value, trace)
        self._name_scope = None
        _BlockScope._current.value = self._old_scope


def _flatten(args):
    if isinstance(args, NDArray):
        return [args], int(0)
    if isinstance(args, (list, tuple)):
        flat, fmts = [], []
        for i in args:
            arg, fmt = _flatten(i)
            flat.extend(arg)
            fmts.append(fmt)
        return flat, fmts
    return [args], None


def _regroup(args, fmt):
    if isinstance(fmt, int):
        if fmt == 0:
            return args[0], args[1:]
        return args[:fmt], args[fmt:]
    if fmt is None:
        return args[0], args[1:]
    ret = []
    for i in fmt:
        res, args = _regroup(args, i)
        ret.append(res)
    return ret, args


class Block:
    """Base building block."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ''
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith('_') \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = []

    def __repr__(self):
        s = '{name}(\n{modstr}\n)'
        modstr = '\n'.join(['  ({key}): {block}'.format(
            key=key, block=_indent(str(block), 2))
            for key, block in self.__dict__.items()
            if isinstance(block, Block)])
        return s.format(name=self.__class__.__name__, modstr=modstr)

    def __setattr__(self, name, value):
        if isinstance(value, Block):
            self.register_child(value)
        super().__setattr__(name, value)

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    def collect_params(self):
        """This block's and all its children's parameters."""
        ret = ParameterDict(self._params.prefix)
        ret.update(self.params)
        for cld in self._children:
            ret.update(cld.collect_params())
        return ret

    def save_params(self, filename):
        """The parameters into ``filename``, named without this block's
        prefix."""
        strip_prefix = self.prefix if self._prefix.endswith('_') else ''
        self.collect_params().save(filename, strip_prefix=strip_prefix)

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False):
        """The parameters from ``filename`` (written by ``save_params``),
        on ``ctx`` (the current context by default)."""
        restore_prefix = self.prefix if self._prefix.endswith('_') else ''
        self.collect_params().load(filename, ctx or current_context(),
                                   allow_missing, ignore_extra,
                                   restore_prefix=restore_prefix)

    def register_child(self, block):
        self._children.append(block)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        from ..initializer import Uniform
        self.collect_params().initialize(init or Uniform(), ctx, verbose,
                                         force_reinit)

    def hybridize(self, active=True):
        for cld in self._children:
            cld.hybridize(active)

    def cast(self, dtype):
        for child in self._children:
            child.cast(dtype)
        for _, param in self.params.items():
            param.cast(dtype)

    def __call__(self, *args):
        return self.forward(*args)

    def forward(self, *args):
        raise NotImplementedError()


class HybridBlock(Block):
    """A Block that runs imperatively or, hybridized, as its traced
    graph."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._reg_params = {}
        self._cached_graph = ()
        self._cached_op = None
        self._active = False

    def __setattr__(self, name, value):
        super().__setattr__(name, value)
        if isinstance(value, Parameter):
            assert name not in self._reg_params or \
                not isinstance(self._reg_params[name], Parameter), \
                'Overriding Parameter attribute %s is not allowed. ' \
                'Please pass in Parameters by specifying `params` at ' \
                'Block construction instead.'
            self._reg_params[name] = value

    def register_child(self, block):
        if not isinstance(block, HybridBlock):
            raise ValueError(
                'Children of HybridBlock must also be HybridBlock, '
                'but %s has type %s.' % (str(block), str(type(block))))
        super().register_child(block)
        self._clear_cached_op()

    def hybridize(self, active=True):
        self._active = active
        self._clear_cached_op()
        super().hybridize(active)

    def cast(self, dtype):
        self._clear_cached_op()
        super().cast(dtype)

    def _clear_cached_op(self):
        self._cached_graph = ()
        self._cached_op = None

    def _get_graph(self, *args):
        """Trace hybrid_forward with Symbol proxies (once; cached)."""
        if not self._cached_graph:
            from .. import symbol
            args, self._in_format = _flatten(args)
            if len(args) > 1:
                inputs = [symbol.var('data%d' % i) for i in range(len(args))]
            else:
                inputs = [symbol.var('data')]
            grouped_inputs = _regroup(inputs, self._in_format)[0]
            params = {i: j.var() for i, j in self._reg_params.items()}
            with self.name_scope():
                out = self.hybrid_forward(
                    symbol,
                    *(grouped_inputs if isinstance(grouped_inputs, (list, tuple))
                      else (grouped_inputs,)), **params)
            out, self._out_format = _flatten(out)
            self._cached_graph = inputs, symbol.Group(out)
        return self._cached_graph

    def infer_shape(self, *args):
        """Infer missing parameter shapes from the inputs'."""
        inputs, out = self._get_graph(*args)
        args, _ = _flatten(args)
        arg_shapes, _, aux_shapes = out.infer_shape_partial(
            **{i.name: j.shape for i, j in zip(inputs, args)})
        sdict = {i: j for i, j in zip(out.list_arguments(), arg_shapes)}
        sdict.update({name: shape for name, shape in
                      zip(out.list_auxiliary_states(), aux_shapes)})
        for _, v in self.collect_params().items():
            if v.name in sdict and sdict[v.name] is not None:
                v.shape = sdict[v.name]

    def _build_cache(self, *args):
        """The traced graph's runner, and where each of its arguments and
        aux states comes from."""
        inputs, out = self._get_graph(*args)
        self._cached_prog = _GraphProgram(out)
        self._cached_fn = self._cached_prog.make_runner()
        data_map = {inp.name: i for i, inp in enumerate(inputs)}
        params = {p.name: p for _, p in self.collect_params().items()}
        self._cached_arg_sources = [
            ('data', data_map[name]) if name in data_map
            else ('param', params[name])
            for name in self._cached_prog.arg_names]
        self._cached_aux_sources = [params[name] for name in
                                    self._cached_prog.aux_names]
        self._cached_op = True

    def _call_cached_op(self, *args):
        """Run the traced graph as one call: recorded while recording, the
        new aux states (BatchNorm's moving statistics) written back."""
        if self._cached_op is None:
            self._build_cache(*args)
        args_flat, fmt = _flatten(args)
        ctx = args_flat[0].context if args_flat else current_context()
        arg_t = tuple(args_flat[src]._data if kind == 'data'
                      else src.data(ctx)._data
                      for kind, src in self._cached_arg_sources)
        aux_nds = [p.data(ctx) for p in self._cached_aux_sources]
        aux_t = tuple(a._data for a in aux_nds)
        from .. import random as _random
        seed = _random.next_seed()
        with torch.set_grad_enabled(autograd.is_recording()):
            outs, new_aux = mirror_wrap(self._cached_fn)(
                arg_t, aux_t, seed, autograd.is_training())
        for a, v in zip(aux_nds, new_aux):
            a._data = v
        outputs = [NDArray(o, ctx) for o in outs]
        ret, _ = _regroup(outputs, self._out_format)
        return ret

    def forward(self, x, *args):
        """Imperative (``hybrid_forward`` with ``F`` = nd), the cached graph
        when hybridized, or composition when ``x`` is a Symbol."""
        if isinstance(x, NDArray):
            with x.context:
                if self._active:
                    try:
                        return self._call_cached_op(x, *args)
                    except DeferredInitializationError:
                        self._deferred_infer_init(x, *args)
                        return self._call_cached_op(x, *args)
                try:
                    params = {i: j.data(x.context)
                              for i, j in self._reg_params.items()}
                except DeferredInitializationError:
                    self._deferred_infer_init(x, *args)
                    params = {i: j.data(x.context)
                              for i, j in self._reg_params.items()}
                return self.hybrid_forward(nd, x, *args, **params)
        from .. import symbol
        assert isinstance(x, symbol.Symbol), \
            'HybridBlock requires the first argument to forward be either ' \
            'Symbol or NDArray, but got %s' % type(x)
        params = {i: j.var() for i, j in self._reg_params.items()}
        with self.name_scope():
            return self.hybrid_forward(symbol, x, *args, **params)

    def _deferred_infer_init(self, *args):
        self.infer_shape(*args)
        for _, i in self.collect_params().items():
            i._finish_deferred_init()

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError()


class SymbolBlock(HybridBlock):
    """A Symbol as a Block: its arguments other than the inputs become
    parameters, its aux states parameters without gradient."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix=None, params=params)
        from .. import symbol
        self._prefix = ''
        self._params = ParameterDict('', params)
        if isinstance(inputs, symbol.Symbol) and len(inputs.list_outputs()) == 1:
            inputs = [inputs]
        if isinstance(outputs, (list, tuple)) and len(outputs) == 1:
            outputs = outputs[0]
        if isinstance(outputs, (list, tuple)):
            outputs = symbol.Group(outputs)
        syms, self._in_format = _flatten(inputs)
        out, self._out_format = _flatten(outputs)
        out = symbol.Group(out)

        input_names = {i.name for i in syms}
        for i in out.list_arguments():
            if i not in input_names:
                self.params.get(i, allow_deferred_init=True)
        for i in out.list_auxiliary_states():
            self.params.get(i, grad_req='null', allow_deferred_init=True)

        self._cached_graph = syms, out

    def forward(self, x, *args):
        if isinstance(x, NDArray):
            with x.context:
                try:
                    return self._call_cached_op(x, *args)
                except DeferredInitializationError:
                    self.infer_shape(x, *args)
                    for _, i in self.params.items():
                        i._finish_deferred_init()
                    return self._call_cached_op(x, *args)
        from .. import symbol
        assert isinstance(x, symbol.Symbol)
        ret = copy.copy(self._cached_graph[1])
        ret._compose(**{self._cached_graph[0][0].name: x})
        return _regroup(list(ret), self._out_format)[0]

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError()


def _indent(s_, num_spaces):
    s = str(s_).split('\n')
    if len(s) == 1:
        return s_
    first = s.pop(0)
    return first + '\n' + '\n'.join(' ' * num_spaces + line for line in s)
