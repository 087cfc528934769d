"""Symbol, the lazy graph IR: the counterpart of
``mxnet_tpu/symbol/symbol.py`` (compose, the list_* methods,
``get_internals``, attrs, the operator dunders, ``tojson``/``load_json`` in
the reference's node-list schema, ``bind``/``simple_bind``/``eval``).

The graph is a pure-Python DAG of op nodes over the port's registry; a
bound symbol runs through :mod:`..executor`. Not ported: the Custom op's
compose (no Custom op is registered in the port).
"""
import json

import numpy as np

from ..attribute import AttrScope, NameManager
from ..base import MXNetError, normalize_attrs
from ..ops import registry as _reg

__all__ = ['Symbol', 'Variable', 'var', 'Group', 'load', 'load_json']


class Node:
    """One graph node: a variable (op=None) or an op application."""
    __slots__ = ('op', 'attrs', 'inputs', 'name', 'attr_dict', '_num_args')

    def __init__(self, op, attrs, inputs, name, attr_dict=None, num_args=None):
        self.op = op            # str op name or None for variables
        self.attrs = attrs      # normalized op attrs
        self.inputs = inputs    # list[(Node, int)]
        self.name = name
        self.attr_dict = attr_dict or {}  # user attrs (ctx_group, lr_mult…)
        self._num_args = num_args

    def is_variable(self):
        return self.op is None

    def opdef(self):
        return _reg.get(self.op)


class Symbol:
    """A list of output entries over the shared graph."""

    def __init__(self, outputs):
        self._outputs = list(outputs)  # list[(Node, int)]

    # -- identity / composition ------------------------------------------
    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def __repr__(self):
        return '<Symbol %s>' % (self.name or 'Grouped')

    def __iter__(self):
        return (Symbol([o]) for o in self._outputs)

    def __len__(self):
        return len(self._outputs)

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise ValueError('cannot find output %s' % index)
            index = names.index(index)
        return Symbol([self._outputs[index]])

    def __call__(self, *args, **kwargs):
        """Compose: replace variable placeholders (reference symbol.py:391)."""
        s = self.__copy__()
        s._compose(*args, **kwargs)
        return s

    def __copy__(self):
        return Symbol(list(self._outputs))

    def _compose(self, *args, **kwargs):
        kwargs = {k: v for k, v in kwargs.items() if isinstance(v, Symbol)}
        name_map = {}
        for k, v in kwargs.items():
            name_map[k] = v._outputs[0]
        arg_syms = [a for a in args if isinstance(a, Symbol)]
        free = [n for n in self._topo() if n.is_variable()]
        pos = 0
        replace = {}
        for n in free:
            if n.name in name_map:
                replace[n] = name_map[n.name]
            elif pos < len(arg_syms):
                replace[n] = arg_syms[pos]._outputs[0]
                pos += 1
        if replace:
            self._outputs = [_rewrite(e, replace, {}) for e in self._outputs]

    # -- graph walks ------------------------------------------------------
    def _topo(self):
        order, seen = [], set()
        stack = [(n, False) for n, _ in reversed(self._outputs)]
        while stack:
            node, done = stack.pop()
            if done:
                order.append(node)
                continue
            if id(node) in seen:
                continue
            seen.add(id(node))
            stack.append((node, True))
            for p, _ in reversed(node.inputs):
                if id(p) not in seen:
                    stack.append((p, False))
        return order

    def list_arguments(self):
        """Free variables in DFS order, aux excluded (reference symbol.py:820)."""
        args = []
        aux = set(self._aux_nodes())
        for n in self._topo():
            if n.is_variable() and id(n) not in aux:
                args.append(n.name)
        return args

    def list_auxiliary_states(self):
        """Reference symbol.py:860 — aux states (BatchNorm moving stats…)."""
        aux_ids = self._aux_nodes()
        out, emitted = [], set()
        for n in self._topo():
            if n.is_variable() and id(n) in aux_ids and id(n) not in emitted:
                emitted.add(id(n))
                out.append(n.name)
        return out

    def _aux_nodes(self):
        aux = set()
        for n in self._topo():
            if n.is_variable():
                continue
            op = n.opdef()
            if op.aux_inputs:
                names = op.input_names
                for i, (p, _) in enumerate(n.inputs):
                    if i < len(names) and names[i] in op.aux_inputs and p.is_variable():
                        aux.add(id(p))
        return aux

    def list_outputs(self):
        out = []
        for node, idx in self._outputs:
            if node.is_variable():
                out.append(node.name)
            else:
                op = node.opdef()
                nvis = op.n_visible_outputs(node.attrs)
                if nvis == 1:
                    out.append(node.name + '_output')
                else:
                    out.append('%s_output%d' % (node.name, idx))
        return out

    def list_inputs(self):
        return [n.name for n in self._topo() if n.is_variable()]

    def get_internals(self):
        """Reference symbol.py:584: every node's outputs as a grouped symbol."""
        entries = []
        for n in self._topo():
            if n.is_variable():
                entries.append((n, 0))
            else:
                for i in range(n.opdef().n_visible_outputs(n.attrs)):
                    entries.append((n, i))
        return Symbol(entries)

    def get_children(self):
        kids = []
        for node, _ in self._outputs:
            kids.extend(node.inputs)
        return Symbol(kids) if kids else None

    # -- attrs ------------------------------------------------------------
    def attr(self, key):
        if len(self._outputs) == 1:
            return self._outputs[0][0].attr_dict.get(key, None)
        return None

    def attr_dict(self):
        out = {}
        for n in self._topo():
            if n.attr_dict:
                out[n.name] = dict(n.attr_dict)
        return out

    def _set_attr(self, **kwargs):
        for n, _ in self._outputs:
            n.attr_dict.update(kwargs)

    # -- arithmetic sugar (reference symbol.py __add__ etc.) ---------------
    def __add__(self, other):
        return _sym_binary(self, other, 'broadcast_add' if isinstance(other, Symbol) else '_plus_scalar', 'elemwise_add')

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        return _sym_binary(self, other, 'broadcast_sub' if isinstance(other, Symbol) else '_minus_scalar', 'elemwise_sub')

    def __rsub__(self, other):
        return _sym_scalar(self, other, '_rminus_scalar')

    def __mul__(self, other):
        return _sym_binary(self, other, 'broadcast_mul' if isinstance(other, Symbol) else '_mul_scalar', 'elemwise_mul')

    def __rmul__(self, other):
        return self.__mul__(other)

    def __truediv__(self, other):
        return _sym_binary(self, other, 'broadcast_div' if isinstance(other, Symbol) else '_div_scalar', 'elemwise_div')

    def __rtruediv__(self, other):
        return _sym_scalar(self, other, '_rdiv_scalar')

    def __pow__(self, other):
        return _sym_binary(self, other, 'broadcast_power' if isinstance(other, Symbol) else '_power_scalar', None)

    def __neg__(self):
        return create('negative', [self], {})

    def __eq__(self, other):
        return _sym_binary(self, other, 'broadcast_equal' if isinstance(other, Symbol) else '_equal_scalar', None)

    def __ne__(self, other):
        return _sym_binary(self, other, 'broadcast_not_equal' if isinstance(other, Symbol) else '_not_equal_scalar', None)

    def __gt__(self, other):
        return _sym_binary(self, other, 'broadcast_greater' if isinstance(other, Symbol) else '_greater_scalar', None)

    def __ge__(self, other):
        return _sym_binary(self, other, 'broadcast_greater_equal' if isinstance(other, Symbol) else '_greater_equal_scalar', None)

    def __lt__(self, other):
        return _sym_binary(self, other, 'broadcast_lesser' if isinstance(other, Symbol) else '_lesser_scalar', None)

    def __le__(self, other):
        return _sym_binary(self, other, 'broadcast_lesser_equal' if isinstance(other, Symbol) else '_lesser_equal_scalar', None)

    def __hash__(self):
        return id(self)

    # -- shape/type inference ---------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """Returns (arg_shapes, out_shapes, aux_shapes). Parameter shapes
        come from per-op hooks on the data's shape (symbol/infer.py), the
        rest from running each op on meta tensors."""
        try:
            return self._infer_shape_impl(False, *args, **kwargs)
        except MXNetError:
            raise
        except Exception as e:
            raise MXNetError('infer_shape error: %s' % e)

    def infer_shape_partial(self, *args, **kwargs):
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        from .infer import infer_shapes
        known = {}
        if args:
            for name, shape in zip(self.list_arguments(), args):
                if shape is not None:
                    known[name] = tuple(shape)
        known.update({k: tuple(v) for k, v in kwargs.items()})
        return infer_shapes(self, known, partial=partial)

    def infer_type(self, *args, **kwargs):
        from .infer import infer_types
        known = {}
        if args:
            for name, t in zip(self.list_arguments(), args):
                if t is not None:
                    known[name] = t
        known.update(kwargs)
        return infer_types(self, known)

    # -- gradient ---------------------------------------------------------
    def gradient(self, wrt):
        raise NotImplementedError('use Executor.backward (torch autograd '
                                  'computes the gradients of a bound graph)')

    # -- serialization (reference symbol.py:1183 tojson) -------------------
    def tojson(self):
        nodes = self._topo()
        nid = {id(n): i for i, n in enumerate(nodes)}
        jnodes, arg_nodes = [], []
        for i, n in enumerate(nodes):
            if n.is_variable():
                arg_nodes.append(i)
                jnodes.append({'op': 'null', 'name': n.name, 'inputs': []})
            else:
                attrs = {k: _attr_to_str(v) for k, v in n.attrs.items()
                         if not k.startswith('__')}
                jnodes.append({
                    'op': n.op, 'name': n.name, 'attrs': attrs,
                    'inputs': [[nid[id(p)], idx, 0] for p, idx in n.inputs]})
            if n.attr_dict:
                jnodes[-1].setdefault('attrs', {}).update(
                    {'__user__' + k: str(v) for k, v in n.attr_dict.items()})
        heads = [[nid[id(n)], idx, 0] for n, idx in self._outputs]
        return json.dumps({'nodes': jnodes, 'arg_nodes': arg_nodes,
                           'node_row_ptr': list(range(len(nodes) + 1)),
                           'heads': heads,
                           'attrs': {'mxnet_version': ['int', 1100]}}, indent=2)

    def save(self, fname):
        with open(fname, 'w') as f:
            f.write(self.tojson())

    # -- executor entry points (impl in executor.py) ----------------------
    def bind(self, ctx, args, args_grad=None, grad_req='write', aux_states=None,
             group2ctx=None, shared_exec=None):
        from ..executor import Executor
        return Executor(self, ctx, args, args_grad, grad_req, aux_states,
                        group2ctx=group2ctx)

    def simple_bind(self, ctx, grad_req='write', type_dict=None,
                    group2ctx=None, shared_exec=None, **kwargs):
        from ..executor import simple_bind
        return simple_bind(self, ctx, grad_req, type_dict, group2ctx,
                           shared_exec, **kwargs)

    def eval(self, ctx=None, **kwargs):
        from ..context import current_context
        ctx = ctx or current_context()
        ex = self.bind(ctx, kwargs)
        return ex.forward()

    # convenience op methods mirroring mx.sym.<op>(self, ...); positional
    # scalars map onto declared params in order, the generated-signature
    # convention (symbol/register.py make_sym_function)
    def _op_method(name):  # noqa: N805
        def method(self, *args, **kwargs):
            inputs = [self] + [a for a in args if isinstance(a, Symbol)]
            pos_attrs = [a for a in args if not isinstance(a, Symbol)]
            if pos_attrs:
                params = list(_reg.get(name).param_defaults)
                if len(pos_attrs) > len(params):
                    raise TypeError(
                        '%s: %d positional argument(s) beyond the '
                        'declared params'
                        % (name, len(pos_attrs) - len(params)))
                # python call semantics: positionals fill params in
                # declaration order; a clash with a kwarg is an error,
                # and None is a real value (axis=None etc.)
                for pname, val in zip(params, pos_attrs):
                    if pname in kwargs:
                        raise TypeError(
                            '%s() got multiple values for argument %r'
                            % (name, pname))
                    kwargs[pname] = val
            return _invoke_sym(name, inputs, kwargs)
        return method

    for _n in ['sum', 'mean', 'max', 'min', 'prod', 'argmax', 'argmin',
               'norm', 'abs', 'sign', 'sqrt', 'square', 'exp', 'log',
               'sigmoid', 'relu', 'tanh', 'softmax', 'log_softmax',
               'transpose', 'expand_dims', 'squeeze', 'clip', 'flatten',
               'sort', 'argsort', 'topk', 'take', 'one_hot', 'pick', 'tile',
               'repeat', 'dot', 'broadcast_axes', 'broadcast_to', 'ceil',
               'fix', 'flip', 'floor', 'nanprod', 'nansum', 'ones_like',
               'pad', 'rint', 'round', 'slice', 'split', 'swapaxes',
               'trunc', 'zeros_like']:
        locals()[_n] = _op_method(_n)
    del _op_method, _n

    def copy(self):
        """Deep graph copy (reference MXSymbolCopy): mutating attrs on
        the copy must not leak into the original. Iterative over the
        topo order — graphs can be deeper than the recursion limit."""
        memo = {}
        for node in self._topo():          # parents precede consumers
            memo[id(node)] = Node(
                node.op, dict(node.attrs),
                [(memo[id(p)], i) for p, i in node.inputs],
                node.name, dict(node.attr_dict), node._num_args)
        return Symbol([(memo[id(n)], i) for n, i in self._outputs])

    def list_attr(self, recursive=False):
        """User attrs of the head node (reference symbol.py:list_attr);
        recursive=True raises like modern reference versions — use
        attr_dict() for the whole graph."""
        if recursive:
            raise DeprecationWarning(
                'list_attr(recursive=True) is deprecated: use attr_dict()')
        if len(self._outputs) == 1:
            return dict(self._outputs[0][0].attr_dict)
        return {}

    def debug_str(self):
        """Human-readable graph dump (reference Symbol::DebugStr)."""
        lines = []
        for n in self._topo():
            if n.is_variable():
                lines.append('Variable:%s' % n.name)
            else:
                ins = ', '.join('%s[%d]' % (p.name, i) for p, i in n.inputs)
                lines.append('Op:%s, Name=%s\nInputs:\n\t%s'
                             % (n.op, n.name, ins))
        return '\n'.join(lines) + '\n'

    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        if 'shape' in kwargs:
            shape = kwargs['shape']
        return _invoke_sym('Reshape', [self], {'shape': tuple(shape)})

    def astype(self, dtype):
        return _invoke_sym('Cast', [self], {'dtype': str(dtype)})

    def slice_axis(self, axis, begin, end):
        return _invoke_sym('slice_axis', [self],
                           {'axis': axis, 'begin': begin, 'end': end})


def _rewrite(entry, replace, memo):
    node, idx = entry
    if node in replace:
        return (replace[node][0], replace[node][1])
    if id(node) in memo:
        return (memo[id(node)], idx)
    if node.is_variable():
        memo[id(node)] = node
        return entry
    new_inputs = [_rewrite(e, replace, memo) for e in node.inputs]
    new_node = Node(node.op, node.attrs, new_inputs, node.name,
                    dict(node.attr_dict), node._num_args)
    memo[id(node)] = new_node
    return (new_node, idx)


def _attr_to_str(v):
    if isinstance(v, bool):
        return 'True' if v else 'False'
    if isinstance(v, tuple):
        return '(' + ', '.join(str(x) for x in v) + ')'
    return str(v)


def _parse_attr(s):
    if not isinstance(s, str):
        return s
    import ast
    low = s.strip()
    if low in ('True', 'true'):
        return True
    if low in ('False', 'false'):
        return False
    if low in ('None',):
        return None
    try:
        return ast.literal_eval(low)
    except (ValueError, SyntaxError):
        return s


# ---------------------------------------------------------------------------
# construction API
# ---------------------------------------------------------------------------

def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, stype=None, **kwargs):
    """Reference symbol.py:2425 mx.sym.Variable."""
    attr_dict = AttrScope.current().get(attr or {})
    if shape is not None:
        attr_dict['__shape__'] = str(tuple(shape))
    if dtype is not None:
        attr_dict['__dtype__'] = str(dtype)
    if lr_mult is not None:
        attr_dict['__lr_mult__'] = str(lr_mult)
    if wd_mult is not None:
        attr_dict['__wd_mult__'] = str(wd_mult)
    if init is not None:
        if isinstance(init, str):
            # resolve string specs so '__init__' always holds the json
            # form Initializer.__call__ expects
            from ..initializer import create as _create_init
            init = _create_init(init)
        attr_dict['__init__'] = init.dumps() if hasattr(init, 'dumps') \
            else str(init)
    node = Node(None, {}, [], name, attr_dict)
    return Symbol([(node, 0)])


var = Variable


def Group(symbols):
    outputs = []
    for s in symbols:
        outputs.extend(s._outputs)
    return Symbol(outputs)


def create(op_name, input_syms, attrs, name=None):
    """Create an op node — the Symbol side of the shared registry."""
    op = _reg.get(op_name)
    attrs = normalize_attrs(attrs)
    name = NameManager.current().get(name, op_name.lstrip('_'))
    inputs = [s._outputs[0] for s in input_syms]
    attr_dict = AttrScope.current().get({})
    node = Node(op_name, attrs, inputs, name, attr_dict,
                num_args=len(inputs) if op.variadic else None)
    nvis = op.n_visible_outputs(attrs)
    return Symbol([(node, i) for i in range(nvis)])


def _invoke_sym(op_name, input_syms, kwargs):
    name = kwargs.pop('name', None)
    kwargs.pop('attr', None)
    op = _reg.get(op_name)
    # separate symbol inputs passed as kwargs
    named = {}
    for k in list(kwargs):
        if isinstance(kwargs[k], Symbol):
            named[k] = kwargs.pop(k)
    inputs = list(input_syms)
    if not op.variadic and named:
        merged = []
        pos_iter = iter(inputs)
        for n in op.input_names:
            if n in named:
                merged.append(named[n])
            else:
                nxt = next(pos_iter, None)
                if nxt is not None:
                    merged.append(nxt)
        inputs = merged
    elif op_name == 'Custom' and 'op_type' in kwargs:
        return _compose_custom(inputs, named, kwargs, name)
    elif op.variadic and named:
        # mixing positional and keyword symbol inputs is ambiguous for
        # variable-length ops: rejected, as the reference does
        if inputs and named:
            raise ValueError(
                'operator %s takes variable-length inputs: pass symbol '
                'inputs either all positionally or all by keyword, not '
                'mixed' % op_name)
        inputs = inputs + list(named.values())
    if op.variadic and op.key_var_num_args and op.key_var_num_args not in kwargs:
        kwargs[op.key_var_num_args] = len(inputs)
    # auto-create missing trailing parameter variables (MXNet creates
    # fc0_weight etc. automatically at compose time)
    if not op.variadic:
        final_name = NameManager.current().get(name, op_name.lstrip('_'))
        # the op's arg-name hook decides (FullyConnected without a bias
        # takes two inputs, LeakyReLU a gamma only as prelu)
        needed = op.arg_names(kwargs)
        while len(inputs) < len(needed):
            pname = needed[len(inputs)]
            inputs.append(Variable('%s_%s' % (final_name, pname)))
        return create(op_name, inputs, kwargs, final_name)
    return create(op_name, inputs, kwargs, name)


def _compose_custom(inputs, named, kwargs, name):
    """A Custom node, its inputs in the order its prop declares (arguments,
    then aux states): positional inputs fill the leading slots, keywords
    their own, and each argument not passed becomes a ``<name>_<arg>``
    Variable (``softmax_label``); aux states are all passed or none. A
    prop that cannot be made composes the inputs as given (its error
    surfaces at bind)."""
    from ..operator import _CUSTOM_OPS, _CUSTOM_RESERVED
    op_type = kwargs['op_type']
    try:
        prop = _CUSTOM_OPS[op_type](**{
            k: v for k, v in kwargs.items()
            if k not in _CUSTOM_RESERVED and k != 'num_args'})
        args_order = list(prop.list_arguments())
        order = args_order + list(prop.list_auxiliary_states())
    except Exception:  # noqa: BLE001 -- the bind reports the prop's error
        if inputs and named:
            raise ValueError(
                'operator Custom takes variable-length inputs: pass symbol '
                'inputs either all positionally or all by keyword, not '
                'mixed')
        inputs = inputs + list(named.values())
        kwargs.setdefault('num_args', len(inputs))
        return create('Custom', inputs, kwargs, name)
    n_args = len(args_order)
    unknown = [k for k in named if k not in order]
    if unknown:
        raise ValueError('unknown keyword input(s) %s for Custom op %r; '
                         'declared inputs are %s' % (unknown, op_type, order))
    if len(inputs) > len(order):
        raise ValueError('Custom op %r takes inputs %s; %d extra positional '
                         'input(s) given' % (op_type, order,
                                             len(inputs) - len(order)))
    final_name = NameManager.current().get(name, 'custom')
    merged = []
    omitted_aux = None
    for idx, n in enumerate(order):
        if idx < len(inputs):
            if n in named:
                raise ValueError('Custom op %r input %r is bound both '
                                 'positionally and by keyword' % (op_type, n))
            merged.append(inputs[idx])
        elif n in named:
            if omitted_aux is not None:
                raise ValueError('Custom op %r: aux input %r passed but '
                                 'earlier aux %r omitted'
                                 % (op_type, n, omitted_aux))
            merged.append(named[n])
        elif idx < n_args:
            merged.append(Variable('%s_%s' % (final_name, n)))
        else:
            omitted_aux = n
    n_aux_given = len(merged) - n_args
    if n_aux_given not in (0, len(order) - n_args):
        raise ValueError('Custom op %r: pass all %d aux states or none (%d '
                         'given)' % (op_type, len(order) - n_args,
                                     n_aux_given))
    kwargs.setdefault('num_args', len(merged))
    return create('Custom', merged, kwargs, final_name)


class NotImplementedForSymbol(MXNetError):
    """An NDArray-only operation called on a Symbol."""


def _not_for_symbol(name):
    def method(self, *args, **kwargs):
        raise NotImplementedForSymbol('%s is an NDArray operation: not '
                                      'supported for Symbol' % name)
    method.__name__ = name
    method.__doc__ = ('NDArray-only operation: not supported for Symbol '
                      '(reference symbol.py raises the same).')
    return method


for _n in ('asnumpy', 'asscalar', 'as_in_context', 'backward', 'detach',
           'wait_to_read'):
    setattr(Symbol, _n, _not_for_symbol(_n))
del _not_for_symbol


def _sym_binary(lhs, rhs, op_name, elem_name):
    if isinstance(rhs, Symbol):
        return create(op_name, [lhs, rhs], {})
    return create(op_name, [lhs], {'scalar': float(rhs)})


def _sym_scalar(lhs, scalar, op_name):
    return create(op_name, [lhs], {'scalar': float(scalar)})


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------

def _entry(nodes, e):
    """Graph entry [node, out_idx(, version)] — the reference wrote
    2-element entries pre-0.9 and 3-element after."""
    return (nodes[e[0]], e[1] if len(e) > 1 else 0)


def load_json(json_str):
    """Parse graph JSON — ours and the reference's (both the 0.11 form
    with 'attrs' and the legacy form with 'param' op-attrs + 'attr'
    user-attrs, e.g. tests/python/unittest/save_000800.json)."""
    g = json.loads(json_str)
    nodes = []
    for jn in g['nodes']:
        if jn['op'] == 'null':
            attr_dict = {}
            for src in (jn.get('attrs', {}), jn.get('attr', {})):
                for k, v in src.items():
                    if k.startswith('__user__'):
                        attr_dict[k[len('__user__'):]] = v
                    else:
                        attr_dict[k] = v
            nodes.append(Node(None, {}, [], jn['name'], attr_dict))
        else:
            attrs = {}
            attr_dict = dict(jn.get('attr', {}))  # legacy user attrs
            for k, v in jn.get('attrs', jn.get('param', {})).items():
                if k.startswith('__user__'):
                    attr_dict[k[len('__user__'):]] = v
                else:
                    attrs[k] = _parse_attr(v)
            inputs = [_entry(nodes, e) for e in jn['inputs']]
            # legacy graphs omit auxiliary-state inputs (BatchNorm
            # moving_mean/var were implicit pre-0.9): synthesize ONLY
            # the missing trailing aux variables, compose-named
            if _reg.exists(jn['op']):
                op = _reg.get(jn['op'])
                names = op.input_names
                n_aux = len(op.aux_inputs)
                if n_aux and len(inputs) == len(names) - n_aux:
                    for miss in names[len(inputs):]:
                        inputs.append((Node(None, {}, [],
                                            '%s_%s' % (jn['name'], miss),
                                            {}), 0))
            nodes.append(Node(jn['op'], normalize_attrs(attrs), inputs,
                              jn['name'], attr_dict,
                              num_args=len(inputs)))
    outputs = [_entry(nodes, e) for e in g['heads']]
    return Symbol(outputs)


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


def __getattr__(name):
    """Deep-import compat: the reference defines module-level helpers
    (arange, maximum, hypot, ...) in symbol/symbol.py itself; here they
    live on the package — forward lookups there."""
    if name.startswith('_'):
        raise AttributeError(name)
    import sys as _s
    pkg = _s.modules[__package__]
    if hasattr(pkg, name):
        return getattr(pkg, name)
    raise AttributeError('module %r has no attribute %r'
                         % (__name__, name))
