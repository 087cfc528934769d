"""Shape and type inference over a Symbol graph: the counterpart of
``mxnet_tpu/symbol/infer.py``.

A forward walk in topological order runs each op on ``meta`` tensors (in
the place of ``jax.eval_shape``): shapes and dtypes, no data and no
device. Unknown parameter shapes are filled by per-op hooks from the data
input's shape and the attrs. A host op's shapes come from its
``shape_fn``. Another op that cannot run on ``meta`` (one that reads its
data) raises MXNetError naming the node; there is no fallback to running
it on the CPU.
"""
import ast

import numpy as np
import torch

from ..base import MXNetError, np_dtype, torch_dtype

__all__ = ['infer_shapes', 'infer_types', 'param_shape_hook']

_PARAM_HOOKS = {}
_META = torch.device('meta')


def param_shape_hook(op_name):
    def deco(fn):
        _PARAM_HOOKS[op_name] = fn
        return fn
    return deco


@param_shape_hook('FullyConnected')
def _fc_params(attrs, in_shapes):
    data = in_shapes[0]
    if data is None:
        return {}
    flat = int(np.prod(data[1:])) if attrs.get('flatten', True) else data[-1]
    n = int(attrs['num_hidden'])
    out = {'weight': (n, flat)}
    if not attrs.get('no_bias', False):
        out['bias'] = (n,)
    return out


@param_shape_hook('Convolution')
def _conv_params(attrs, in_shapes):
    data = in_shapes[0]
    if data is None:
        return {}
    nf = int(attrs['num_filter'])
    g = int(attrs.get('num_group', 1))
    out = {'weight': (nf, data[1] // g) + tuple(attrs['kernel'])}
    if not attrs.get('no_bias', False):
        out['bias'] = (nf,)
    return out


@param_shape_hook('Deconvolution')
def _deconv_params(attrs, in_shapes):
    data = in_shapes[0]
    if data is None:
        return {}
    nf = int(attrs['num_filter'])
    g = int(attrs.get('num_group', 1))
    out = {'weight': (data[1], nf // g) + tuple(attrs['kernel'])}
    if not attrs.get('no_bias', True):
        out['bias'] = (nf,)
    return out


@param_shape_hook('BatchNorm')
def _bn_params(attrs, in_shapes):
    data = in_shapes[0]
    if data is None:
        return {}
    c = data[int(attrs.get('axis', 1)) % len(data)]
    return {'gamma': (c,), 'beta': (c,), 'moving_mean': (c,),
            'moving_var': (c,)}


@param_shape_hook('LayerNorm')
def _ln_params(attrs, in_shapes):
    data = in_shapes[0]
    if data is None:
        return {}
    ax = int(attrs.get('axis', -1)) % len(data)
    return {'gamma': (data[ax],), 'beta': (data[ax],)}


@param_shape_hook('Embedding')
def _emb_params(attrs, in_shapes):
    return {'weight': (int(attrs['input_dim']), int(attrs['output_dim']))}


@param_shape_hook('LeakyReLU')
def _lrelu_params(attrs, in_shapes):
    if attrs.get('act_type') == 'prelu' and in_shapes[0]:
        return {'gamma': (in_shapes[0][1],)}
    return {}


@param_shape_hook('RNN')
def _rnn_params(attrs, in_shapes):
    from ..ops.rnn_ops import rnn_param_size
    data = in_shapes[0]
    if data is None:
        return {}
    H = int(attrs['state_size'])
    L = int(attrs.get('num_layers', 1))
    bi = bool(attrs.get('bidirectional', False))
    dirs = 2 if bi else 1
    mode = attrs.get('mode', 'lstm')
    n = rnn_param_size(L, H, data[2], bi, mode)
    out = {'parameters': (n,), 'state': (L * dirs, data[1], H)}
    if mode == 'lstm':
        out['state_cell'] = (L * dirs, data[1], H)
    return out


@param_shape_hook('SoftmaxOutput')
def _softmax_out_params(attrs, in_shapes):
    """The label's shape from the data's: (N,) by default, (N, d2, ...)
    with multi_output (the class axis 1 removed), the data's less its last
    axis with preserve_shape."""
    data = in_shapes[0]
    if data is None:
        return {}
    if attrs.get('preserve_shape', False):
        return {'label': tuple(data[:-1])}
    if attrs.get('multi_output', False):
        return {'label': (data[0],) + tuple(data[2:])}
    return {'label': (data[0],)}


@param_shape_hook('InstanceNorm')
def _in_params(attrs, in_shapes):
    data = in_shapes[0]
    return {'gamma': (data[1],), 'beta': (data[1],)} if data else {}


@param_shape_hook('SVMOutput')
def _svm_out_params(attrs, in_shapes):
    data = in_shapes[0]
    return {'label': (data[0],)} if data else {}


def _reg_out_params(attrs, in_shapes):
    """The regression heads: the label has the data's shape."""
    data = in_shapes[0]
    return {'label': tuple(data)} if data else {}


for _name in ('LinearRegressionOutput', 'MAERegressionOutput',
              'LogisticRegressionOutput'):
    param_shape_hook(_name)(_reg_out_params)
del _name


def _node_arg_name(node, i):
    names = node.opdef().input_names
    return names[i] if i < len(names) else 'arg%d' % i


def infer_shapes(symbol, known, partial=False, known_types=None):
    """Returns (arg_shapes, out_shapes, aux_shapes) in canonical orders."""
    known_types = known_types or {}
    shapes = {}   # id(node) -> a shape per output
    var_shape = {}
    for n in symbol._topo():
        if n.is_variable():
            s = known.get(n.name)
            if s is None and '__shape__' in n.attr_dict:
                s = tuple(ast.literal_eval(n.attr_dict['__shape__']))
            if s is not None and any(d == 0 for d in s):
                s = None  # 0-dims mean "unknown" (MXNet convention)
            var_shape[n.name] = tuple(s) if s is not None else None
            shapes[id(n)] = [var_shape[n.name]]
            continue
        op = n.opdef()
        in_shapes = []
        for (p, idx) in n.inputs:
            sh = shapes.get(id(p))
            in_shapes.append(sh[idx] if sh is not None and sh[idx] is not None
                             else None)
        hook = _PARAM_HOOKS.get(n.op)
        if hook is not None:
            fills = hook(n.attrs, in_shapes)
            for i, (p, idx) in enumerate(n.inputs):
                if in_shapes[i] is None and p.is_variable():
                    want = fills.get(_node_arg_name(n, i))
                    if want is not None:
                        var_shape[p.name] = tuple(int(x) for x in want)
                        shapes[id(p)] = [var_shape[p.name]]
                        in_shapes[i] = var_shape[p.name]
        if any(s is None for s in in_shapes):
            if partial:
                shapes[id(n)] = [None] * op.n_outputs(n.attrs)
                continue
            missing = [_node_arg_name(n, i) for i, s in enumerate(in_shapes)
                       if s is None]
            raise MXNetError('cannot infer shape for inputs %s of node %s(%s)'
                             % (missing, n.name, n.op))
        shapes[id(n)] = _eval_node_shape(n, in_shapes, known_types)
    args = symbol.list_arguments()
    auxs = symbol.list_auxiliary_states()
    out_shapes = []
    for node, idx in symbol._outputs:
        s = shapes.get(id(node))
        out_shapes.append(s[idx] if s else None)
    return ([var_shape.get(a) for a in args], out_shapes,
            [var_shape.get(a) for a in auxs])


def _eval_node_shape(n, in_shapes, known_types):
    """The node's output shapes, from its op run on meta tensors."""
    op = n.opdef()
    attrs = dict(n.attrs)
    if op.train_aware:
        attrs['__is_train__'] = False
    if op.host:
        # a host op reads its data: its shapes come from its shape_fn (the
        # Python callbacks' infer_shape, the codecs' geometry)
        if op.shape_fn is None:
            raise MXNetError(
                'host op %s(%s) has a data-dependent output shape; it can '
                'only be used imperatively' % (n.name, n.op))
        out_shapes, _ = op.shape_fn(attrs, [tuple(s) for s in in_shapes])
        return [tuple(s) for s in out_shapes]
    dt = torch_dtype(known_types.get(None, 'float32'))
    args = [torch.empty(s, dtype=dt, device=_META) for s in in_shapes]
    if op.needs_rng:
        args.append(None)
    try:
        with torch.no_grad():
            out = op.fn(attrs, *args)
    except Exception as e:
        raise MXNetError('shape inference failed at %s(%s) with inputs %s: '
                         'the op cannot run on meta tensors (%s: %s)'
                         % (n.name, n.op, in_shapes, type(e).__name__, e))
    if not isinstance(out, (tuple, list)):
        out = (out,)
    return [tuple(o.shape) for o in out]


def _is_floating(t):
    dt = np.dtype(t)
    return dt.name in ('bfloat16', 'float16') or np.issubdtype(dt, np.floating)


def infer_types(symbol, known):
    """Forward propagation of dtypes: a node's outputs take its first
    input's type (Cast its attr's); an unknown parameter takes the first
    floating type known among its node's inputs (so the parameters of a
    bf16 node are bf16)."""
    dtypes = {}
    var_dtype = {}
    for n in symbol._topo():
        if n.is_variable():
            t = known.get(n.name)
            if t is None and '__dtype__' in n.attr_dict:
                t = n.attr_dict['__dtype__']
            var_dtype[n.name] = np_dtype(t) if t is not None else None
            dtypes[id(n)] = [var_dtype[n.name]]
            continue
        in_dtypes = [dtypes[id(p)][i] for (p, i) in n.inputs]
        seed = next((t for t in in_dtypes if t is not None
                     and _is_floating(t)), np.dtype('float32'))
        for (p, i), t in zip(n.inputs, in_dtypes):
            if t is None and p.is_variable():
                var_dtype[p.name] = seed
                dtypes[id(p)] = [seed]
        in_dtypes = [dtypes[id(p)][i] for (p, i) in n.inputs]
        out_t = in_dtypes[0] if in_dtypes else np.dtype('float32')
        if n.op == 'Cast':
            out_t = np_dtype(n.attrs['dtype'])
        dtypes[id(n)] = [out_t] * n.opdef().n_outputs(n.attrs)
    args = symbol.list_arguments()
    auxs = symbol.list_auxiliary_states()
    f32 = np.dtype('float32')
    outs = [dtypes[id(node)][idx] or f32 for node, idx in symbol._outputs]
    return ([var_dtype.get(a) or f32 for a in args], outs,
            [var_dtype.get(a) or f32 for a in auxs])
