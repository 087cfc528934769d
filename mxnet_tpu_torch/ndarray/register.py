"""Generation of the nd.* operator namespace from the registry: the
counterpart of ``mxnet_tpu/ndarray/register.py``.

Sparse arguments (:mod:`.sparse`): ``nd.dot`` with a CSR lhs and no
``transpose_b`` runs ``sparse.dot`` (gather and segment sum, work
proportional to the stored values), into an ``out=`` buffer if one is
given (a dense buffer takes the densified result, a sparse one of the
result's stype its payload); every other op lowers a sparse argument to
dense.
"""
from ..context import Context as _Ctx
from ..ops import registry as _reg
from . import sparse as _sp
from .ndarray import NDArray, invoke

__all__ = ['make_nd_function', 'install_ops']

def _lower_sparse(a):
    """A sparse container as its dense array; anything else as it is."""
    if isinstance(a, _sp.BaseSparseNDArray):
        return a.tostype('default')
    return a


def _sparse_dot(args, kwargs):
    """``nd.dot`` with a CSR lhs: ``sparse.dot``, written into ``out=``
    when given (shape and stype checked)."""
    res = _sp.dot(*args, **{k: v for k, v in kwargs.items()
                           if k in ('rhs', 'transpose_a', 'transpose_b')})
    out_nd = kwargs.get('out')
    if out_nd is None:
        return res
    if tuple(out_nd.shape) != tuple(res.shape):
        raise ValueError('out has shape %s but dot produced %s'
                         % (out_nd.shape, res.shape))
    if isinstance(out_nd, _sp.BaseSparseNDArray):
        res_st = getattr(res, 'stype', 'default')
        if res_st != out_nd.stype:
            raise ValueError('out has stype %s but dot produced %s'
                             % (out_nd.stype, res_st))
        out_nd.data = res.data
        out_nd.indices = res.indices
        if out_nd.stype == 'csr':
            out_nd.indptr = res.indptr
        return out_nd
    # a dense buffer takes the densified result (csr.T . dense gives
    # row_sparse) and leaves any recorded graph
    out_nd._data = _lower_sparse(res)._data
    out_nd._hist = None
    return out_nd


def make_nd_function(op_name):
    """A function ``fn(*args, out=None, name=None, **kwargs)`` for op
    ``op_name``: NDArray arguments fill the op's ``input_names`` in order
    (or by keyword), scalar positional arguments its ``param_defaults`` in
    order, and the remaining keywords are its attrs. A variadic op takes
    every positional NDArray and gets their count in its
    ``key_var_num_args`` attr."""
    op = _reg.get(op_name)
    routes_sparse_dot = op_name == 'dot'

    def fn(*args, **kwargs):
        if args or kwargs:
            if routes_sparse_dot and args and \
                    isinstance(args[0], _sp.CSRNDArray):
                tb = bool(kwargs.get('transpose_b', False)) or \
                    (len(args) > 3 and bool(args[3]))
                if not tb:
                    return _sparse_dot(args, kwargs)
            args = [_lower_sparse(a) for a in args]
            kwargs = {k: (v if k == 'out' else _lower_sparse(v))
                      for k, v in kwargs.items()}
        out = kwargs.pop('out', None)
        kwargs.pop('name', None)
        pos_inputs = [a for a in args if isinstance(a, NDArray)]
        # scalar positional args map onto declared params in order; a
        # positional None is an omitted optional input, and a positional
        # Context is the ctx kwarg
        pos_attrs = []
        for a in args:
            if isinstance(a, (NDArray, type(None))):
                continue
            if isinstance(a, _Ctx):
                kwargs.setdefault('ctx', a)
            else:
                pos_attrs.append(a)
        if pos_attrs:
            for pname in op.param_defaults:
                if not pos_attrs:
                    break
                if pname not in kwargs:
                    kwargs[pname] = pos_attrs.pop(0)
        if op.variadic:
            if op.key_var_num_args and op.key_var_num_args not in kwargs:
                kwargs[op.key_var_num_args] = len(pos_inputs)
            return invoke(op_name, pos_inputs, kwargs, out)
        named = {}
        for k in list(kwargs):
            if k in op.input_names and isinstance(kwargs[k], NDArray):
                named[k] = kwargs.pop(k)
        inputs = []
        pos_iter = iter(pos_inputs)
        for name in op.input_names:
            if name in named:
                inputs.append(named[name])
            else:
                nxt = next(pos_iter, None)
                if nxt is None:
                    break
                inputs.append(nxt)
        return invoke(op_name, inputs, kwargs, out)

    fn.__name__ = op_name
    fn.__doc__ = op.doc
    return fn


def install_ops(namespace):
    """Install one generated function per registered op into ``namespace``."""
    for name in _reg.list_ops():
        namespace[name] = make_nd_function(name)
    return namespace
