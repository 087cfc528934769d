"""Gluon Parameter and ParameterDict: the counterpart of
``mxnet_tpu/gluon/parameter.py`` (deferred initialisation, a copy per
context, ``grad_req``, ``data``/``grad``/``set_data``/``zero_grad``,
``var``, ``cast``; ParameterDict's get with prefix nesting and sharing).

A parameter's data is a marked autograd variable (its gradient buffer
attached by ``autograd.mark_variables``) unless its ``grad_req`` is
'null'. ``ParameterDict.save``/``load`` go through ``nd.save``/``nd.load``,
so the files cross between the packages. :func:`params_from_numpy` sets a Block's or an
Executor's parameters and aux states from numpy arrays by name (the JAX
package's values, in the tests).
"""
import numpy as np
import torch

from .. import autograd
from .. import ndarray as nd
from ..base import MXNetError
from ..context import Context, cpu, current_context
from .. import initializer as initializer_mod
from ..initializer import InitDesc, Uniform

__all__ = ['Parameter', 'ParameterDict', 'DeferredInitializationError',
           'params_from_numpy']


class DeferredInitializationError(MXNetError):
    """Error for unfinished deferred initialization."""


class Parameter:
    """A weight of a Block, held on one or more contexts."""

    def __init__(self, name, grad_req='write', shape=None, dtype=np.float32,
                 lr_mult=1.0, wd_mult=1.0, init=None, allow_deferred_init=False,
                 differentiable=True):
        self._var = None
        self._data = None
        self._grad = None
        self._ctx_list = None
        self._deferred_init = ()
        self._differentiable = differentiable
        self._allow_deferred_init = allow_deferred_init
        self._grad_req = None
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.grad_req = grad_req
        self.init = init

    def __repr__(self):
        s = 'Parameter {name} (shape={shape}, dtype={dtype})'
        return s.format(name=self.name, shape=self.shape, dtype=self.dtype)

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        assert req in ['write', 'add', 'null'], \
            "grad_req must be one of 'write', 'add', or 'null', but got '%s'" % req
        if not self._differentiable:
            req = 'null'
        if self._grad_req == req:
            return
        self._grad_req = req
        if req == 'null' and self._grad is not None:
            self._grad = None
            if self._data:
                for arr in self._data.values():
                    arr._grad, arr._grad_req = None, None
                    arr._data = arr._data.detach()
        elif self._data is not None:
            self._init_grad()

    def _check_and_get(self, arr_dict, ctx):
        if arr_dict is not None:
            if ctx is list:
                return list(arr_dict.values())
            if ctx is None:
                if len(arr_dict) == 1:
                    return list(arr_dict.values())[0]
                ctx = current_context()
            if ctx in arr_dict:
                return arr_dict[ctx]
            raise RuntimeError(
                "Parameter %s was not initialized on context %s. "
                "It was only initialized on %s." % (
                    self.name, str(ctx), str(list(arr_dict.keys()))))
        if self._deferred_init:
            raise DeferredInitializationError(
                'Parameter %s has not been initialized yet because '
                'initialization was deferred. Actual initialization happens '
                'during the first forward pass. Please pass one batch of data '
                'through the network before accessing Parameters.' % self.name)
        raise RuntimeError(
            "Parameter %s has not been initialized. Note that you should "
            "initialize parameters and create Trainer with Block.collect_params() "
            "instead of Block.params because the later does not include "
            "Parameters of nested child Blocks" % self.name)

    def _load_init(self, data, ctx):
        if self.shape:
            for self_dim, data_dim in zip(self.shape, data.shape):
                assert self_dim == 0 or self_dim == data_dim, \
                    'Failed loading Parameter %s from saved params: shape ' \
                    'incompatible expected %s vs saved %s' % (
                        self.name, str(self.shape), str(data.shape))
        if isinstance(ctx, Context):
            ctx = [ctx]
        if self._data is None:
            if self._deferred_init:
                assert set(ctx) == set(self._deferred_init[1]), \
                    'Failed to load Parameter %s on %s because it was previous ' \
                    'initialized on %s.' % (self.name, str(ctx),
                                            str(self.list_ctx()))
            self._init_impl(data, ctx)
        else:
            assert set(ctx) == set(self.list_ctx()), \
                'Failed to load Parameter %s on %s because it was previous ' \
                'initialized on %s.' % (self.name, str(ctx),
                                        str(self.list_ctx()))
            self.set_data(data)
        self._deferred_init = ()

    def _finish_deferred_init(self):
        """Allocate and initialise on the host, then copy to each
        context."""
        if not self._deferred_init:
            return
        init, ctx, default_init = self._deferred_init
        self._deferred_init = ()
        assert self.shape is not None and np.prod(self.shape) > 0, \
            'Cannot initialize Parameter %s because it has invalid shape: %s.' \
            % (self.name, str(self.shape))
        with autograd.pause():
            data = nd.zeros(self.shape, dtype=self.dtype, ctx=cpu())
            initializer = initializer_mod.create(
                init if init is not None else default_init)
            initializer(InitDesc(self.name, {'__init__': ''}), data)
            self._init_impl(data, ctx)

    def _init_impl(self, data, ctx_list):
        self._ctx_list = list(ctx_list)
        self._data = {ctx: data.copyto(ctx) for ctx in self._ctx_list}
        self._init_grad()

    def _init_grad(self):
        if self.grad_req == 'null':
            self._grad = None
            return
        self._grad = {ctx: nd.zeros(self._data[ctx].shape, ctx=ctx,
                                    dtype=self._data[ctx].dtype)
                      for ctx in self._data}
        for ctx in self._data:
            autograd.mark_variables([self._data[ctx]], [self._grad[ctx]],
                                    self.grad_req)

    def initialize(self, init=None, ctx=None, default_init=Uniform(),
                   force_reinit=False):
        """Initialise now, or at the first forward when the shape is not
        known yet (``allow_deferred_init``)."""
        if self._data is not None and not force_reinit:
            return
        if ctx is None:
            ctx = [current_context()]
        if isinstance(ctx, Context):
            ctx = [ctx]
        if init is None:
            init = default_init if self.init is None else self.init
        if not self.shape or np.prod(self.shape) <= 0:
            if self._allow_deferred_init:
                self._deferred_init = (init, ctx, default_init)
                return
            raise ValueError('Cannot initialize Parameter %s because it has '
                             'invalid shape: %s.' % (self.name, str(self.shape)))
        self._deferred_init = (init, ctx, default_init)
        self._finish_deferred_init()

    def reset_ctx(self, ctx):
        if ctx is None:
            ctx = [current_context()]
        if isinstance(ctx, Context):
            ctx = [ctx]
        if self._data:
            data = self._reduce()
            with autograd.pause():
                self._init_impl(data, ctx)
        elif self._deferred_init:
            init, _, default_init = self._deferred_init
            self._deferred_init = (init, ctx, default_init)
        else:
            raise ValueError('Cannot reset context for Parameter %s because it '
                             'has not been initialized.' % self.name)

    def set_data(self, data):
        assert self._data is not None, \
            'Parameter %s has not been initialized' % self.name
        for ctx in self._data:
            self._data[ctx]._data = data.copyto(ctx)._data

    def data(self, ctx=None):
        return self._check_and_get(self._data, ctx)

    def list_data(self):
        return self._check_and_get(self._data, list)

    def grad(self, ctx=None):
        if self._data is not None and self._grad is None:
            raise RuntimeError(
                "Cannot get gradient array for Parameter %s because grad_req='null'"
                % self.name)
        return self._check_and_get(self._grad, ctx)

    def list_grad(self):
        if self._data is not None and self._grad is None:
            raise RuntimeError(
                "Cannot get gradient array for Parameter %s because grad_req='null'"
                % self.name)
        return self._check_and_get(self._grad, list)

    def list_ctx(self):
        if self._data is None:
            if self._deferred_init:
                return self._deferred_init[1]
            raise RuntimeError('Parameter %s has not been initialized' % self.name)
        return self._ctx_list

    def zero_grad(self):
        if self._grad is None:
            return
        for g in self._grad.values():
            g[:] = 0
        for d in self._data.values():
            d._fresh_grad = True

    def _reduce(self):
        """Average weights over contexts → cpu copy."""
        block = self.list_data()
        return block[0].copyto(cpu())

    def var(self):
        if self._var is None:
            from .. import symbol
            self._var = symbol.var(self.name, shape=self.shape,
                                   lr_mult=self.lr_mult, wd_mult=self.wd_mult,
                                   init=self.init)
        return self._var

    def cast(self, dtype):
        self.dtype = dtype
        if self._data is None:
            return
        with autograd.pause():
            self._data = {ctx: d.astype(dtype) for ctx, d in self._data.items()}
            self._init_grad()


class ParameterDict:
    """Parameters by name, under a prefix, optionally sharing another
    dict's."""

    def __init__(self, prefix='', shared=None):
        self._prefix = prefix
        self._params = {}
        self._shared = shared

    def __getitem__(self, key):
        return self._params[key]

    def __repr__(self):
        s = '{name}(\n{content}\n)'
        name = self._prefix + ' ' if self._prefix else ''
        return s.format(name=name, content='\n'.join(
            [_indent('  {0}'.format(v), 2) for v in self.values()]))

    def __iter__(self):
        return iter(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._shared._params[name]
        return None

    def get(self, name, **kwargs):
        """The parameter ``prefix + name``, created with ``kwargs`` if it
        does not exist; an existing one must agree with them (a 0 in a
        shape is unknown and takes the other's value)."""
        name = self.prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
        else:
            for k, v in kwargs.items():
                if hasattr(param, k) and getattr(param, k) is not None:
                    existing = getattr(param, k)
                    if k == 'shape' and v is not None and len(v) == len(existing):
                        inferred_shape = []
                        matched = True
                        for dim1, dim2 in zip(v, existing):
                            if dim1 != dim2 and dim1 * dim2 != 0:
                                matched = False
                                break
                            elif dim1 == dim2:
                                inferred_shape.append(dim1)
                            elif dim1 == 0:
                                inferred_shape.append(dim2)
                            else:
                                inferred_shape.append(dim1)
                        if matched:
                            param.shape = tuple(inferred_shape)
                            continue
                    assert v is None or v == existing, \
                        'Cannot retrieve Parameter %s because desired attribute ' \
                        'does not match with stored for attribute %s: desired %s' \
                        ' vs stored %s.' % (name, k, str(v), str(getattr(param, k)))
                else:
                    setattr(param, k, v)
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params:
                assert self._params[k] is v, \
                    'Cannot update self with other because they have different ' \
                    'Parameters with the same name %s' % k
            else:
                self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        if verbose and init is not None:
            init.set_verbosity(verbose=verbose)
        for _, v in self.items():
            v.initialize(None, ctx, init if init is not None else Uniform(),
                         force_reinit=force_reinit)

    def zero_grad(self):
        for i in self.values():
            i.zero_grad()

    def reset_ctx(self, ctx):
        for i in self.values():
            i.reset_ctx(ctx)

    def setattr(self, name, value):
        for i in self.values():
            setattr(i, name, value)

    def save(self, filename, strip_prefix=''):
        """Each parameter's value (from its first context) into
        ``filename`` by ``nd.save``, under its name less ``strip_prefix``."""
        arg_dict = {}
        for param in self.values():
            weight = param._reduce()
            if not param.name.startswith(strip_prefix):
                raise ValueError(
                    'Prefix %s is to be striped before saving, but Parameter '
                    '%s does not start with %s.' % (
                        strip_prefix, param.name, strip_prefix))
            arg_dict[param.name[len(strip_prefix):]] = weight
        nd.save(filename, arg_dict)

    def load(self, filename, ctx, allow_missing=False,
             ignore_extra=False, restore_prefix=''):
        """Each parameter's value from ``filename`` (``nd.load``; names
        carry ``restore_prefix`` back), initialised on ``ctx``."""
        if restore_prefix:
            for name in self.keys():
                assert name.startswith(restore_prefix), \
                    'restore_prefix is %s but Parameters name %s does not start ' \
                    'with %s' % (restore_prefix, name, restore_prefix)
        lprefix = len(restore_prefix)
        arg_dict = {restore_prefix + k: v for k, v in nd.load(filename).items()}
        if not allow_missing:
            for name in self.keys():
                assert name in arg_dict, \
                    'Parameter %s is missing in file %s' % (name[lprefix:], filename)
        for name in arg_dict:
            if name not in self._params:
                assert ignore_extra, \
                    'Parameter %s loaded from file %s is not present in ' \
                    'ParameterDict' % (name[lprefix:], filename)
                continue
            self[name]._load_init(arg_dict[name], ctx)


def params_from_numpy(target, arrays, allow_missing=False):
    """Set ``target``'s parameters and aux states from ``arrays``, a dict of
    numpy arrays by full name: a Block's (``collect_params()``, on every
    context each is held on, in its own dtype) or an Executor's
    (``arg_dict`` and ``aux_dict``). Every name of the target must be there
    unless ``allow_missing``; a name the target does not have raises."""
    if hasattr(target, 'collect_params'):
        params = dict(target.collect_params().items())
        dests = {n: p.list_data() for n, p in params.items()}
    else:
        dests = {n: [a] for n, a in list(target.arg_dict.items())
                 + list(target.aux_dict.items())}
    extra = sorted(set(arrays) - set(dests))
    if extra:
        raise KeyError('no parameter or aux state named %s' % extra)
    missing = sorted(set(dests) - set(arrays))
    if missing and not allow_missing:
        raise KeyError('no value given for %s' % missing)
    for name, value in arrays.items():
        src = torch.from_numpy(np.ascontiguousarray(value, np.float32)
                               if np.asarray(value).dtype.name == 'bfloat16'
                               else np.ascontiguousarray(value))
        for dst in dests[name]:
            if tuple(dst.shape) != tuple(src.shape):
                raise ValueError('%s: shape %s, given %s'
                                 % (name, dst.shape, tuple(src.shape)))
            dst._data = src.to(dst._data.device, dst._data.dtype)


def _indent(s_, num_spaces):
    s = str(s_).split('\n')
    if len(s) == 1:
        return s_
    first = s.pop(0)
    return first + '\n' + '\n'.join(' ' * num_spaces + line for line in s)
