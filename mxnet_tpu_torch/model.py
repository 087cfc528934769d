"""Checkpoints and the KVStore helpers that Module and Gluon build on: the
counterpart of ``mxnet_tpu/model.py``.

``save_checkpoint`` writes ``{prefix}-symbol.json`` and
``{prefix}-{epoch:04d}.params`` (the arrays under ``arg:`` and ``aux:``
keys, in ``nd.save``'s npz container), and ``load_checkpoint`` reads them
back, from either package. ``_create_kvstore`` decides the store and
whether updates run on it; ``_initialize_kvstore``,
``_update_params_on_kvstore`` and ``_update_params`` are the per-batch
update paths. ``FeedForward`` is the legacy API over ``Module`` (over
``BucketingModule`` for a ``sym_gen``).
"""
import logging
from collections import namedtuple

import numpy as np

from . import io
from . import kvstore as kvs
from . import ndarray as nd
from . import symbol as sym

BatchEndParam = namedtuple('BatchEndParams',
                           ['epoch', 'nbatch', 'eval_metric', 'locals'])


def _create_kvstore(kvstore, num_device, arg_params):
    """``(kvstore, update_on_kvstore)``: no store for one device and a
    local type; a local store updates on itself unless a parameter holds
    more than 16M elements."""
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and 'dist' not in kvstore:
            kv = None
        else:
            kv = kvs.create(kvstore)
            if kvstore == 'local':
                max_size = max(np.prod(param.shape) for param in arg_params.values()) \
                    if arg_params else 0
                if max_size > 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise TypeError('kvstore must be KVStore, string or None')
    if kv is None:
        update_on_kvstore = False
    return (kv, update_on_kvstore)


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    for idx, param_on_devs in enumerate(param_arrays):
        name = param_names[idx]
        kvstore.init(name, arg_params[name])
        if update_on_kvstore:
            kvstore.pull(name, param_on_devs, priority=-idx)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore, param_names):
    """Push the gradients, pull the updated weights."""
    for index, pair in enumerate(zip(param_arrays, grad_arrays)):
        arg_list, grad_list = pair
        if grad_list[0] is None:
            continue
        name = param_names[index]
        kvstore.push(name, grad_list, priority=-index)
        kvstore.pull(name, arg_list, priority=-index)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, param_names=None):
    """Sum the gradients on the store (if any), then update each device's
    weights with the updater. The JAX package moves a pulled gradient back
    to its weight's mesh sharding here; with one torch device a context
    there is no sharding to restore, and pull already writes each
    gradient on its own array's device."""
    for index, pair in enumerate(zip(param_arrays, grad_arrays)):
        arg_list, grad_list = pair
        if grad_list[0] is None:
            continue
        if kvstore:
            name = param_names[index]
            kvstore.push(name, grad_list, priority=-index)
            kvstore.pull(name, grad_list, priority=-index)
        for k, p in enumerate(zip(arg_list, grad_list)):
            w, g = p
            updater(index * num_device + k, g, w)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    if symbol is not None:
        symbol.save('%s-symbol.json' % prefix)
    save_dict = {('arg:%s' % k): v for k, v in arg_params.items()}
    save_dict.update({('aux:%s' % k): v for k, v in aux_params.items()})
    param_name = '%s-%04d.params' % (prefix, epoch)
    nd.save(param_name, save_dict)
    logging.info('Saved checkpoint to "%s"', param_name)


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)``, the arrays on the CPU."""
    symbol = sym.load('%s-symbol.json' % prefix)
    save_dict = nd.load('%s-%04d.params' % (prefix, epoch))
    arg_params = {}
    aux_params = {}
    for k, v in save_dict.items():
        tp, name = k.split(':', 1)
        if tp == 'arg':
            arg_params[name] = v
        if tp == 'aux':
            aux_params[name] = v
    return (symbol, arg_params, aux_params)


def _num_samples(X):
    """The sample count of an array, a dict or a list of arrays."""
    if isinstance(X, dict):
        X = next(iter(X.values()))
    elif isinstance(X, (list, tuple)):
        X = X[0]
    return len(X)


class FeedForward:
    """The legacy training API, over :class:`..module.Module`; a callable
    symbol is a ``sym_gen(bucket_key)`` for bucketing iterators, trained
    through :class:`..module.BucketingModule`."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer='sgd', initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from .initializer import Uniform
        if isinstance(symbol, sym.Symbol) or not callable(symbol):
            self.symbol = symbol
            self._sym_gen = None
        else:
            # resolved at fit(), where the iterator names the default bucket
            self.symbol = None
            self._sym_gen = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.optimizer = optimizer
        self.initializer = initializer or Uniform(0.01)
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.begin_epoch = begin_epoch
        self.numpy_batch_size = numpy_batch_size
        self.kwargs = kwargs
        self._module = None

    def fit(self, X, y=None, eval_data=None, eval_metric='acc', kvstore='local',
            batch_end_callback=None, epoch_end_callback=None, logger=None,
            work_load_list=None, monitor=None, eval_end_callback=None,
            eval_batch_end_callback=None):
        from .module import Module, BucketingModule
        if not isinstance(X, io.DataIter):
            X = io.NDArrayIter(X, y, batch_size=min(self.numpy_batch_size,
                                                    _num_samples(X)),
                               shuffle=True)
        data_names = [d[0] for d in X.provide_data]
        label_names = [l[0] for l in X.provide_label]
        if self._sym_gen is not None:
            # the default bucket's symbol is kept for save(); the cache
            # resolves each bucket's symbol once
            gen, cache = self._sym_gen, {}

            def _gen(key):
                if key not in cache:
                    cache[key] = gen(key)
                return cache[key], data_names, label_names

            self._module = BucketingModule(
                _gen, default_bucket_key=X.default_bucket_key,
                context=self.ctx)
            self.symbol = _gen(X.default_bucket_key)[0]
        else:
            self._module = Module(self.symbol, data_names=data_names,
                                  label_names=label_names, context=self.ctx)
        self._module.fit(X, eval_data=eval_data, eval_metric=eval_metric,
                         kvstore=kvstore, initializer=self.initializer,
                         arg_params=self.arg_params, aux_params=self.aux_params,
                         optimizer=self.optimizer, optimizer_params=self.kwargs,
                         begin_epoch=self.begin_epoch, num_epoch=self.num_epoch,
                         monitor=monitor,
                         eval_end_callback=eval_end_callback,
                         eval_batch_end_callback=eval_batch_end_callback,
                         batch_end_callback=batch_end_callback,
                         epoch_end_callback=epoch_end_callback)
        self.arg_params, self.aux_params = self._module.get_params()
        return self

    def predict(self, X, num_batch=None):
        if not isinstance(X, io.DataIter):
            X = io.NDArrayIter(X, batch_size=min(self.numpy_batch_size,
                                                 _num_samples(X)))
        return self._module.predict(X, num_batch=num_batch).asnumpy()

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch, **kwargs)

    def save(self, prefix, epoch=None):
        save_checkpoint(prefix, epoch or self.num_epoch, self.symbol,
                        self.arg_params, self.aux_params or {})
