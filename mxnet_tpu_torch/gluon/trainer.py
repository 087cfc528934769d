"""Gluon Trainer, an Optimizer over a set of Parameters: the counterpart of
``mxnet_tpu/gluon/trainer.py``.

``step(batch_size)`` sets ``rescale_grad = scale / batch_size``, then for
each parameter sums its gradients over its contexts on the KVStore (when
one is warranted: several contexts, or a store given) and updates each
context's weight with that context's updater, or lets the store update
and pulls the weights (``update_on_kvstore``). With one context a
'device' or 'local' kvstore gives no store, so each update runs where the
parameter lives, on the card by default. ``set_learning_rate``, the check
that all parameters share their contexts, the stale-gradient check and
``save_states``/``load_states`` are as in the JAX package.
"""
from .. import optimizer as opt
from ..model import _create_kvstore
from .parameter import ParameterDict, Parameter

__all__ = ['Trainer']


def _trainable(params):
    """Validate and flatten the params argument; keep grad-bearing ones."""
    if isinstance(params, (dict, ParameterDict)):
        params = list(params.values())
    if not isinstance(params, (list, tuple)):
        raise ValueError(
            'First argument must be a list or dict of Parameters, '
            'got %s.' % (type(params)))
    for p in params:
        if not isinstance(p, Parameter):
            raise ValueError(
                'First argument must be a list or dict of Parameters, '
                'got list of %s.' % (type(p)))
    return [p for p in params if p.grad_req != 'null']


class Trainer:
    """Steps an optimizer over a Block's parameters, aggregating
    gradients across the parameters' contexts through a KVStore (or
    per-context Updaters when no store is warranted)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore='device'):
        self._params = _trainable(params)
        self._scale = float((optimizer_params or {}).get('rescale_grad', 1.0))
        self._contexts = self._shared_contexts()
        self._init_optimizer(optimizer, optimizer_params or {})
        self._kvstore = kvstore
        self._kv_initialized = False

    def _shared_contexts(self):
        """All parameters must live on one common context list."""
        seen = None
        for p in self._params:
            ctx = p.list_ctx()
            if seen is not None and seen != ctx:
                raise AssertionError(
                    'All Parameters must be initialized on the same set of '
                    'contexts, but Parameter %s is initialized on %s while '
                    'previous Parameters are initialized on %s.'
                    % (p.name, str(ctx), str(seen)))
            seen = ctx
        return seen

    def _init_optimizer(self, optimizer, optimizer_params):
        by_index = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise AssertionError('optimizer_params must be None if '
                                     'optimizer is an Optimizer instance')
            self._optimizer = optimizer
            optimizer.param_dict = by_index
        else:
            self._optimizer = opt.create(optimizer, param_dict=by_index,
                                         **optimizer_params)
        self._updaters = [opt.get_updater(self._optimizer)
                          for _ in self._contexts]

    def _init_kvstore(self):
        """Decide the gradient-aggregation path once, at the first step."""
        sample = {p.name: p.data(self._contexts[0]) for p in self._params}
        kvstore, update_on_kvstore = _create_kvstore(
            self._kvstore, len(self._contexts), sample)
        if not kvstore:
            self._kvstore, self._update_on_kvstore = None, False
        else:
            if 'dist' in kvstore.type:
                update_on_kvstore = False
            for i, p in enumerate(self._params):
                replicas = p.list_data()
                kvstore.init(i, replicas[0])
                if update_on_kvstore:
                    kvstore.pull(i, replicas, priority=-i)
            if update_on_kvstore:
                kvstore.set_optimizer(self._optimizer)
            self._kvstore = kvstore
            self._update_on_kvstore = update_on_kvstore
        self._kv_initialized = True

    @property
    def learning_rate(self):
        return self._optimizer.lr

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _assert_fresh(self, param):
        for data in param.list_data():
            if data._fresh_grad:
                raise UserWarning(
                    'Gradient of Parameter `%s` on context %s has not '
                    'been updated by backward since last `step`. This '
                    'could mean a bug in your model that made it only '
                    'use a subset of the Parameters (Blocks) for this '
                    'iteration. If you are intentionally only using a '
                    'subset, call step with ignore_stale_grad=True to '
                    'suppress this warning and skip updating of '
                    'Parameters with stale gradient' % (
                        param.name, str(data.context)))

    def step(self, batch_size, ignore_stale_grad=False):
        """Aggregate the gradients and apply one optimizer update."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size

        for i, param in enumerate(self._params):
            if param.grad_req == 'null':
                continue
            if not ignore_stale_grad:
                self._assert_fresh(param)

            store = self._kvstore
            if store:
                store.push(i, param.list_grad(), priority=-i)
                if self._update_on_kvstore:
                    # server-side update: fetch fresh weights, done
                    store.pull(i, param.list_data(), priority=-i)
                    continue
                store.pull(i, param.list_grad(), priority=-i)

            for updater, weight, grad in zip(
                    self._updaters, param.list_data(), param.list_grad()):
                if not ignore_stale_grad or not weight._fresh_grad:
                    updater(i, grad, weight)
                    weight._fresh_grad = True
        # arm staleness tracking for the next backward
        for param in self._params:
            for data in param.list_data():
                data._fresh_grad = True

    def save_states(self, fname):
        assert self._optimizer is not None
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname, dump_optimizer=True)
        else:
            blob = self._updaters[0].get_states(dump_optimizer=True)
            with open(fname, 'wb') as fout:
                fout.write(blob)

    def load_states(self, fname):
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            self._optimizer = self._kvstore._updater.optimizer
        else:
            with open(fname, 'rb') as f:
                blob = f.read()
            for updater in self._updaters:
                updater.set_states(blob)
                updater.optimizer = self._updaters[0].optimizer
            self._optimizer = self._updaters[0].optimizer
