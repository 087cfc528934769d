"""BucketingModule, per-bucket Modules sharing one master's parameters:
the counterpart of ``mxnet_tpu/module/bucketing_module.py`` (reference
python/mxnet/module/bucketing_module.py:35). One Module per sequence-length
bucket, bound with ``shared_module`` to the widest ("default") bucket's,
whose parameter arrays they take; ``_curr_module`` switches per batch, and
an update on another bucket is copied back into the master's executor.

One difference from the JAX package: ``switch_bucket`` syncs the master's
own updates back from its executor before it hands its parameters on. The
JAX package's copies the master's ``_arg_params``, stale since the master's
last ``update``, into the next bucket's executor (the master's own too),
so an update made on the default bucket is lost at the next batch
(ROADMAP.md §3); the reference shares the arrays themselves and loses
nothing.

``fit`` runs BaseModule's per-batch loop: the fused window takes a plain
``Module`` only (``fused_fit.FusedFitLoop.build``), as in the JAX package.
Without a ``context`` the buckets run on the current context, the card
(the JAX package's default is the CPU). ``install_monitor`` keeps the JAX
package's repair: buckets created later get the monitor too.
"""
import logging
import warnings

from .. import context as ctx_mod
from ..initializer import Uniform
from .base_module import BaseModule
from .module import Module

__all__ = ['BucketingModule']


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._default_bucket_key = default_bucket_key
        self._sym_gen = sym_gen
        self._fixed_param_names = fixed_param_names or []
        self._state_names = state_names or []
        self._context = context if context is not None \
            else ctx_mod.current_context()
        self._work_load_list = work_load_list
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._params_dirty = False
        self._monitor = None

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    def _call_sym_gen(self, *args, **kwargs):
        return self._sym_gen(*args, **kwargs)

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        _, data_names, _ = self._call_sym_gen(self._default_bucket_key)
        return data_names

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        symbol, _, _ = self._call_sym_gen(self._default_bucket_key)
        return symbol.list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._curr_module.output_shapes

    @property
    def symbol(self):
        assert self.binded
        return self._curr_module.symbol

    def get_params(self):
        assert self.binded and self.params_initialized
        self._curr_module._params_dirty = self._params_dirty
        params = self._curr_module.get_params()
        self._params_dirty = False
        return params

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params, allow_missing=allow_missing,
                             force_init=force_init)
            return
        if self.params_initialized and not force_init:
            warnings.warn('Parameters already initialized and force_init=False. '
                          'set_params call ignored.', stacklevel=2)
            return
        self._curr_module.set_params(arg_params, aux_params,
                                     allow_missing=allow_missing,
                                     force_init=force_init,
                                     allow_extra=allow_extra)
        self._params_dirty = False
        self.params_initialized = True

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, 'call bind before initializing the parameters'
        self._curr_module.init_params(initializer=initializer,
                                      arg_params=arg_params,
                                      aux_params=aux_params,
                                      allow_missing=allow_missing,
                                      force_init=force_init,
                                      allow_extra=allow_extra)
        self._params_dirty = False
        self.params_initialized = True

    def get_states(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._curr_module.get_states(merge_multi_context)

    def set_states(self, states=None, value=None):
        assert self.binded and self.params_initialized
        self._curr_module.set_states(states, value)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req='write'):
        assert shared_module is None, \
            'shared_module for BucketingModule is not supported'
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning('Already bound, ignoring bind()')
            return

        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True

        symbol, data_names, label_names = self._call_sym_gen(
            self._default_bucket_key)
        module = Module(symbol, data_names, label_names, logger=self.logger,
                        context=self._context,
                        work_load_list=self._work_load_list,
                        fixed_param_names=self._fixed_param_names,
                        state_names=self._state_names)
        module.bind(data_shapes, label_shapes, for_training, inputs_need_grad,
                    force_rebind=False, shared_module=None, grad_req=grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module
        if self._monitor is not None:
            # a force_rebind recreates the default bucket; the saved
            # monitor must follow it or default-key batches go silent
            module.install_monitor(self._monitor)

        if self.params_initialized:
            self.set_params(self._arg_params, self._aux_params)

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Reference bucketing_module.py:322."""
        assert self.binded, 'call bind before switching bucket'
        if bucket_key not in self._buckets:
            symbol, data_names, label_names = self._call_sym_gen(bucket_key)
            module = Module(symbol, data_names, label_names,
                            logger=self.logger, context=self._context,
                            work_load_list=self._work_load_list,
                            fixed_param_names=self._fixed_param_names,
                            state_names=self._state_names)
            module.bind(data_shapes, label_shapes, self._curr_module.for_training,
                        self._curr_module.inputs_need_grad,
                        force_rebind=False,
                        shared_module=self._buckets[self._default_bucket_key])
            if self._monitor is not None:
                module.install_monitor(self._monitor)
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key
        # share parameters from the master module; an update the master
        # made itself is in its executor only until it is synced back
        master = self._buckets[self._default_bucket_key]
        if master.params_initialized:
            if master._params_dirty:
                master._sync_params_from_devices()
            arg_params, aux_params = master._arg_params, master._aux_params
            self._curr_module._arg_params = arg_params
            self._curr_module._aux_params = aux_params
            self._curr_module.params_initialized = True
            self._curr_module._exec_group.set_params(arg_params, aux_params)

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        self._curr_module.update()
        # propagate updated params back into the master module's arrays
        master = self._buckets[self._default_bucket_key]
        if self._curr_module is not master:
            self._curr_module._sync_params_from_devices()
            master._exec_group.set_params(self._curr_module._arg_params,
                                          self._curr_module._aux_params)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._curr_module.get_outputs(
            merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._curr_module.get_input_grads(
            merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        self._curr_module.update_metric(eval_metric, labels)

    def init_optimizer(self, kvstore='local', optimizer='sgd',
                       optimizer_params=(('learning_rate', 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning('optimizer already initialized, ignoring.')
            return
        self._curr_module.init_optimizer(kvstore, optimizer, optimizer_params,
                                         force_init=force_init)
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                mod.borrow_optimizer(self._curr_module)
        self.optimizer_initialized = True

    def install_monitor(self, mon):
        """Install on every live bucket AND save the monitor so
        bind/switch_bucket install it on later-created bucket modules
        (the reference's install_monitor, bucketing_module.py:496-500,
        only covers already-created buckets — lazily-created ones went
        silently unmonitored; fixed here rather than mirrored)."""
        assert self.binded
        self._monitor = mon
        for mod in self._buckets.values():
            mod.install_monitor(mon)

    @property
    def _arg_params(self):
        return self._buckets[self._default_bucket_key]._arg_params \
            if self._buckets else None

    @_arg_params.setter
    def _arg_params(self, value):
        pass

    @property
    def _aux_params(self):
        return self._buckets[self._default_bucket_key]._aux_params \
            if self._buckets else None

    @_aux_params.setter
    def _aux_params(self, value):
        pass
