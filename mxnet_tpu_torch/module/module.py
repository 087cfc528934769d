"""Module, a symbol bound over its contexts by a DataParallelExecutorGroup:
the counterpart of ``mxnet_tpu/module/module.py``.

``bind``, ``init_params``, ``set_params``/``get_params``,
``init_optimizer`` (``rescale_grad = 1 / batch_size``; with one device a
'local' or 'device' kvstore gives no store, so the updates run through
``model._update_params`` with the optimizer's updater, as in the JAX
package), ``forward`` (rebinding on a new batch shape), ``backward``,
``update``, ``update_metric``, ``reshape``, ``borrow_optimizer``,
``save_checkpoint``/``load`` and the optimizer states' save and load.

One deliberate difference from the JAX package: without a ``context`` a
Module runs on :func:`..context.current_context`, the card (``gpu(0)``),
where the JAX package's defaults to ``cpu()``. ``install_monitor`` hooks a
Monitor into every executor (``Executor.set_monitor_callback``); the fused
windows then decline the module and ``fit`` takes the per-batch loop.
"""
import logging
import warnings

from .. import context as ctx_mod
from .. import optimizer as opt
from .. import telemetry as _tele
from ..initializer import Uniform, InitDesc
from ..model import (_create_kvstore, _initialize_kvstore, _update_params,
                     _update_params_on_kvstore, load_checkpoint)
from .base_module import BaseModule, _check_input_names, _parse_data_desc
from .executor_group import DataParallelExecutorGroup

__all__ = ['Module']


class Module(BaseModule):
    def __init__(self, symbol, data_names=('data',),
                 label_names=('softmax_label',), logger=logging, context=None,
                 work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        if context is None:
            context = ctx_mod.current_context()
        if isinstance(context, ctx_mod.Context):
            context = [context]
        self._context = context
        if work_load_list is None:
            work_load_list = [1] * len(self._context)
        assert len(work_load_list) == len(self._context)
        self._work_load_list = work_load_list

        self._symbol = symbol

        data_names = list(data_names) if data_names is not None else []
        label_names = list(label_names) if label_names is not None else []
        state_names = list(state_names) if state_names is not None else []
        fixed_param_names = list(fixed_param_names) \
            if fixed_param_names is not None else []

        _check_input_names(symbol, data_names, 'data', True)
        _check_input_names(symbol, label_names, 'label', False)
        _check_input_names(symbol, state_names, 'state', True)
        _check_input_names(symbol, fixed_param_names, 'fixed_param', True)

        arg_names = symbol.list_arguments()
        input_names = data_names + label_names + state_names
        self._param_names = [x for x in arg_names if x not in input_names]
        self._fixed_param_names = fixed_param_names
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._state_names = state_names
        self._output_names = symbol.list_outputs()

        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False

        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = None
        self._updater = None
        self._preload_opt_states = None
        self._grad_req = None

        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module of the checkpoint ``prefix``/``epoch``; its parameters
        are set at ``bind``."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = '%s-%04d.states' % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        self._symbol.save('%s-symbol.json' % prefix)
        param_name = '%s-%04d.params' % (prefix, epoch)
        self.save_params(param_name)
        logging.info('Saved checkpoint to "%s"', param_name)
        if save_optimizer_states:
            state_name = '%s-%04d.states' % (prefix, epoch)
            self.save_optimizer_states(state_name)
            logging.info('Saved optimizer state to "%s"', state_name)

    def _reset_bind(self):
        self.binded = False
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None

    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._exec_group.get_output_shapes()

    def get_params(self):
        assert self.binded and self.params_initialized
        if self._params_dirty:
            self._sync_params_from_devices()
        return (self._arg_params, self._aux_params)

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            warnings.warn('Parameters already initialized and force_init=False. '
                          'init_params call ignored.', stacklevel=2)
            return
        assert self.binded, 'call bind before initializing the parameters'

        def _impl(name, arr, cache):
            if cache is not None:
                if name in cache:
                    cache_arr = cache[name]
                    if cache_arr is not arr:
                        cache_arr.copyto(arr)
                else:
                    if not allow_missing:
                        raise RuntimeError('%s is not presented' % name)
                    if initializer is not None:
                        initializer(name, arr)
            else:
                if initializer is not None:
                    initializer(name, arr)

        attrs = self._symbol.attr_dict()
        for name, arr in sorted(self._arg_params.items()):
            desc = InitDesc(name, attrs.get(name, None))
            _impl(desc, arr, arg_params)
        for name, arr in sorted(self._aux_params.items()):
            desc = InitDesc(name, attrs.get(name, None))
            _impl(desc, arr, aux_params)

        self.params_initialized = True
        self._params_dirty = False
        self._exec_group.set_params(self._arg_params, self._aux_params)

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params, allow_missing=allow_missing,
                             force_init=force_init, allow_extra=allow_extra)
            return
        if self.params_initialized and not force_init:
            warnings.warn('Parameters already initialized and force_init=False. '
                          'set_params call ignored.', stacklevel=2)
            return
        self._exec_group.set_params(arg_params, aux_params,
                                    allow_extra=allow_extra)
        self._params_dirty = True
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req='write'):
        """Bind an executor group for these input shapes; parameters given
        before (``Module.load``, ``set_params``) are copied in."""
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning('Already bound, ignoring bind()')
            return

        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._grad_req = grad_req

        if not for_training:
            assert not inputs_need_grad

        self._data_shapes, self._label_shapes = _parse_data_desc(
            self.data_names, self.label_names, data_shapes, label_shapes)

        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list,
            self._data_shapes, self._label_shapes, self._param_names,
            for_training, inputs_need_grad, None, logger=self.logger,
            fixed_param_names=self._fixed_param_names, grad_req=grad_req,
            state_names=self._state_names)

        if shared_module is not None:
            self.params_initialized = True
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
        elif self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)
        else:
            assert self._arg_params is None and self._aux_params is None
            self._arg_params = {name: arrs[0].copy() for name, arrs in
                                zip(self._exec_group.param_names,
                                    self._exec_group.param_arrays)}
            self._aux_params = {name: arrs[0].copy() for name, arrs in
                                zip(self._exec_group.aux_names,
                                    self._exec_group.aux_arrays)}

        if shared_module is not None and shared_module.optimizer_initialized:
            self.borrow_optimizer(shared_module)

    def reshape(self, data_shapes, label_shapes=None):
        assert self.binded
        self._data_shapes, self._label_shapes = _parse_data_desc(
            self.data_names, self.label_names, data_shapes, label_shapes)
        self._exec_group.reshape(self._data_shapes, self._label_shapes)
        self._exec_group.set_params(self._arg_params, self._aux_params)

    def init_optimizer(self, kvstore='local', optimizer='sgd',
                       optimizer_params=(('learning_rate', 0.01),),
                       force_init=False):
        """The optimizer (``rescale_grad = 1 / batch_size`` unless given),
        the kvstore if one is warranted, and the updater."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning('optimizer already initialized, ignoring...')
            return
        if self._params_dirty:
            self._sync_params_from_devices()

        (kvstore, update_on_kvstore) = _create_kvstore(
            kvstore, len(self._context), self._arg_params)

        batch_size = self._exec_group.batch_size
        if kvstore and 'dist' in kvstore.type and '_sync' in kvstore.type:
            batch_size *= kvstore.num_workers
        rescale_grad = 1.0 / batch_size

        if isinstance(optimizer, str):
            # the updater keys run i * n_exec + k over the executors
            n_exec = len(self._exec_group.execs)
            idx2name = {}
            if update_on_kvstore:
                idx2name.update(enumerate(self._exec_group.param_names))
            else:
                for k in range(n_exec):
                    idx2name.update({i * n_exec + k: n
                                     for i, n in enumerate(self._exec_group.param_names)})
            optimizer_params = dict(optimizer_params)
            if 'rescale_grad' not in optimizer_params:
                optimizer_params['rescale_grad'] = rescale_grad
            optimizer = opt.create(optimizer, sym=self.symbol,
                                   param_idx2name=idx2name, **optimizer_params)
        else:
            assert isinstance(optimizer, opt.Optimizer)
            if optimizer.rescale_grad != rescale_grad:
                warnings.warn(
                    'Optimizer created manually outside Module but rescale_grad '
                    'is not normalized to 1.0/batch_size/num_workers (%s vs. %s). '
                    'Is this intended?' % (optimizer.rescale_grad, rescale_grad),
                    stacklevel=2)

        self._optimizer = optimizer
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._updater = None

        if kvstore:
            if update_on_kvstore:
                kvstore.set_optimizer(self._optimizer)
            _initialize_kvstore(kvstore=kvstore,
                                param_arrays=self._exec_group.param_arrays,
                                arg_params=self._arg_params,
                                param_names=self._param_names,
                                update_on_kvstore=update_on_kvstore)
        if not update_on_kvstore:
            self._updater = opt.get_updater(optimizer)

        self.optimizer_initialized = True

        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def borrow_optimizer(self, shared_module):
        assert shared_module.optimizer_initialized
        self._optimizer = shared_module._optimizer
        self._kvstore = shared_module._kvstore
        self._update_on_kvstore = shared_module._update_on_kvstore
        self._updater = shared_module._updater
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        """Forward a batch; a batch of another shape rebinds first."""
        assert self.binded and self.params_initialized
        curr_data_shapes = tuple(i.shape for i in self._data_shapes)
        new_data_shapes = tuple(i.shape for i in data_batch.data)
        if curr_data_shapes != new_data_shapes:
            def _redesc(desc, shape):
                # keep the layout and dtype
                new = type(desc)(desc.name, shape,
                                 layout=getattr(desc, 'layout', 'NCHW'))
                if hasattr(desc, 'dtype'):
                    new.dtype = desc.dtype
                return new
            if hasattr(data_batch, 'provide_data') and data_batch.provide_data:
                new_dshape = data_batch.provide_data
            else:
                new_dshape = [_redesc(i, shape) for i, shape in
                              zip(self._data_shapes, new_data_shapes)]
            if hasattr(data_batch, 'provide_label') and data_batch.provide_label:
                new_lshape = data_batch.provide_label
            elif hasattr(data_batch, 'label') and data_batch.label:
                new_lshape = [_redesc(i, j.shape) for i, j in
                              zip(self._label_shapes, data_batch.label)]
            else:
                new_lshape = None
            self.reshape(new_dshape, new_lshape)
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """One optimizer step over the gradients of the last backward."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        with _tele.span('module.update', 'executor'):
            if self._update_on_kvstore:
                _update_params_on_kvstore(self._exec_group.param_arrays,
                                          self._exec_group.grad_arrays,
                                          self._kvstore,
                                          self._exec_group.param_names)
            else:
                _update_params(self._exec_group.param_arrays,
                               self._exec_group.grad_arrays,
                               updater=self._updater,
                               num_device=len(self._exec_group.execs),
                               kvstore=self._kvstore,
                               param_names=self._exec_group.param_names)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec_group.get_outputs(
            merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._exec_group.get_input_grads(
            merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._exec_group.update_metric(eval_metric, labels)

    def _sync_params_from_devices(self):
        self._exec_group.get_params(self._arg_params, self._aux_params)
        self._params_dirty = False

    def save_optimizer_states(self, fname):
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
        else:
            with open(fname, 'wb') as fout:
                fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
        else:
            with open(fname, 'rb') as fin:
                self._updater.set_states(fin.read())

    def install_monitor(self, mon):
        assert self.binded
        self._exec_group.install_monitor(mon)
