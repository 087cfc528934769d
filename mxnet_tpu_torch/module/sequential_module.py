"""SequentialModule, a chain of modules each consuming the previous one's
outputs: the counterpart of ``mxnet_tpu/module/sequential_module.py``
(reference python/mxnet/module/sequential_module.py)."""
import logging
import copy

from ..initializer import Uniform
from .base_module import BaseModule

__all__ = ['SequentialModule']


class SequentialModule(BaseModule):
    """Runs constituent modules back to back: forward threads each
    module's outputs into the next one's data, backward threads input
    gradients the other way. Per-module metadata selects which layers
    see labels (``take_labels``) and whether data names are rewired to
    the next module's inputs (``auto_wiring``)."""

    META_TAKE_LABELS = 'take_labels'
    META_AUTO_WIRING = 'auto_wiring'

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None
        self._data_shapes = None
        self._meta_keys = {getattr(SequentialModule, name)
                           for name in dir(SequentialModule)
                           if name.startswith('META_')}

    def add(self, module, **kwargs):
        unknown = set(kwargs) - self._meta_keys
        if unknown:
            raise AssertionError('Unknown meta "%s", a typo?'
                                 % unknown.pop())
        self._modules.append(module)
        self._metas.append(kwargs)
        # a structural change invalidates every derived state
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    def _takes_labels(self, index):
        return bool(self._metas[index].get(self.META_TAKE_LABELS))

    # -- shapes/names delegate to the chain's ends ------------------------
    @property
    def data_names(self):
        return self._modules[0].data_names if self._modules else []

    @property
    def output_names(self):
        return self._modules[-1].output_names if self._modules else []

    @property
    def data_shapes(self):
        assert self.binded
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._modules[-1].output_shapes

    def get_params(self):
        assert self.binded and self.params_initialized
        arg_params, aux_params = {}, {}
        for module in self._modules:
            arg, aux = module.get_params()
            arg_params.update(arg)
            aux_params.update(aux)
        return arg_params, aux_params

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, 'call bind before initializing the parameters'
        for module in self._modules:
            module.init_params(initializer=initializer, arg_params=arg_params,
                               aux_params=aux_params,
                               allow_missing=allow_missing,
                               force_init=force_init, allow_extra=allow_extra)
        self._assert_unique_params()
        self.params_initialized = True

    def _assert_unique_params(self):
        """No parameter name may appear in two chained modules (arg and
        aux namespaces are independent, as in the reference)."""
        arg_owner, aux_owner = {}, {}
        for index, module in enumerate(self._modules):
            arg, aux = module.get_params()
            for owner, names in ((arg_owner, arg), (aux_owner, aux)):
                for name in names:
                    if name in owner:
                        raise AssertionError(
                            'Duplicated parameter names: name "%s" in layer '
                            '%d (%s) is already used in layer %d (%s).'
                            % (name, index, type(module), owner[name],
                               type(self._modules[owner[name]])))
                    owner[name] = index

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req='write'):
        if self.binded and not force_rebind:
            self.logger.warning('Already bound, ignoring bind()')
            return
        if inputs_need_grad:
            assert for_training
        assert shared_module is None, 'Shared module is not supported'
        assert self._modules, 'Attempting to bind an empty SequentialModule'

        self.binded = True
        self._label_shapes = label_shapes

        chained_shapes = data_shapes
        label_consumed = False
        for index, module in enumerate(self._modules):
            if self._takes_labels(index):
                label_consumed = True
            if self._metas[index].get(self.META_AUTO_WIRING, False):
                names = module.data_names
                assert len(names) == len(chained_shapes)
                chained_shapes = [
                    (name, shape)
                    for name, (_, shape) in zip(names, chained_shapes)]
            module.bind(
                data_shapes=chained_shapes,
                label_shapes=label_shapes if self._takes_labels(index)
                else None,
                for_training=for_training,
                # interior modules always need input grads to continue
                # the chain rule upstream
                inputs_need_grad=bool(inputs_need_grad or
                                      (for_training and index > 0)),
                force_rebind=force_rebind, shared_module=None,
                grad_req=grad_req)
            chained_shapes = module.output_shapes

        if not label_consumed:
            self._label_shapes = None

    def init_optimizer(self, kvstore='local', optimizer='sgd',
                       optimizer_params=(('learning_rate', 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning('optimizer already initialized, ignoring.')
            return
        for module in self._modules:
            module.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                  optimizer_params=optimizer_params,
                                  force_init=force_init)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        batch = copy.copy(data_batch)
        last = len(self._modules) - 1
        for index, module in enumerate(self._modules):
            module.forward(batch, is_train=is_train)
            if index == last:
                break
            # next module consumes this one's outputs as its data
            batch.data = module.get_outputs()
            if hasattr(batch, 'provide_data'):
                names = [name for name, _ in module.output_shapes]
                assert len(names) == len(batch.data)
                batch.provide_data = [(name, out.shape) for name, out
                                      in zip(names, batch.data)]

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        for index in range(len(self._modules) - 1, -1, -1):
            module = self._modules[index]
            module.backward(out_grads=out_grads)
            if index == 0:
                break
            out_grads = module.get_input_grads()

    def update(self):
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        for module in self._modules:
            module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._modules[-1].get_outputs(
            merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._modules[0].get_input_grads(
            merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        for index, module in enumerate(self._modules):
            if self._takes_labels(index):
                module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        assert self.binded
        for module in self._modules:
            module.install_monitor(mon)
