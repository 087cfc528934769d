"""Modules written in Python, without a graph or an executor: the
counterpart of ``mxnet_tpu/module/python_module.py`` (reference
python/mxnet/module/python_module.py:28 ``PythonModule``, a BaseModule
whose compute is NDArray code, and :240 ``PythonLossModule``, a loss
"layer" closing a chain of modules with a hand-written gradient). They run
eagerly on NDArrays: glue, not the hot path.
"""
import logging

from .base_module import BaseModule
from ..initializer import Uniform
from .. import ndarray as nd


class PythonModule(BaseModule):
    """A module whose forward/backward are written directly in python.

    Subclasses override :meth:`forward`, :meth:`backward` and (when the
    module owns parameters) :meth:`get_params` / :meth:`init_params` /
    :meth:`update`. Parameter-free modules get working defaults.
    """

    def __init__(self, data_names, label_names, output_names,
                 logger=logging):
        super().__init__(logger=logger)
        if isinstance(data_names, tuple):
            data_names = list(data_names)
        if isinstance(label_names, tuple):
            label_names = list(label_names)
        self._data_names = data_names
        self._label_names = label_names
        self._output_names = output_names
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    def get_params(self):
        """Parameter-free by default (reference python_module.py:96)."""
        return (dict(), dict())

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        self.params_initialized = True

    def update(self):
        pass

    def update_metric(self, eval_metric, labels):
        if self._label_shapes is None:
            return
        eval_metric.update(labels, self.get_outputs())

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req='write'):
        """Record shapes and compute output shapes; there is no executor
        to create (reference python_module.py:162)."""
        if self.binded and not force_rebind:
            self.logger.warning('Already bound, ignoring bind()')
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        self._output_shapes = self._compute_output_shapes()

    def _compute_output_shapes(self):
        raise NotImplementedError()

    def init_optimizer(self, kvstore='local', optimizer='sgd',
                       optimizer_params=(('learning_rate', 0.01),),
                       force_init=False):
        self.optimizer_initialized = True


class PythonLossModule(PythonModule):
    """A loss layer as a module: forward is identity on the score input,
    backward produces the hand-written gradient (reference
    python_module.py:240). ``grad_func(scores, labels) -> NDArray``
    overrides the default MakeLoss-style gradient of 1."""

    def __init__(self, name='pyloss', data_names=('data',),
                 label_names=('softmax_label',), logger=logging,
                 grad_func=None):
        super().__init__(list(data_names), list(label_names),
                         [name + '_output'], logger=logger)
        self._name = name
        if grad_func is not None and not callable(grad_func):
            raise TypeError('grad_func must be callable')
        self._grad_func = grad_func
        self._scores = None
        self._labels = None
        self._scores_grad = None

    def _compute_output_shapes(self):
        return [(self._name + '_output', self._data_shapes[0][1])]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if is_train is None:
            is_train = self.for_training
        if is_train:
            self._labels = data_batch.label[0] if data_batch.label else None

    def get_outputs(self, merge_multi_context=True):
        if not merge_multi_context:
            return [[self._scores]]
        return [self._scores]

    def backward(self, out_grads=None):
        if out_grads is not None:
            raise ValueError('PythonLossModule is a terminal loss; '
                             'out_grads is not accepted')
        if self._grad_func is not None:
            grad = self._grad_func(self._scores, self._labels)
            if not isinstance(grad, nd.NDArray):
                grad = nd.array(grad, ctx=self._scores.context)
            self._scores_grad = grad
        else:
            self._scores_grad = nd.ones_like(self._scores)

    def get_input_grads(self, merge_multi_context=True):
        if not merge_multi_context:
            return [[self._scores_grad]]
        return [self._scores_grad]

    def install_monitor(self, mon):
        raise NotImplementedError()
