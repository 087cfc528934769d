"""DataParallelExecutorGroup, the executors behind a Module: the counterpart
of ``DataParallelExecutorGroup`` in ``mxnet_tpu/module/executor_group.py``.

The batch is split over the contexts by their workloads
(:meth:`DataParallelExecutorGroup.decide_slices`), one executor is
``simple_bind``'ed on each context for its slice, and forward, backward,
the outputs, the input gradients and ``update_metric`` fan out over them.

Each batch is copied from the host into the bound arrays on the card
(:func:`_load_general`). As in the JAX package, a bound array takes the
batch's dtype: an f32 batch stays f32 where the symbol bound bf16, and
integer labels stay integers.

The JAX package's ``SPMDExecutorGroup`` (one program over a jax mesh of
the contexts) is not ported (ROADMAP.md §1 item 11); Module takes this
group on one card.
"""
import logging

import numpy as np

from .. import ndarray as nd
from .. import telemetry as _tele
from ..io import DataDesc

__all__ = ['DataParallelExecutorGroup']


def _load_general(data, targets, major_axis):
    """Copy each batch array into its targets: a bound NDArray, or a list
    of ``(slice, bound NDArray)`` that takes the slice along the array's
    batch axis (``major_axis``, from its DataDesc layout; -1: no batch
    axis, the whole array). A sparse batch array is densified first."""
    for d_src, d_targets, axis in zip(data, targets, major_axis):
        if isinstance(d_targets, nd.NDArray):
            d_src.copyto(d_targets)
            continue
        if isinstance(d_src, nd.sparse.BaseSparseNDArray):
            # a sparse batch (LibSVMIter's CSR) is lowered to dense on its
            # own device, the card for an iterator on the card
            d_src = d_src.tostype('default')
        src = d_src._data.detach()
        for slice_idx, d_dst in d_targets:
            part = src
            if axis >= 0:
                part = src.narrow(axis, slice_idx.start,
                                  slice_idx.stop - slice_idx.start)
            if tuple(part.shape) != tuple(d_dst.shape):
                raise ValueError(
                    'batch slice has shape %s but the bound buffer is %s '
                    '(batch axis %d)' % (tuple(part.shape),
                                         tuple(d_dst.shape), axis))
            d_dst._data = part.to(d_dst.context.torch_device(), copy=True)


def _merge_multi_context(outputs, major_axis):
    """Join each output's per-device parts along its batch axis."""
    rets = []
    for tensors, axis in zip(outputs, major_axis):
        if axis >= 0 and len(tensors) > 1:
            rets.append(nd.concatenate(tensors, axis=axis))
        else:
            rets.append(tensors[0])
    return rets


def _output_layouts(symbol):
    """Each output's batch axis, from its ``__layout__`` attr; -1 means
    none."""
    return [DataDesc.get_batch_axis(symbol[name].attr('__layout__'))
            for name in symbol.list_outputs()]


def _check_label_args(label_shapes, arg_dict, symbol):
    """A label that is not an argument of the symbol raises, with the
    symbol's arguments."""
    for d in label_shapes:
        name = d.name if isinstance(d, DataDesc) else d[0]
        if name not in arg_dict:
            raise ValueError(
                "label '%s' is not an argument of the symbol (arguments:"
                ' %s) — pass matching label_names to Module or rename '
                'the iterator label' % (name, symbol.list_arguments()))


def _desc(d):
    return (d.name, d.shape) if isinstance(d, DataDesc) else tuple(d)


class DataParallelExecutorGroup:
    """One executor a context, each over its slice of the batch."""

    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=logging, fixed_param_names=None,
                 grad_req='write', state_names=None):
        self.param_names = param_names
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.symbol = symbol
        self.contexts = contexts
        self.workload = workload or [1] * len(contexts)
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.fixed_param_names = fixed_param_names or []
        self.state_names = state_names or []
        self.logger = logger

        if grad_req != 'null' and for_training:
            data_names = [_desc(d)[0] for d in data_shapes]
            self.grad_req = {}
            for k in self.arg_names:
                if k in self.param_names:
                    self.grad_req[k] = 'null' if k in self.fixed_param_names \
                        else grad_req
                elif k in data_names:
                    self.grad_req[k] = grad_req if inputs_need_grad else 'null'
                else:
                    self.grad_req[k] = 'null'
        else:
            self.grad_req = {k: 'null' for k in self.arg_names}

        self.execs = []
        self.slices = None
        self.data_shapes = None
        self.label_shapes = None
        self.data_layouts = None
        self.label_layouts = None
        self.output_layouts = _output_layouts(symbol)
        self.batch_size = None

        self.bind_exec(data_shapes, label_shapes, shared_group)

    def decide_slices(self, data_shapes):
        """Split the batch over the contexts by workload; returns each
        input's batch axis."""
        assert len(data_shapes) > 0
        major_axis = [DataDesc.get_batch_axis(getattr(d, 'layout', 'NCHW'))
                      for d in data_shapes]
        if len(self.contexts) > 1 and any(a > 0 for a in major_axis):
            raise NotImplementedError(
                'multi-device per-context execution with a non-leading '
                'batch axis (layouts %s) is not supported; use batch-major '
                'layouts' % [getattr(d, 'layout', 'NCHW')
                             for d in data_shapes])
        for (name, shape), axis in zip([_desc(d) for d in data_shapes],
                                       major_axis):
            if axis == -1:
                continue
            batch_size = shape[axis]
            if self.batch_size is not None:
                assert batch_size == self.batch_size, \
                    ('all data must have the same batch size: batch_size = %d,'
                     ' but %s has shape %s') % (self.batch_size, name, shape)
            else:
                self.batch_size = batch_size
                total = sum(self.workload[:len(self.contexts)])
                chunks = [self.batch_size * w // total for w in
                          self.workload[:len(self.contexts)]]
                rem = self.batch_size - sum(chunks)
                for i in range(rem):
                    chunks[i] += 1
                starts = np.cumsum([0] + chunks)
                self.slices = [slice(int(starts[i]), int(starts[i + 1]))
                               for i in range(len(self.contexts))]
        return major_axis

    def _sliced_shape(self, shapes, i, major_axis):
        sliced = []
        for (name, shape), axis in zip([_desc(d) for d in shapes], major_axis):
            shape = list(shape)
            if axis >= 0:
                shape[axis] = self.slices[i].stop - self.slices[i].start
            sliced.append(DataDesc(name, tuple(shape)))
        return sliced

    def bind_exec(self, data_shapes, label_shapes, shared_group=None,
                  reshape=False):
        self.data_layouts = self.decide_slices(data_shapes)
        if label_shapes is not None and len(label_shapes) > 0:
            self.label_layouts = self.decide_slices(label_shapes)
        self.data_shapes = data_shapes
        self.label_shapes = label_shapes
        self.execs = [self._bind_ith_exec(i, data_shapes, label_shapes,
                                          shared_group)
                      for i in range(len(self.contexts))]

        self.data_arrays = [[(self.slices[i], e.arg_dict[name])
                             for i, e in enumerate(self.execs)]
                            for name, _ in [_desc(d) for d in data_shapes]]
        if label_shapes is not None and len(label_shapes) > 0:
            _check_label_args(label_shapes, self.execs[0].arg_dict,
                              self.symbol)
            self.label_arrays = [[(self.slices[i], e.arg_dict[name])
                                  for i, e in enumerate(self.execs)]
                                 for name, _ in [_desc(d) for d in label_shapes]]
        else:
            self.label_arrays = None

        self.param_arrays = [[e.arg_dict[name] for e in self.execs]
                             for name in self.param_names]
        if self.for_training:
            self.grad_arrays = [[e.grad_dict.get(name) for e in self.execs]
                                for name in self.param_names]
        else:
            self.grad_arrays = [[None] * len(self.execs)
                                for _ in self.param_names]
        data_names = [_desc(d)[0] for d in data_shapes]
        if self.inputs_need_grad:
            self.input_grad_arrays = [[e.grad_dict[name] for e in self.execs]
                                      for name in data_names]
        self.aux_arrays = [[e.aux_dict[name] for e in self.execs]
                           for name in self.aux_names]

    def _bind_ith_exec(self, i, data_shapes, label_shapes, shared_group):
        """``simple_bind`` on context i for its slice of the inputs."""
        shapes = self._sliced_shape(data_shapes, i, self.data_layouts)
        if label_shapes is not None and len(label_shapes) > 0:
            shapes = shapes + self._sliced_shape(label_shapes, i,
                                                 self.label_layouts)
        input_shapes = {d.name: d.shape for d in shapes}
        return self.symbol.simple_bind(self.contexts[i],
                                       grad_req=self.grad_req,
                                       **input_shapes)

    def reshape(self, data_shapes, label_shapes):
        if data_shapes == self.data_shapes and label_shapes == self.label_shapes:
            return
        self.batch_size = None
        self.bind_exec(data_shapes, label_shapes, reshape=True)

    def set_params(self, arg_params, aux_params, allow_extra=False):
        for e in self.execs:
            e.copy_params_from(arg_params, aux_params,
                               allow_extra_params=allow_extra)

    def get_params(self, arg_params, aux_params):
        """The first device's parameters and aux states into the given
        arrays, each on its own array's device (the host's after
        ``Module.load``; the same tensor where the devices agree)."""
        for names, blocks, dst in ((self.param_names, self.param_arrays,
                                    arg_params),
                                   (self.aux_names, self.aux_arrays,
                                    aux_params)):
            for name, block in zip(names, blocks):
                dst[name]._data = block[0]._data.to(dst[name]._data.device)

    def forward(self, data_batch, is_train=None):
        with _tele.span('exec_group.forward', 'executor'):
            _load_general(data_batch.data, self.data_arrays,
                          self.data_layouts)
            if is_train is None:
                is_train = self.for_training
            if self.label_arrays is not None and data_batch.label:
                _load_general(data_batch.label, self.label_arrays,
                              self.label_layouts)
            for e in self.execs:
                e.forward(is_train=is_train)

    def get_output_shapes(self):
        outputs = self.execs[0].outputs
        shapes = [out.shape for out in outputs]
        concat_shapes = []
        for key, the_shape, axis in zip(self.symbol.list_outputs(), shapes,
                                        self.output_layouts):
            the_shape = list(the_shape)
            if axis >= 0:
                the_shape[axis] = self.batch_size
            concat_shapes.append((key, tuple(the_shape)))
        return concat_shapes

    def get_outputs(self, merge_multi_context=True):
        outputs = [[exec_.outputs[i] for exec_ in self.execs]
                   for i in range(len(self.execs[0].outputs))]
        if merge_multi_context:
            outputs = _merge_multi_context(outputs, self.output_layouts)
        return outputs

    def get_input_grads(self, merge_multi_context=True):
        assert self.inputs_need_grad
        if merge_multi_context:
            return _merge_multi_context(self.input_grad_arrays,
                                        self.data_layouts)
        return self.input_grad_arrays

    def backward(self, out_grads=None):
        assert self.for_training, 're-bind with for_training=True to run backward'
        with _tele.span('exec_group.backward', 'executor'):
            self._backward_impl(out_grads)

    def _backward_impl(self, out_grads):
        for i, exec_ in enumerate(self.execs):
            out_grads_slice = None
            if out_grads is not None:
                out_grads_slice = []
                for grad, axis in zip(out_grads, self.output_layouts):
                    if axis >= 0:
                        # the head gradient's slice along the output's
                        # batch axis
                        idx = [slice(None)] * len(grad.shape)
                        idx[axis] = self.slices[i]
                        og = grad[tuple(idx)].as_in_context(self.contexts[i])
                    else:
                        og = grad.as_in_context(self.contexts[i])
                    out_grads_slice.append(og)
            exec_.backward(out_grads=out_grads_slice)

    def update_metric(self, eval_metric, labels):
        axes = self.label_layouts if self.label_layouts is not None \
            else [0] * len(labels)
        for texec, islice in zip(self.execs, self.slices):
            labels_slice = []
            for label, axis in zip(labels, axes):
                # the slice along the label's batch axis
                if axis < 0 or \
                        islice.stop - islice.start == label.shape[axis]:
                    labels_slice.append(label)
                else:
                    idx = [slice(None)] * len(label.shape)
                    idx[axis] = islice
                    labels_slice.append(label[tuple(idx)])
            eval_metric.update(labels_slice, texec.outputs)

    def install_monitor(self, mon):
        for e in self.execs:
            mon.install(e)
