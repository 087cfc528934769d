"""The legacy executor manager: the counterpart of
``mxnet_tpu/executor_manager.py`` (MXNet's python/mxnet/executor_manager.py),
a thin layer over the module's DataParallelExecutorGroup for old scripts;
new code uses Module."""
import logging

from .io import DataDesc
from .module.executor_group import DataParallelExecutorGroup

__all__ = ['DataParallelExecutorManager', '_split_input_slice']


def _split_input_slice(batch_size, work_load_list):
    """The batch split into one slice a device, by workload."""
    total_work_load = sum(work_load_list)
    batch_num_list = [round(work_load * batch_size / total_work_load)
                      for work_load in work_load_list]
    batch_num_sum = sum(batch_num_list)
    if batch_num_sum < batch_size:
        batch_num_list[-1] += batch_size - batch_num_sum
    slices = []
    end = 0
    for batch_num in batch_num_list:
        begin = int(min(end, batch_size))
        end = int(min(begin + batch_num, batch_size))
        if begin >= end:
            raise ValueError('Too many slices. Some splits are empty.')
        slices.append(slice(begin, end))
    return slices


class DataParallelExecutorManager:
    """The executors of a symbol over ``ctx``, bound for ``train_data``'s
    shapes, in training."""

    def __init__(self, symbol, ctx, train_data, arg_names, param_names,
                 aux_names, work_load_list=None, logger=None, sym_gen=None):
        self.arg_names = arg_names
        self.param_names = param_names
        self.aux_names = aux_names
        self.ctx = ctx
        self.logger = logger or logging
        data_shapes = [DataDesc(name, shape) for name, shape in
                       train_data.provide_data]
        label_shapes = [DataDesc(name, shape) for name, shape in
                        train_data.provide_label]
        self.execgrp = DataParallelExecutorGroup(
            symbol, ctx, work_load_list, data_shapes, label_shapes,
            param_names, for_training=True, inputs_need_grad=False)
        self.symbol = symbol
        self.sym_gen = sym_gen
        self._cur_batch = None

    def install_monitor(self, monitor):
        self.execgrp.install_monitor(monitor)

    def set_params(self, arg_params, aux_params):
        self.execgrp.set_params(arg_params, aux_params)

    def copy_to(self, arg_params, aux_params):
        self.execgrp.get_params(arg_params, aux_params)

    @property
    def param_arrays(self):
        return self.execgrp.param_arrays

    @property
    def grad_arrays(self):
        return self.execgrp.grad_arrays

    @property
    def aux_arrays(self):
        return self.execgrp.aux_arrays

    def load_data_batch(self, data_batch):
        self._cur_batch = data_batch

    def forward(self, is_train=False):
        self.execgrp.forward(self._cur_batch, is_train=is_train)

    def backward(self):
        self.execgrp.backward()

    def update_metric(self, metric, labels):
        self.execgrp.update_metric(metric, labels)
