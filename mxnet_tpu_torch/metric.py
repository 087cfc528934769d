"""Evaluation metrics: the counterpart of ``mxnet_tpu/metric.py``.

``create`` by name, list or callable; ``EvalMetric``,
``CompositeEvalMetric``, ``Accuracy``, ``TopKAccuracy``, ``F1``,
``Perplexity``, ``MAE``/``MSE``/``RMSE``, ``CrossEntropy``,
``NegativeLogLikelihood``, ``PearsonCorrelation``, ``Loss`` (with its
``Torch`` and ``Caffe`` names), ``CustomMetric`` and ``np``. The metrics
compute on the host in numpy, as the JAX package's do: each ``update``
reads its predictions back from the card (``asnumpy``), which waits for
the work queued there.
"""
import math

import numpy

from . import ndarray

__all__ = ['EvalMetric', 'CompositeEvalMetric', 'Accuracy', 'TopKAccuracy',
           'Torch', 'Caffe',
           'F1', 'Perplexity', 'MAE', 'MSE', 'RMSE', 'CrossEntropy', 'Loss',
           'PearsonCorrelation', 'CustomMetric', 'np', 'create', 'check_label_shapes']

_REGISTRY = {}


def register(name=None):
    def deco(klass):
        _REGISTRY[(name or klass.__name__).lower()] = klass
        return klass
    return deco


def create(metric, *args, **kwargs):
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    if isinstance(metric, str):
        return _REGISTRY[metric.lower()](*args, **kwargs)
    raise TypeError('metric should be string, callable, or EvalMetric')


def check_label_shapes(labels, preds, shape=0):
    if shape == 0:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError('Shape of labels {} does not match shape of '
                         'predictions {}'.format(label_shape, pred_shape))


class EvalMetric:
    """A metric: ``update`` adds to ``sum_metric`` and ``num_inst``,
    ``get`` returns their ratio."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return 'EvalMetric: {}'.format(dict(self.get_name_value()))

    def get_config(self):
        config = self._kwargs.copy()
        config.update({'metric': self.__class__.__name__, 'name': self.name,
                       'output_names': self.output_names,
                       'label_names': self.label_names})
        return config

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float('nan'))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name='composite', output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, 'metrics', []):
            metric.reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            names.append(name) if not isinstance(name, list) else names.extend(name)
            values.append(value) if not isinstance(value, list) else values.extend(value)
        return (names, values)


@register()
@register('acc')
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name='accuracy', output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, axis=axis)
        self.axis = axis

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            p = pred_label.asnumpy()
            if p.ndim > 1 and p.shape[-1 if self.axis == 1 and p.ndim == 2 else self.axis] > 1:
                p = numpy.argmax(p, axis=self.axis if p.ndim > self.axis else -1)
            lab = label.asnumpy().astype('int32').ravel()
            p = p.astype('int32').ravel()
            check_label_shapes(lab, p, shape=1)
            self.sum_metric += (p == lab).sum()
            self.num_inst += len(p)


@register('top_k_accuracy')
@register('top_k_acc')
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name='top_k_accuracy', output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, top_k=top_k)
        self.top_k = top_k
        assert self.top_k > 1, 'Please use Accuracy if top_k is no more than 1'
        self.name += '_%d' % self.top_k

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            assert len(pred_label.shape) <= 2, 'Predictions should be no more than 2 dims'
            pred = numpy.argsort(pred_label.asnumpy().astype('float32'), axis=1)
            lab = label.asnumpy().astype('int32')
            num_samples = pred.shape[0]
            num_dims = len(pred.shape)
            if num_dims == 1:
                self.sum_metric += (pred.ravel() == lab.ravel()).sum()
            elif num_dims == 2:
                num_classes = pred.shape[1]
                top_k = min(num_classes, self.top_k)
                for j in range(top_k):
                    self.sum_metric += (pred[:, num_classes - 1 - j].ravel() ==
                                        lab.ravel()).sum()
            self.num_inst += num_samples


@register()
class F1(EvalMetric):
    def __init__(self, name='f1', output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = pred.asnumpy()
            label = label.asnumpy().astype('int32')
            pred_label = numpy.argmax(pred, axis=1)
            check_label_shapes(label, pred_label, shape=1)
            if len(numpy.unique(label)) > 2:
                raise ValueError('F1 currently only supports binary classification.')
            tp = ((pred_label == 1) & (label == 1)).sum()
            fp = ((pred_label == 1) & (label == 0)).sum()
            fn = ((pred_label == 0) & (label == 1)).sum()
            precision = tp / (tp + fp) if tp + fp > 0 else 0.
            recall = tp / (tp + fn) if tp + fn > 0 else 0.
            f1 = 2 * precision * recall / (precision + recall) \
                if precision + recall > 0 else 0.
            self.sum_metric += f1
            self.num_inst += 1


@register()
class Perplexity(EvalMetric):
    """exp of the mean negative log of the picked probabilities, with
    ``ignore_label`` left out of the count."""

    def __init__(self, ignore_label=None, axis=-1, name='perplexity',
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names,
                         ignore_label=ignore_label, axis=axis)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        assert len(labels) == len(preds)
        loss = 0.
        num = 0
        for label, pred in zip(labels, preds):
            assert label.size == pred.size / pred.shape[-1], \
                'shape mismatch: %s vs. %s' % (label.shape, pred.shape)
            label = label.as_in_context(pred.context).reshape((label.size,))
            pred = ndarray.pick(pred, label.astype(dtype='int32'), axis=self.axis)
            lab_np = label.asnumpy()
            pred_np = pred.asnumpy()
            if self.ignore_label is not None:
                ignore = (lab_np == self.ignore_label)
                num -= int(ignore.sum())
                pred_np = pred_np * (1 - ignore) + ignore
            loss -= numpy.sum(numpy.log(numpy.maximum(1e-10, pred_np)))
            num += pred_np.size
        self.sum_metric += loss
        self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float('nan'))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register()
class MAE(EvalMetric):
    def __init__(self, name='mae', output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = label.asnumpy()
            pred = pred.asnumpy()
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += numpy.abs(label - pred).mean()
            self.num_inst += 1


@register()
class MSE(EvalMetric):
    def __init__(self, name='mse', output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = label.asnumpy()
            pred = pred.asnumpy()
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += ((label - pred) ** 2.0).mean()
            self.num_inst += 1


@register()
class RMSE(EvalMetric):
    def __init__(self, name='rmse', output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = label.asnumpy()
            pred = pred.asnumpy()
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += numpy.sqrt(((label - pred) ** 2.0).mean())
            self.num_inst += 1


@register('ce')
@register()
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name='cross-entropy', output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = label.asnumpy()
            pred = pred.asnumpy()
            label = label.ravel()
            assert label.shape[0] == pred.shape[0]
            prob = pred[numpy.arange(label.shape[0]), numpy.int64(label)]
            self.sum_metric += (-numpy.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]


@register('nll_loss')
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name='nll-loss', output_names=None,
                 label_names=None):
        super().__init__(eps=eps, name=name, output_names=output_names,
                         label_names=label_names)


@register('pearsonr')
class PearsonCorrelation(EvalMetric):
    def __init__(self, name='pearsonr', output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            check_label_shapes(label, pred, 1)
            label = label.asnumpy()
            pred = pred.asnumpy()
            self.sum_metric += numpy.corrcoef(pred.ravel(), label.ravel())[0, 1]
            self.num_inst += 1


@register()
class Loss(EvalMetric):
    """Dummy metric for directly printing loss."""

    def __init__(self, name='loss', output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        for pred in preds:
            self.sum_metric += pred.asnumpy().sum()
            self.num_inst += pred.size


@register()
class Torch(Loss):
    """Dummy metric for torch criterions."""

    def __init__(self, name='torch', output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register()
class Caffe(Loss):
    """Dummy metric for caffe criterions."""

    def __init__(self, name='caffe', output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


class CustomMetric(EvalMetric):
    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if name.find('<') != -1:
                name = 'custom(%s)' % name
        super().__init__(name, output_names, label_names, feval=feval,
                         allow_extra_outputs=allow_extra_outputs)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for pred, label in zip(preds, labels):
            label = label.asnumpy()
            pred = pred.asnumpy()
            reval = self._feval(label, pred)
            if isinstance(reval, tuple):
                sum_metric, num_inst = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Adapter from a numpy feval to CustomMetric."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)
