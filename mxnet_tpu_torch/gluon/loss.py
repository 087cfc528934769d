"""Gluon losses: the counterpart of ``mxnet_tpu/gluon/loss.py`` (the Loss
base, L2Loss, L1Loss, SigmoidBinaryCrossEntropyLoss,
SoftmaxCrossEntropyLoss, KLDivLoss and CTCLoss), HybridBlocks over the
registry's ops. Each returns the loss of each sample: the mean over every
axis but the batch axis; CTCLoss the loss of each sequence, through
``F.contrib.CTCLoss`` (:mod:`..ops.contrib_ops`).
"""
from .block import HybridBlock

__all__ = ['Loss', 'L2Loss', 'L1Loss', 'SigmoidBinaryCrossEntropyLoss',
           'SigmoidBCELoss', 'SoftmaxCrossEntropyLoss', 'SoftmaxCELoss',
           'KLDivLoss', 'CTCLoss']


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    """``loss`` times ``sample_weight`` (broadcast) and ``weight``."""
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    if weight is not None:
        assert isinstance(weight, (float, int)), 'weight must be a number'
        loss = loss * weight
    return loss


def _reshape_label_as_output(F, output, label):
    return F.reshape_like(label, output)


class Loss(HybridBlock):
    """The base: a weight and the batch axis."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        s = '{name}(batch_axis={_batch_axis}, w={_weight})'
        return s.format(name=self.__class__.__name__, **self.__dict__)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError()


class L2Loss(Loss):
    """0.5 * (output - label)^2 times the weight."""

    def __init__(self, weight=1., batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, output, label, sample_weight=None):
        label = _reshape_label_as_output(F, output, label)
        loss = F.square(output - label)
        loss = _apply_weighting(F, loss, self._weight / 2, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class L1Loss(Loss):
    """|output - label| times the weight."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, output, label, sample_weight=None):
        label = _reshape_label_as_output(F, output, label)
        loss = F.abs(output - label)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy of logits (in the stable form) or, with
    ``from_sigmoid``, of probabilities."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, output, label, sample_weight=None):
        label = _reshape_label_as_output(F, output, label)
        if not self._from_sigmoid:
            max_val = F.relu(-output)
            loss = output - output * label + max_val + \
                F.log(F.exp(-max_val) + F.exp(-output - max_val))
        else:
            loss = -(F.log(output + 1e-12) * label +
                     F.log(1. - output + 1e-12) * (1. - label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """Cross-entropy of log_softmax(output) (or of log-probabilities with
    ``from_logits``) against class indices (``sparse_label``) or a
    distribution."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, output, label, sample_weight=None):
        if not self._from_logits:
            output = F.log_softmax(output, axis=self._axis)
        if self._sparse_label:
            loss = -F.pick(output, label, axis=self._axis, keepdims=True)
        else:
            loss = -F.sum(output * label, axis=self._axis, keepdims=True)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """KL divergence of ``label`` from the log-probabilities ``output``."""

    def __init__(self, from_logits=True, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits

    def hybrid_forward(self, F, output, label, sample_weight=None):
        if not self._from_logits:
            output = F.log_softmax(output)
        loss = label * (F.log(label + 1e-12) - output)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class CTCLoss(Loss):
    """Connectionist Temporal Classification loss (reference loss.py:302).

    ``data`` is an unsoftmaxed activation tensor (``layout`` 'NTC' or
    'TNC'); ``label`` an index matrix ('NT' or 'TN'). With
    ``blank_label='first'`` (the contrib op default) index 0 is the
    blank, so label values are 1..alphabet_size-1. Label lengths come
    from ``label_lengths`` or the first occurrence of ``padding_mask``.
    Output shape (batch_size,).
    """

    def __init__(self, layout='NTC', label_layout='NT', padding_mask=-1,
                 weight=None, **kwargs):
        assert layout in ('NTC', 'TNC'), layout
        assert label_layout in ('NT', 'TN'), label_layout
        self._layout = layout
        self._label_layout = label_layout
        self._padding_mask = padding_mask
        batch_axis = label_layout.find('N')
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, data, label,
                       data_lengths=None, label_lengths=None,
                       sample_weight=None):
        if self._layout == 'NTC':
            data = F.swapaxes(data, 0, 1)
        if self._batch_axis == 1:
            label = F.swapaxes(label, 0, 1)
        kwargs = {'use_data_lengths': data_lengths is not None,
                  'use_label_lengths': label_lengths is not None}
        if self._padding_mask is not None:
            kwargs['padding_mask'] = self._padding_mask
        inputs = [data, label] + \
            [x for x in (data_lengths, label_lengths) if x is not None]
        loss = F.contrib.CTCLoss(*inputs, **kwargs)
        return _apply_weighting(F, loss, self._weight, sample_weight)
