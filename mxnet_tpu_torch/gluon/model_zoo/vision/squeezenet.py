"""SqueezeNet 1.0 and 1.1: the counterpart of
``mxnet_tpu/gluon/model_zoo/vision/squeezenet.py``, one table row a version
(the stem, then fire modules' squeeze widths and 'M' for a 3x3/2 max pool in
ceil mode, Pooling's ``pooling_convention='full'``), in the same child
order, so that the parameter names match the JAX package's."""
from ....context import cpu
from ...block import HybridBlock
from ... import nn

__all__ = ['SqueezeNet', 'squeezenet1_0', 'squeezenet1_1', 'get_squeezenet']

# version -> ((stem_channels, stem_kernel), layout); layout entries:
# int = fire module squeeze width, 'M' = ceil-mode 3x3/2 maxpool
_LAYOUT = {
    '1.0': ((96, 7), ('M', 16, 16, 32, 'M', 32, 48, 48, 64, 'M', 64)),
    '1.1': ((64, 3), ('M', 16, 16, 'M', 32, 32, 'M', 48, 48, 64, 64)),
}


def _conv_relu(channels, kernel, padding=0):
    seq = nn.HybridSequential(prefix='')
    seq.add(nn.Conv2D(channels, kernel, padding=padding))
    seq.add(nn.Activation('relu'))
    return seq


class _FireExpand(HybridBlock):
    """The fire module's parallel 1x1 / 3x3 expand paths."""

    def __init__(self, e1, e3, **kwargs):
        super().__init__(**kwargs)
        self.p1 = _conv_relu(e1, 1)
        self.p2 = _conv_relu(e3, 3, 1)

    def hybrid_forward(self, F, x):
        return F.Concat(self.p1(x), self.p2(x), dim=1)


def _fire(squeeze):
    seq = nn.HybridSequential(prefix='')
    seq.add(_conv_relu(squeeze, 1))
    seq.add(_FireExpand(squeeze * 4, squeeze * 4))
    return seq


class SqueezeNet(HybridBlock):
    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        if version not in _LAYOUT:
            raise ValueError(
                'Unsupported SqueezeNet version %s: 1.0 or 1.1 expected'
                % version)
        (stem_ch, stem_k), layout = _LAYOUT[version]
        with self.name_scope():
            self.features = nn.HybridSequential(prefix='')
            self.features.add(nn.Conv2D(stem_ch, kernel_size=stem_k,
                                        strides=2))
            self.features.add(nn.Activation('relu'))
            for item in layout:
                if item == 'M':
                    self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                                   ceil_mode=True))
                else:
                    self.features.add(_fire(item))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.HybridSequential(prefix='')
            self.output.add(nn.Conv2D(classes, kernel_size=1))
            self.output.add(nn.Activation('relu'))
            self.output.add(nn.GlobalAvgPool2D())
            self.output.add(nn.Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_squeezenet(version, pretrained=False, ctx=cpu(), **kwargs):
    if pretrained:
        raise ValueError('no pretrained weights are available')
    return SqueezeNet(version, **kwargs)


def squeezenet1_0(**kwargs):
    return get_squeezenet('1.0', **kwargs)


def squeezenet1_1(**kwargs):
    return get_squeezenet('1.1', **kwargs)
