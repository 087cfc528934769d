"""VGG 11-19, with and without BatchNorm: the counterpart of
``mxnet_tpu/gluon/model_zoo/vision/vgg.py``, with its parameter names and
initializers."""
from ....context import cpu
from ....initializer import Xavier
from ...block import HybridBlock
from ... import nn

__all__ = ['VGG', 'vgg11', 'vgg13', 'vgg16', 'vgg19', 'vgg11_bn', 'vgg13_bn',
           'vgg16_bn', 'vgg19_bn', 'get_vgg']

# depth -> convs per stage; every variant shares the same stage widths
_STAGE_WIDTHS = (64, 128, 256, 512, 512)
_DEPTHS = {11: (1, 1, 2, 2, 2), 13: (2, 2, 2, 2, 2),
           16: (2, 2, 3, 3, 3), 19: (2, 2, 4, 4, 4)}
vgg_spec = {d: (list(counts), list(_STAGE_WIDTHS))
            for d, counts in _DEPTHS.items()}


class VGG(HybridBlock):
    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(filters)
        with self.name_scope():
            self.features = self._make_features(layers, filters, batch_norm)
            self.features.add(nn.Dense(4096, activation='relu',
                                       weight_initializer='normal',
                                       bias_initializer='zeros'))
            self.features.add(nn.Dropout(rate=0.5))
            self.features.add(nn.Dense(4096, activation='relu',
                                       weight_initializer='normal',
                                       bias_initializer='zeros'))
            self.features.add(nn.Dropout(rate=0.5))
            self.output = nn.Dense(classes, weight_initializer='normal',
                                   bias_initializer='zeros')

    def _make_features(self, layers, filters, batch_norm):
        featurizer = nn.HybridSequential(prefix='')
        for i, num in enumerate(layers):
            for _ in range(num):
                featurizer.add(nn.Conv2D(filters[i], kernel_size=3, padding=1,
                                         weight_initializer=Xavier(
                                             rnd_type='gaussian',
                                             factor_type='out',
                                             magnitude=2),
                                         bias_initializer='zeros'))
                if batch_norm:
                    featurizer.add(nn.BatchNorm())
                featurizer.add(nn.Activation('relu'))
            featurizer.add(nn.MaxPool2D(strides=2))
        return featurizer

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


def get_vgg(num_layers, pretrained=False, ctx=cpu(), **kwargs):
    layers, filters = vgg_spec[num_layers]
    if pretrained:
        raise ValueError('no pretrained weights are available')
    return VGG(layers, filters, **kwargs)


def _shortcut(depth, bn):
    def f(**kwargs):
        if bn:
            kwargs['batch_norm'] = True
        return get_vgg(depth, **kwargs)
    f.__name__ = 'vgg%d%s' % (depth, '_bn' if bn else '')
    f.__doc__ = 'VGG-%d%s (get_vgg shortcut).' % (depth,
                                                  ' + BatchNorm' if bn else '')
    return f


# vgg11 ... vgg19_bn, generated from the table
for _d in sorted(_DEPTHS):
    for _bn in (False, True):
        _fn = _shortcut(_d, _bn)
        globals()[_fn.__name__] = _fn
del _d, _bn, _fn
