"""AlexNet: the counterpart of ``mxnet_tpu/gluon/model_zoo/vision/
alexnet.py``, built from the same two tables in the same child order, so
that the parameter names match the JAX package's. The classifier expects
6 x 6 features: 224 x 224 input."""
from ....context import cpu
from ...block import HybridBlock
from ... import nn

__all__ = ['AlexNet', 'alexnet']

# the features: ('C', channels, kernel, stride, pad) or ('M',), a max pool
_FEATURES = (
    ('C', 64, 11, 4, 2), ('M',),
    ('C', 192, 5, 1, 2), ('M',),
    ('C', 384, 3, 1, 1),
    ('C', 256, 3, 1, 1),
    ('C', 256, 3, 1, 1), ('M',),
)
_HIDDEN = 4096
_DROP = 0.5


class AlexNet(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix='')
            with self.features.name_scope():
                for spec in _FEATURES:
                    if spec[0] == 'M':
                        self.features.add(nn.MaxPool2D(pool_size=3,
                                                       strides=2))
                    else:
                        _, ch, k, s, p = spec
                        self.features.add(nn.Conv2D(
                            ch, kernel_size=k, strides=s, padding=p,
                            activation='relu'))
                self.features.add(nn.Flatten())
            self.classifier = nn.HybridSequential(prefix='')
            with self.classifier.name_scope():
                for _ in range(2):
                    self.classifier.add(nn.Dense(_HIDDEN, activation='relu'))
                    self.classifier.add(nn.Dropout(_DROP))
                self.classifier.add(nn.Dense(classes))

    def hybrid_forward(self, F, x):
        return self.classifier(self.features(x))


def alexnet(pretrained=False, ctx=cpu(), **kwargs):
    """AlexNet; there are no pretrained weights."""
    if pretrained:
        raise ValueError('no pretrained weights are available')
    return AlexNet(**kwargs)
