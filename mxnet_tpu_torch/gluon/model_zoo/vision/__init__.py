"""The vision model zoo: the counterpart of
``mxnet_tpu/gluon/model_zoo/vision/__init__.py``, every family (AlexNet,
DenseNet, Inception V3, ResNet v1/v2, SqueezeNet, VGG) and ``get_model``
for their 26 names."""
from .alexnet import *     # noqa: F401,F403
from .densenet import *    # noqa: F401,F403
from .inception import *   # noqa: F401,F403
from .resnet import *      # noqa: F401,F403
from .squeezenet import *  # noqa: F401,F403
from .vgg import *         # noqa: F401,F403

from .alexnet import alexnet
from .densenet import densenet121, densenet161, densenet169, densenet201
from .inception import inception_v3
from .resnet import (resnet18_v1, resnet34_v1, resnet50_v1, resnet101_v1,
                     resnet152_v1, resnet18_v2, resnet34_v2, resnet50_v2,
                     resnet101_v2, resnet152_v2)
from .squeezenet import squeezenet1_0, squeezenet1_1
from .vgg import (vgg11, vgg13, vgg16, vgg19, vgg11_bn, vgg13_bn, vgg16_bn,
                  vgg19_bn)

_models = {'resnet18_v1': resnet18_v1, 'resnet34_v1': resnet34_v1,
           'resnet50_v1': resnet50_v1, 'resnet101_v1': resnet101_v1,
           'resnet152_v1': resnet152_v1, 'resnet18_v2': resnet18_v2,
           'resnet34_v2': resnet34_v2, 'resnet50_v2': resnet50_v2,
           'resnet101_v2': resnet101_v2, 'resnet152_v2': resnet152_v2,
           'vgg11': vgg11, 'vgg13': vgg13, 'vgg16': vgg16, 'vgg19': vgg19,
           'vgg11_bn': vgg11_bn, 'vgg13_bn': vgg13_bn, 'vgg16_bn': vgg16_bn,
           'vgg19_bn': vgg19_bn, 'alexnet': alexnet,
           'densenet121': densenet121, 'densenet161': densenet161,
           'densenet169': densenet169, 'densenet201': densenet201,
           'squeezenet1.0': squeezenet1_0, 'squeezenet1.1': squeezenet1_1,
           'inceptionv3': inception_v3}


def get_model(name, **kwargs):
    """The model ``name``, built with ``kwargs``; ValueError for a name
    the zoo does not have."""
    name = name.lower()
    if name not in _models:
        raise ValueError(
            'Model %s is not supported. Available options are\n\t%s' % (
                name, '\n\t'.join(sorted(_models.keys()))))
    return _models[name](**kwargs)
