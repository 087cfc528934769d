"""The vision model zoo: the counterpart of
``mxnet_tpu/gluon/model_zoo/vision/__init__.py`` for ResNet v1 and v2 at
every depth, and ``get_model`` for their names. The other families
(AlexNet, DenseNet, Inception, SqueezeNet, VGG) are not ported yet."""
from .resnet import *      # noqa: F401,F403
from .resnet import (resnet18_v1, resnet34_v1, resnet50_v1, resnet101_v1,
                     resnet152_v1, resnet18_v2, resnet34_v2, resnet50_v2,
                     resnet101_v2, resnet152_v2)

_models = {'resnet18_v1': resnet18_v1, 'resnet34_v1': resnet34_v1,
           'resnet50_v1': resnet50_v1, 'resnet101_v1': resnet101_v1,
           'resnet152_v1': resnet152_v1, 'resnet18_v2': resnet18_v2,
           'resnet34_v2': resnet34_v2, 'resnet50_v2': resnet50_v2,
           'resnet101_v2': resnet101_v2, 'resnet152_v2': resnet152_v2}
_NOT_PORTED = ('vgg11', 'vgg13', 'vgg16', 'vgg19', 'vgg11_bn', 'vgg13_bn',
               'vgg16_bn', 'vgg19_bn', 'alexnet', 'densenet121',
               'densenet161', 'densenet169', 'densenet201', 'squeezenet1.0',
               'squeezenet1.1', 'inceptionv3')


def get_model(name, **kwargs):
    """The model ``name`` (one of the ResNets), built with ``kwargs``."""
    name = name.lower()
    if name in _NOT_PORTED:
        raise NotImplementedError('model %s is in the JAX package\'s zoo '
                                  'but not ported yet' % name)
    if name not in _models:
        raise ValueError(
            'Model %s is not supported. Available options are\n\t%s' % (
                name, '\n\t'.join(sorted(_models.keys()))))
    return _models[name](**kwargs)
