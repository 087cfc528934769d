"""The forward of each family of the port's model zoo that the JAX package's
zoo has beside the ResNets (AlexNet, Inception V3, VGG with and without
BatchNorm, DenseNet, SqueezeNet 1.0 and 1.1), against the JAX package's on
the CPU, in prediction, batch 1, at the JAX zoo test's sizes
(``tests/unittest/test_model_zoo.py``: AlexNet 224, Inception V3 299, the
others 64).

Both nets run on the same weights: random values from ``RandomState`` by
name (normal with std sqrt(2 / fan_in) for weights, small normal biases and
moving means, moving variances in [0.5, 1.5]), set in the JAX net and
carried across by ``params_from_numpy``. Tolerance: relative RMS 1e-4 (f32
throughout; up to 100 convolutions each summing in another order). The JAX
nets run hybridized and are called first in prediction (the JAX package
keeps a hybridized block's first train flag).
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import gluon, nd

CPU = mt.cpu()
CLASSES = 7
FORWARD = ['alexnet', 'inceptionv3', 'vgg11', 'vgg11_bn', 'densenet121',
           'squeezenet1.0', 'squeezenet1.1']
REL_RMS = 1e-4


def _size(name):
    return {'alexnet': 224, 'inceptionv3': 299}.get(name, 64)


def _build(lib, name):
    with lib.name.NameManager():
        return lib.gluon.model_zoo.vision.get_model(name, classes=CLASSES)


def _values(names_shapes, seed):
    rng = np.random.RandomState(seed)
    out = {}
    for n, s in names_shapes:
        if n.endswith('running_var'):
            v = rng.uniform(0.5, 1.5, s)
        elif n.endswith(('bias', 'beta', 'running_mean')):
            v = 0.1 * rng.standard_normal(s)
        elif n.endswith('gamma'):
            v = 1 + 0.1 * rng.standard_normal(s)
        else:
            v = rng.standard_normal(s) * np.sqrt(2.0 / max(1, np.prod(s[1:])))
        out[n] = v.astype(np.float32)
    return out


def _rel_rms(got, want):
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / np.sqrt(np.mean(want ** 2)))


@pytest.mark.parametrize('name', FORWARD)
def test_forward_on_carried_weights_matches_jax(name):
    size = _size(name)
    x = np.random.RandomState(1).standard_normal(
        (1, 3, size, size)).astype(np.float32)
    jnet = _build(mx, name)
    jnet.initialize()
    jnet.hybridize()
    jnet(mx.nd.array(x))            # deferred initialisation, one compile
    jp = jnet.collect_params()
    values = _values([(n, p.shape) for n, p in jp.items()], seed=0)
    for n, p in jp.items():
        p.set_data(mx.nd.array(values[n]))
    want = jnet(mx.nd.array(x)).asnumpy()
    tnet = _build(mt, name)
    tnet.initialize(ctx=CPU)
    tnet(nd.array(x, ctx=CPU))
    gluon.params_from_numpy(tnet, values)
    tnet.hybridize()
    got = tnet(nd.array(x, ctx=CPU)).asnumpy()
    assert got.shape == want.shape == (1, CLASSES)
    assert np.isfinite(got).all()
    assert _rel_rms(got, want) <= REL_RMS, (name, _rel_rms(got, want))
