"""The port's vision model zoo (``mxnet_tpu_torch.gluon.model_zoo``: every
family, ``custom_layers``, ``model_store``) against the JAX package's, on
the CPU.

- All 26 names of ``get_model``: the JAX package's parameter names, and its
  graph (JSON) and shapes at classes 7, inferred at the JAX zoo test's sizes
  (``tests/unittest/test_model_zoo.py``: AlexNet 224, Inception V3 299, the
  others 64).
- ``HybridConcurrent``/``Identity``, ``model_store`` (local files only),
  ``pretrained=True`` raising ValueError in every family.

The forwards are held in ``test_torch_zoo_forward.py``, the training step
in ``test_torch_zoo_step.py``.
"""
import os

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch.gluon.model_zoo import custom_layers, model_store, vision

CPU = mt.cpu()
CLASSES = 7
NAMES = sorted(mx.gluon.model_zoo.vision._models)


def _size(name):
    """The JAX zoo test's input side for ``name``."""
    return {'alexnet': 224, 'inceptionv3': 299}.get(name, 64)


def _build(lib, name, **kwargs):
    with lib.name.NameManager():
        return lib.gluon.model_zoo.vision.get_model(name, classes=CLASSES,
                                                    **kwargs)


def _placeholder(shape):
    return type('P', (), {'shape': shape, 'context': None})()


def test_get_model_has_every_name_of_the_jax_zoo():
    assert len(NAMES) == 26
    assert sorted(vision._models) == NAMES
    with pytest.raises(ValueError):
        vision.get_model('resnet9999_v9')


@pytest.mark.parametrize('name', NAMES)
def test_names_graph_and_shapes_match_jax(name):
    jnet, tnet = _build(mx, name), _build(mt, name)
    assert list(tnet.collect_params().keys()) == \
        list(jnet.collect_params().keys())
    shape = (1, 3, _size(name), _size(name))
    jnet.hybridize()
    tnet.hybridize()
    js = jnet._get_graph(_placeholder(shape))[1]
    ts = tnet._get_graph(_placeholder(shape))[1]
    assert ts.tojson() == js.tojson()
    assert ts.infer_shape(data=shape) == js.infer_shape(data=shape)


@pytest.mark.parametrize('name', ['alexnet', 'inceptionv3', 'vgg16',
                                  'densenet121', 'squeezenet1.1',
                                  'resnet18_v1'])
def test_pretrained_raises_as_in_jax(name):
    for lib in (mx, mt):
        with pytest.raises(ValueError):
            lib.gluon.model_zoo.vision.get_model(name, pretrained=True)


def test_hybrid_concurrent_and_identity_match_jax():
    x = np.random.RandomState(2).standard_normal((2, 5)).astype(np.float32)
    outs = []
    from mxnet_tpu.gluon.model_zoo import custom_layers as jax_layers
    for lib, cl in ((mx, jax_layers), (mt, custom_layers)):
        with lib.name.NameManager():
            net = cl.HybridConcurrent(concat_dim=1)
            with net.name_scope():
                net.add(lib.gluon.nn.Dense(3, in_units=5))
                net.add(cl.Identity())
        ctx = CPU if lib is mt else mx.cpu()
        net.initialize(ctx=ctx)
        outs.append((net, lib.nd.array(x, ctx=ctx)))
    (jnet, jx), (tnet, tx) = outs
    assert list(tnet.collect_params().keys()) == \
        list(jnet.collect_params().keys())
    gluon.params_from_numpy(tnet, {n: p.data().asnumpy() for n, p in
                                   jnet.collect_params().items()})
    want = jnet(jx).asnumpy()
    tnet.hybridize()
    got = tnet(tx).asnumpy()
    assert got.shape == (2, 8)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[:, 3:], x)


def test_model_store_reads_local_files_only(tmp_path):
    with pytest.raises(IOError):
        model_store.get_model_file('alexnet', local_dir=str(tmp_path))
    path = tmp_path / 'alexnet.params'
    path.write_bytes(b'')
    assert model_store.get_model_file('alexnet', local_dir=str(tmp_path)) \
        == str(path)
    (tmp_path / 'notes.txt').write_text('kept')
    model_store.purge(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ['notes.txt']
    with pytest.raises(ValueError):
        model_store.short_hash('alexnet')
