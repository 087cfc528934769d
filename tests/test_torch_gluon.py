"""The port's Gluon (mxnet_tpu_torch.gluon: Parameter, ParameterDict,
Block, HybridBlock, SymbolBlock, the nn layers, model_zoo.vision's
ResNets) and initializers (mxnet_tpu_torch.initializer) against the JAX
package's, on the CPU.

The main case is a narrow bottleneck ResNet,
``ResNetV1(BottleneckV1, [1, 1, 1, 1], [8, 8, 16, 32, 64], classes=10)``
on 2 x 3 x 32 x 32: the same parameter names as the JAX package's, the
JAX package's initial values set by name (``params_from_numpy``), then
the forward (prediction and training) and, under ``autograd.record()``,
the gradients of every parameter and the new BatchNorm statistics,
imperative and hybridized, against the JAX net hybridized (the JAX
package's imperative forward is the same function op by op). The JAX
package keeps the train flag of a hybridized block's first call in its
cached program (a later call in the other mode runs the first's), so the
JAX net is called in training only; the port reads the flag at every
call, as the JAX package's imperative forward and the reference do, and
its prediction is held imperative against hybridized.

Tolerances, with their reasons: f32 throughout; the outputs and
gradients rtol 1e-4, atol 1e-4 x the largest |jax| value of the tensor
(17 convolutions and BatchNorms in f32, each summing in another order; the
last stage's BatchNorms normalise over 2 values and so amplify those
differences, measured up to 2e-5 relative); the statistics rtol 1e-5.
The initializers: constants exactly; the random ones from the host numpy
stream, equal to the JAX package's after the same seed.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd, gluon, initializer, nd
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo import vision

SHAPE = (2, 3, 32, 32)
CPU = mt.cpu()


def _narrow(lib):
    """The narrow net, named from fresh counters (resnetv10_...)."""
    r = lib.gluon.model_zoo.vision.resnet
    with lib.name.NameManager():
        return r.ResNetV1(r.BottleneckV1, [1, 1, 1, 1], [8, 8, 16, 32, 64],
                          classes=10)


def _close(got, want, rtol=1e-4, arel=1e-4, what=''):
    want = np.asarray(want)
    atol = arel * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


@pytest.fixture(scope='module')
def jax_run():
    """The JAX net hybridized, initialised from seed 0 and first called in
    training: its initial parameters (the statistics as initialised), its
    output, gradients and new statistics. The JAX package keeps the train
    flag of a hybridized block's first call in its cached program, so the
    net is only called in training."""
    x = np.random.RandomState(1).randn(*SHAPE).astype(np.float32)
    mx.random.seed(0)
    net = _narrow(mx)
    net.initialize(mx.init.Xavier(magnitude=2.0))
    net.hybridize()
    with mx.autograd.record():
        y = net(mx.nd.array(x))
        loss = (y * y).sum()
    loss.backward()
    ps = net.collect_params()
    params = {n: (np.zeros(p.shape, np.float32) if 'running_mean' in n else
                  np.ones(p.shape, np.float32) if 'running_var' in n else
                  p.data().asnumpy()) for n, p in ps.items()}
    out = {'train': y.asnumpy(),
           'grads': {n: p.grad().asnumpy() for n, p in ps.items()
                     if p.grad_req != 'null'},
           'stats': {n: p.data().asnumpy() for n, p in ps.items()
                     if 'running' in n}}
    return params, x, out, list(ps.keys())


@pytest.fixture(scope='module', params=['imperative', 'hybridized'])
def port_run(request, jax_run):
    params, x, _, _ = jax_run
    net = _narrow(mt)
    net.initialize(ctx=CPU)
    if request.param == 'hybridized':
        net.hybridize()
    net(nd.array(x, ctx=CPU))            # deferred initialisation
    gluon.params_from_numpy(net, params)
    out = {}
    with autograd.record():
        y = net(nd.array(x, ctx=CPU))
        loss = (y * y).sum()
    loss.backward()
    out['train'] = y.asnumpy()
    ps = net.collect_params()
    out['grads'] = {n: p.grad().asnumpy() for n, p in ps.items()
                    if p.grad_req != 'null'}
    out['stats'] = {n: p.data().asnumpy() for n, p in ps.items()
                    if 'running' in n}
    return out, list(ps.keys())


def test_resnet_parameter_names_match_jax(jax_run, port_run):
    assert port_run[1] == jax_run[3]


def test_resnet_forward_matches_jax(jax_run, port_run):
    _close(port_run[0]['train'], jax_run[2]['train'])


def test_resnet_prediction_is_the_same_imperative_and_hybridized(jax_run):
    """In prediction (the moving statistics as initialised) the port's
    hybridized forward equals its imperative one; BatchNorm in prediction
    is held to the JAX op in test_torch_nn_ops.py."""
    params, x, _, _ = jax_run
    outs = []
    for hybrid in (False, True):
        net = _narrow(mt)
        net.initialize(ctx=CPU)
        net(nd.array(x, ctx=CPU))
        gluon.params_from_numpy(net, params)
        if hybrid:
            net.hybridize()
        outs.append(net(nd.array(x, ctx=CPU)).asnumpy())
    np.testing.assert_array_equal(outs[1], outs[0])


def test_resnet_gradients_match_jax(jax_run, port_run):
    """Each gradient to rtol 1e-4, atol 1e-4 x the largest gradient of any
    parameter: the biases of the convolutions that feed a BatchNorm have a
    true gradient of 0, and both sides give rounding noise there (1e-7)."""
    got, want = port_run[0]['grads'], jax_run[2]['grads']
    assert sorted(got) == sorted(want)
    scale = max(float(np.abs(g).max()) for g in want.values())
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=n)


def test_resnet_new_statistics_match_jax(jax_run, port_run):
    got, want = port_run[0]['stats'], jax_run[2]['stats']
    for n in want:
        _close(got[n], want[n], rtol=1e-5, arel=1e-5, what=n)


@pytest.mark.parametrize('name', ['resnet18_v2', 'resnet50_v1', 'vgg11_bn',
                                  'densenet121', 'squeezenet1.1'])
def test_zoo_names_and_shapes_match_jax(name):
    """get_model's nets have the JAX package's parameter names and
    (deferred) shapes."""
    with mx.name.NameManager():
        jnet = mx.gluon.model_zoo.vision.get_model(name, classes=7)
    with mt.name.NameManager():
        tnet = vision.get_model(name, classes=7)
    shape = (1, 3, 64, 64)
    jp = jnet.collect_params()
    tp = tnet.collect_params()
    assert list(tp.keys()) == list(jp.keys())
    tnet.hybridize()
    jnet.hybridize()
    js = jnet._get_graph(type('P', (), {'shape': shape, 'context': None})())[1]
    ts = tnet._get_graph(type('P', (), {'shape': shape, 'context': None})())[1]
    assert ts.infer_shape(data=shape) == js.infer_shape(data=shape)
    assert ts.tojson() == js.tojson()


def test_resnet_v2_forward_matches_jax():
    r, jr = vision.resnet, mx.gluon.model_zoo.vision.resnet
    with mx.name.NameManager():
        jnet = jr.ResNetV2(jr.BasicBlockV2, [1, 1, 1, 1], [8, 8, 16, 24, 32],
                           classes=5, thumbnail=True)
    with mt.name.NameManager():
        tnet = r.ResNetV2(r.BasicBlockV2, [1, 1, 1, 1], [8, 8, 16, 24, 32],
                          classes=5, thumbnail=True)
    x = np.random.RandomState(2).randn(2, 3, 16, 16).astype(np.float32)
    jnet.initialize(mx.init.Xavier())
    jnet.hybridize()
    want = jnet(mx.nd.array(x)).asnumpy()
    tnet.initialize(ctx=CPU)
    tnet(nd.array(x, ctx=CPU))
    gluon.params_from_numpy(tnet, {n: p.data().asnumpy() for n, p in
                                   jnet.collect_params().items()})
    _close(tnet(nd.array(x, ctx=CPU)).asnumpy(), want)
    with pytest.raises(ValueError):
        vision.get_model('resnet19_v1')
    with pytest.raises(ValueError):
        vision.get_model('vgg17')
    assert isinstance(vision.get_model('vgg16'), vision.VGG)


def _layers(lib):
    g = lib.gluon.nn
    return [
        ('dense', lambda: g.Dense(5, activation='relu', in_units=6), (3, 6)),
        ('dense-noflatten', lambda: g.Dense(4, flatten=False, use_bias=False),
         (2, 3, 6)),
        ('conv1d', lambda: g.Conv1D(4, 3, strides=2, padding=1), (2, 3, 9)),
        ('conv2d-group', lambda: g.Conv2D(6, (3, 2), groups=3, dilation=(2, 1),
                                          in_channels=3), (2, 3, 9, 8)),
        ('conv3d', lambda: g.Conv3D(2, 2, activation='tanh'), (1, 2, 4, 4, 4)),
        ('conv2dT', lambda: g.Conv2DTranspose(3, 3, strides=2, padding=1,
                                              output_padding=1, in_channels=2),
         (2, 2, 4, 5)),
        ('maxpool2d-ceil', lambda: g.MaxPool2D(3, 2, ceil_mode=True),
         (2, 2, 8, 7)),
        ('avgpool1d', lambda: g.AvgPool1D(2, padding=1), (2, 2, 7)),
        ('avgpool3d', lambda: g.AvgPool3D(2), (1, 2, 4, 4, 4)),
        ('globalmax1d', lambda: g.GlobalMaxPool1D(), (2, 3, 5)),
        ('globalavg2d', lambda: g.GlobalAvgPool2D(), (2, 3, 5, 4)),
        ('globalmax3d', lambda: g.GlobalMaxPool3D(), (1, 2, 3, 3, 3)),
        ('batchnorm', lambda: g.BatchNorm(momentum=0.8, epsilon=1e-3,
                                          in_channels=3), (4, 3, 2, 2)),
        ('batchnorm-noscale', lambda: g.BatchNorm(scale=False, center=False),
         (4, 3)),
        ('leakyrelu', lambda: g.LeakyReLU(0.1), (3, 4)),
        ('flatten', lambda: g.Flatten(), (2, 3, 4)),
        ('dropout-0', lambda: g.Dropout(0.0), (3, 4)),
        ('activation', lambda: g.Activation('softrelu'), (3, 4)),
    ]


LAYER_IDS = [c[0] for c in _layers(mt)]


_JAX_LAYERS = {}


def _run_layer(lib, layer, x):
    xa = lib.nd.array(x) if lib is mx else nd.array(x, ctx=CPU)
    xa.attach_grad()
    with lib.autograd.record():
        y = layer(xa)
        head = np.random.RandomState(99).randn(*y.shape)
        loss = (y * (lib.nd.array(head) if lib is mx else
                     nd.array(head, ctx=CPU))).sum()
    loss.backward()
    return [y.asnumpy(), xa.grad.asnumpy()] + [
        p.grad().asnumpy() if p.grad_req != 'null' else p.data().asnumpy()
        for p in layer.collect_params().values()]


def _jax_layer(idx):
    """The JAX layer (imperative: a hybridized layer is the same function)
    from Normal(0.5): its parameters and its results; once per layer."""
    if idx not in _JAX_LAYERS:
        _, make, shape = _layers(mx)[idx]
        x = np.random.RandomState(idx).randn(*shape).astype(np.float32)
        with mx.name.NameManager():
            layer = make()
        layer.initialize(mx.init.Normal(0.5))
        layer(mx.nd.array(x))              # deferred initialisation
        params = {n: p.data().asnumpy()
                  for n, p in layer.collect_params().items()}
        _JAX_LAYERS[idx] = (x, params, _run_layer(mx, layer, x))
    return _JAX_LAYERS[idx]


@pytest.mark.parametrize('idx', range(len(LAYER_IDS)), ids=LAYER_IDS)
@pytest.mark.parametrize('hybrid', [False, True])
def test_layer_matches_jax(idx, hybrid):
    """Each layer in training, imperative and hybridized: output, input
    gradient and parameter gradients for a random head, from the JAX
    layer's parameters."""
    x, params, want = _jax_layer(idx)
    with mt.name.NameManager():
        layer = _layers(mt)[idx][1]()
    layer.initialize(ctx=CPU)
    layer(nd.array(x, ctx=CPU))            # deferred initialisation
    gluon.params_from_numpy(layer, params)
    if hybrid:
        layer.hybridize()
    got = _run_layer(mt, layer, x)
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        _close(a, b, rtol=1e-5, arel=1e-5, what=str(k))


def test_embedding_and_sequential_match_jax():
    idx = np.array([[1, 3], [0, 2]], np.float32)
    res = []
    for lib in (mx, mt):
        g = lib.gluon.nn
        with lib.name.NameManager():
            seq = g.Sequential()
        with seq.name_scope():
            seq.add(g.Embedding(5, 3), g.Flatten(), g.Dense(2))
        if lib is mx:
            lib.random.seed(4)
            seq.initialize(lib.init.Uniform(0.5))
            res.append((seq(lib.nd.array(idx)).asnumpy(),
                        list(seq.collect_params().keys())))
        else:
            lib.random.seed(4)
            seq.initialize(lib.init.Uniform(0.5), ctx=CPU)
            res.append((seq(nd.array(idx, ctx=CPU)).asnumpy(),
                        list(seq.collect_params().keys())))
    assert res[1][1] == res[0][1]
    # the same seed gives the same Uniform draws from the host stream
    np.testing.assert_allclose(res[1][0], res[0][0], rtol=1e-6)


def test_symbol_block_matches_jax():
    res = []
    for lib in (mx, mt):
        data = lib.sym.var('data')
        out = lib.sym.Activation(lib.sym.FullyConnected(
            data, num_hidden=3, name='fc'), act_type='tanh')
        blk = lib.gluon.SymbolBlock(out, data)
        ctx = mx.cpu() if lib is mx else CPU
        blk.collect_params().initialize(lib.init.One(), ctx=ctx)
        x = lib.nd.array(np.arange(8, dtype=np.float32).reshape(2, 4) / 8,
                         ctx=ctx)
        res.append((blk(x).asnumpy(), sorted(blk.collect_params().keys())))
    assert res[1][1] == res[0][1]
    np.testing.assert_allclose(res[1][0], res[0][0], rtol=1e-6)


def test_parameter_surface(tmp_path):
    p = gluon.Parameter('w', shape=(2, 3), grad_req='write')
    with pytest.raises(RuntimeError):
        p.data()
    p.initialize(initializer.Constant(2.0), ctx=CPU)
    np.testing.assert_array_equal(p.data().asnumpy(), np.full((2, 3), 2.0))
    assert p.grad().shape == (2, 3) and p.list_ctx() == [CPU]
    p.set_data(nd.ones((2, 3), ctx=CPU))
    with autograd.record():
        y = (p.data() * 3).sum()
    y.backward()
    np.testing.assert_array_equal(p.grad().asnumpy(), np.full((2, 3), 3.0))
    p.zero_grad()
    assert not p.grad().asnumpy().any()
    p.grad_req = 'null'
    with pytest.raises(RuntimeError):
        p.grad()
    p.cast('float16')
    assert p.data().dtype == np.float16
    assert p.var().name == 'w'
    d = gluon.ParameterDict('pre_')
    a = d.get('weight', shape=(0, 4), allow_deferred_init=True)
    assert d.get('weight', shape=(3, 0)) is a and a.shape == (3, 4)
    a.initialize(ctx=CPU)
    # save and load go through nd.save/nd.load (test_torch_save_load.py
    # holds the files across the packages)
    fname = str(tmp_path / 'x.params')
    d.save(fname, strip_prefix='pre_')
    want = a.data().asnumpy()
    a.set_data(nd.zeros((3, 4), ctx=CPU))
    d.load(fname, CPU, restore_prefix='pre_')
    np.testing.assert_array_equal(a.data().asnumpy(), want)
    q = gluon.Parameter('q', allow_deferred_init=True)
    q.initialize(ctx=CPU)
    with pytest.raises(gluon.DeferredInitializationError):
        q.data()


@pytest.mark.parametrize('init', [
    ('Zero', {}), ('One', {}), ('Constant', {'value': 0.3}),
    ('Uniform', {'scale': 0.2}), ('Normal', {'sigma': 0.1}),
    ('Xavier', {'rnd_type': 'gaussian', 'factor_type': 'in',
                'magnitude': 2}), ('Xavier', {}), ('MSRAPrelu', {}),
    ('Orthogonal', {}), ('Orthogonal', {'rand_type': 'normal'}),
    ('Bilinear', {}), ('LSTMBias', {'forget_bias': 2.0})],
    ids=lambda c: c[0] + '-'.join(str(v) for v in c[1].values()))
def test_initializer_matches_jax(init):
    """Each initializer on a weight, after the same seed: constant ones
    exactly, random ones drawn from the same host numpy stream, so equal
    to the JAX package's to the one f64 -> f32 rounding both make."""
    name, kw = init
    shape = (8, 2, 3, 3) if name == 'Bilinear' else (8, 6)
    desc = 'fc_bias' if name == 'LSTMBias' else 'fc_weight'
    mx.random.seed(3)
    mt.random.seed(3)
    ja = mx.nd.zeros(shape)
    getattr(mx.init, name)(**kw)(mx.init.InitDesc(desc), ja)
    ta = nd.zeros(shape, ctx=CPU)
    getattr(initializer, name)(**kw)(initializer.InitDesc(desc), ta)
    np.testing.assert_array_equal(ta.asnumpy(), ja.asnumpy())


def test_initializer_dispatch_mixed_load():
    init = initializer.Uniform(0.1)
    arrs = {n: nd.ones((3,), ctx=CPU) * 5 for n in
            ('a_bias', 'a_gamma', 'a_beta', 'a_running_mean', 'a_moving_var')}
    for n, a in arrs.items():
        init(initializer.InitDesc(n), a)
    assert [float(a.asnumpy()[0]) for a in arrs.values()] == [0, 1, 0, 0, 1]
    with pytest.raises(ValueError):
        init(initializer.InitDesc('odd'), nd.ones((2,), ctx=CPU))
    desc = initializer.InitDesc('x_weight', {'__init__': initializer.Constant(
        7.0).dumps()})
    w = nd.zeros((2,), ctx=CPU)
    init(desc, w)
    np.testing.assert_array_equal(w.asnumpy(), [7, 7])
    mixed = initializer.Mixed(['.*bias', '.*'], [initializer.Zero(),
                                                  initializer.One()])
    b, w = nd.ones((2,), ctx=CPU), nd.zeros((2,), ctx=CPU)
    mixed('fc_bias', b)
    mixed('fc_weight', w)
    assert b.asnumpy().tolist() == [0, 0] and w.asnumpy().tolist() == [1, 1]
    load = initializer.Load({'arg:fc_weight': nd.array([4.0, 5.0], ctx=CPU)},
                            default_init=initializer.Zero())
    load('fc_weight', w)
    load('fc_bias', b)
    assert w.asnumpy().tolist() == [4, 5] and b.asnumpy().tolist() == [0, 0]
    assert initializer.create('zeros').__class__ is initializer.Zero


def test_params_from_numpy_on_an_executor_and_errors():
    s = mt.sym.FullyConnected(mt.sym.var('data'), num_hidden=2, name='fc')
    ex = s.simple_bind(CPU, data=(1, 3))
    gluon.params_from_numpy(ex, {'fc_weight': np.ones((2, 3)),
                                 'fc_bias': np.arange(2.0)},
                            allow_missing=True)
    ex.arg_dict['data'][:] = 1
    np.testing.assert_array_equal(ex.forward()[0].asnumpy(), [[3, 4]])
    with pytest.raises(KeyError):
        gluon.params_from_numpy(ex, {'nope': np.ones(1)})
    with pytest.raises(KeyError):
        gluon.params_from_numpy(ex, {'fc_bias': np.ones(2)})
    with pytest.raises(ValueError):
        gluon.params_from_numpy(ex, {'fc_bias': np.ones(3)},
                                allow_missing=True)


@pytest.mark.skipif(torch.cuda.is_available(), reason='needs a machine '
                    'without CUDA')
def test_new_entry_points_default_to_the_card():
    """Without a card, each entry point that places data raises unless it
    is given the CPU: there is no fallback."""
    from mxnet_tpu_torch import graph_train
    with pytest.raises(RuntimeError, match='CUDA'):
        graph_train.make_train_step('resnet18_v1', 1, 32, 10)
    with pytest.raises(RuntimeError, match='CUDA'):
        nn.Dense(2, in_units=2).initialize()
    with pytest.raises(RuntimeError, match='CUDA'):
        nd.random.uniform(shape=(2,))
    with pytest.raises(RuntimeError, match='CUDA'):
        mt.sym.var('x').simple_bind(mt.gpu(0), x=(2,))
    # Module's default context is the card (the JAX package's is cpu())
    with pytest.raises(RuntimeError, match='CUDA'):
        mt.mod.Module(mt.sym.SoftmaxOutput(mt.sym.var('data'),
                                           name='softmax'))
