"""bench's training step (``bench.py:291-370``) on a zoo family beside the
ResNets: the port's ``graph_train.make_train_step('densenet121')`` against
the same recipe on the JAX package, at batch 2 x 3 x 64 x 64, 10 classes.

DenseNet-121 has no Dropout at its default, so both steps compute one
function. The JAX side is bench's ``step`` written out over the JAX zoo's
``densenet121`` (bench maps only resnet50, alexnet and inceptionv3):
``_GraphProgram`` and ``make_runner`` of the hybridized graph, masters from
``bench._host_init`` on ``RandomState(0)`` then the images and labels from
the same stream, the BN aux cast into the graph and stored back as f32,
``mean(logsumexp - gold)`` on f32 logits, one ``mp_sgd_mom_update`` per
master at bench's lr for the model (0.1), momentum 0.9, wd 1e-4. Both
compute in f32 (``compute_dtype`` float32): the port's step runs from each
of bench's states along bench's trajectory for STEPS steps, and the loss
is held to rtol 1e-4, the update all masters took together (concatenated)
to a relative RMS error of 5e-3 and each aux state to 1e-4, as in
``tests/test_torch_resnet_step.py`` (121 convolutions and BatchNorms in
f32, each summing in another order). ``graph_train.bench_lr`` gives
bench's 0.01 for AlexNet and 0.1 for the others.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu_torch import graph_train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = 'densenet121'
SHAPE = (2, 3, 64, 64)
CLASSES = 10
STEPS = 2
F32_TOL = (1e-4, 5e-3, 1e-4)    # loss rtol, update and aux relative RMS


def _bench():
    spec = importlib.util.spec_from_file_location(
        '_bench_under_test', os.path.join(ROOT, 'bench.py'))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench


def _jax_recipe():
    """bench's build_train_step over the JAX zoo's NAME, in f32."""
    import mxnet_tpu as mx
    from mxnet_tpu.executor import _GraphProgram
    from mxnet_tpu.ops.registry import get as get_op
    bench = _bench()
    with mx.name.NameManager():
        net = mx.gluon.model_zoo.vision.get_model(NAME, classes=CLASSES)
    net.hybridize()
    _, sym = net._get_graph(type('P', (), {'shape': SHAPE,
                                           'context': None})())
    prog = _GraphProgram(sym)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=SHAPE)
    rng = np.random.RandomState(0)
    di = prog.arg_names.index('data')
    masters = [jnp.asarray(bench._host_init(n, s, rng))
               for n, s in zip(prog.arg_names, arg_shapes)]
    aux = tuple(jnp.asarray(bench._host_init(n, s, rng))
                for n, s in zip(prog.aux_names, aux_shapes))
    runner = prog.make_runner()
    update = get_op('mp_sgd_mom_update').fn
    attrs = {'lr': 0.1, 'momentum': 0.9, 'wd': 1e-4, 'rescale_grad': 1.0,
             'clip_gradient': -1.0}

    def step(masters, aux, vel, images, labels, key):
        def loss_fn(args):
            a = list(args)
            a[di] = images
            outs, new_aux = runner(tuple(a), aux, key, True)
            logits = outs[0].astype(jnp.float32)
            gold = jnp.take_along_axis(logits, labels[:, None], -1)[:, 0]
            return jnp.mean(jax.nn.logsumexp(logits, -1) - gold), new_aux

        (loss, new_aux), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(masters)
        new_m, new_v = [], []
        for i, (m, g, v) in enumerate(zip(masters, grads, vel)):
            if i == di:
                new_m.append(m)
                new_v.append(v)
                continue
            _, nv, m32 = update(attrs, m, g, v, m)
            new_m.append(m32)
            new_v.append(nv)
        return tuple(new_m), new_aux, tuple(new_v), loss

    vel = tuple(jnp.zeros_like(m) for m in masters)
    images = jnp.asarray(rng.standard_normal(SHAPE), jnp.float32)
    labels = jnp.asarray(rng.randint(0, CLASSES, (SHAPE[0],)), jnp.int32)
    return (jax.jit(step), tuple(masters), aux, vel, images, labels,
            jax.random.PRNGKey(0), prog.arg_names, prog.aux_names)


def _rel_rms(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)) /
                 max(np.sqrt(np.mean(b ** 2)), 1e-30))


def _torch(arrays):
    return tuple(torch.from_numpy(np.array(x, np.float32)) for x in arrays)


@pytest.fixture(scope='module')
def runs():
    """bench's f32 trajectory over STEPS steps (the JAX package) and, from
    each of its states, the port's f32 step."""
    (jstep, jm, ja, jv, jimg, jlab, key, arg_names,
     aux_names) = _jax_recipe()
    step, m, a, v, img, lab, prog = graph_train.make_train_step(
        NAME, batch=SHAPE[0], image=SHAPE[2], classes=CLASSES, device='cpu',
        compute_dtype=torch.float32)
    assert prog.arg_names == list(arg_names)
    assert prog.aux_names == list(aux_names)
    np.testing.assert_array_equal(img.numpy(), np.asarray(jimg))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    for x, y in zip(m, jm):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    want, got = [], []
    for _ in range(STEPS):
        state = tuple(_torch(x) for x in (jm, ja, jv))
        tm, ta, _, tloss = step(*state, img, lab)
        got.append((float(tloss), [x.numpy() for x in tm],
                    [x.numpy() for x in ta]))
        jm, ja, jv, jloss = jstep(jm, ja, jv, jimg, jlab, key)
        want.append((float(jloss), [np.asarray(x) for x in jm],
                     [np.asarray(x) for x in ja],
                     [x.numpy() for x in state[0]]))
    return want, got, arg_names


def _update(run, step, names, before):
    return np.concatenate([(run[step][1][i] - before[i]).ravel()
                           for i, n in enumerate(names) if n != 'data'])


@pytest.mark.parametrize('step', range(STEPS))
def test_densenet_step_matches_bench(runs, step):
    want, got, names = runs
    assert np.isfinite(got[step][0])
    np.testing.assert_allclose(got[step][0], want[step][0], rtol=F32_TOL[0])
    before = want[step][3]
    assert _rel_rms(_update(got, step, names, before),
                    _update(want, step, names, before)) <= F32_TOL[1]
    assert max(_rel_rms(x, y) for x, y in zip(got[step][2],
                                              want[step][2])) <= F32_TOL[2]


def test_bench_lr_by_model():
    assert graph_train.bench_lr('alexnet') == 0.01
    assert graph_train.bench_lr('inceptionv3') == 0.1
    assert graph_train.bench_lr(NAME) == 0.1
