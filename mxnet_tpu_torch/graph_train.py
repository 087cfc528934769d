"""bench's default training step (``bench.py:291-370``, ResNet-50 at batch
32) composed from the port's public parts, as bench composes it from the
JAX package's:

1. ``gluon.model_zoo.vision.get_model(name, classes=...)``, hybridized,
   traced by ``_get_graph`` with a placeholder of the data's shape;
2. ``executor._GraphProgram``, ``Symbol.infer_shape`` and ``make_runner``;
3. f32 masters from :func:`host_init` (a copy of bench's ``_host_init``) on
   ``numpy.random.RandomState(seed)``, then the images and labels from the
   same stream;
4. a step that runs the graph in the compute dtype (bf16) over copies of
   the masters, with the BN aux states cast into the graph and their new
   values stored back as f32;
5. the loss ``mean(logsumexp - gold)`` on f32 logits, its gradients by
   torch autograd;
6. one ``mp_sgd_mom_update`` (the registry op) per master, skipping the
   data's, at bench's learning rate for the model (:func:`bench_lr`: 0.01
   for AlexNet, 0.1 for the others) unless the caller gives one.

``compute_dtype=torch.float32`` gives the same step in f32, the reference
that the bf16 step is held to on the card.
"""
import ml_dtypes
import numpy as np
import torch

from .context import as_torch_device
from .executor import _GraphProgram, mirror_wrap
from .gluon.model_zoo import vision
from .ops.registry import get as get_op

__all__ = ['host_init', 'build_graph', 'make_train_step', 'TRAIN_ATTRS',
           'bench_lr', 'loss_and_grads']

# bench's hyper-parameters for the BN nets
TRAIN_ATTRS = {'lr': 0.1, 'momentum': 0.9, 'wd': 1e-4, 'rescale_grad': 1.0,
               'clip_gradient': -1.0}


def bench_lr(name):
    """bench's learning rate for the zoo model ``name``: 0.01 for AlexNet,
    which has no BatchNorm and diverges at the BN nets' 0.1, else 0.1."""
    return 0.01 if name == 'alexnet' else TRAIN_ATTRS['lr']


def host_init(name, shape, rng):
    """bench's ``_host_init``: ones for gamma and the variances, zeros for
    beta, biases and means, else normal with std sqrt(2 / fan_in)."""
    if 'gamma' in name or 'var' in name:
        return np.ones(shape, np.float32)
    if 'beta' in name or 'bias' in name or 'mean' in name:
        return np.zeros(shape, np.float32)
    fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
    std = (2.0 / max(1, fan_in)) ** 0.5
    return (rng.standard_normal(shape) * std).astype(np.float32)


def _placeholder(shape):
    return type('P', (), {'shape': shape, 'context': None})()


def build_graph(net, data_shape):
    """The hybridized net's graph program for data of ``data_shape``:
    ``(prog, arg_shapes, aux_shapes)``."""
    net.hybridize()
    _, sym = net._get_graph(_placeholder(data_shape))
    prog = _GraphProgram(sym)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=data_shape)
    return prog, arg_shapes, aux_shapes


def _bf16_from_f64(a):
    """A float64 numpy array as bf16, rounded once, as jnp.asarray does."""
    bits = np.ascontiguousarray(a.astype(ml_dtypes.bfloat16)).view(np.int16)
    return torch.from_numpy(bits).view(torch.bfloat16)


def loss_and_grads(runner, prog, masters, aux, images, labels,
                   compute_dtype=torch.bfloat16, seed=0, is_train=True):
    """bench's ``loss_fn`` and its gradients: ``(loss, grads, new_aux)``,
    grads in the compute dtype for every master but the data's (None).
    ``is_train=False`` runs the graph in prediction (BatchNorm on the
    moving statistics)."""
    data_idx = prog.arg_names.index('data')
    args = [images if i == data_idx
            else m.detach().to(compute_dtype).requires_grad_()
            for i, m in enumerate(masters)]
    aux_c = tuple(x.to(compute_dtype) for x in aux)
    with torch.enable_grad():
        outs, new_aux = runner(tuple(args), aux_c, seed, is_train)
        logits = outs[0].float()
        lse = torch.logsumexp(logits, -1)
        gold = logits.gather(-1, labels.long()[:, None])[:, 0]
        loss = (lse - gold).mean()
    wrt = [a for i, a in enumerate(args) if i != data_idx]
    grads = list(torch.autograd.grad(loss, wrt))
    grads.insert(data_idx, None)
    return loss.detach(), grads, tuple(x.float() for x in new_aux)


def make_train_step(name='resnet50_v1', batch=32, image=224, classes=1000,
                    device=None, seed=0, compute_dtype=torch.bfloat16,
                    net=None, lr=None):
    """bench's step for the zoo model ``name`` (or ``net``), at data
    ``(batch, 3, image, image)``: ``(step, masters, aux, vel, images,
    labels, prog)``, where ``step(masters, aux, vel, images, labels) ->
    (masters, aux, vel, loss)`` runs one training step. Masters, velocities
    and aux states are f32 tuples in the graph's orders; the images are in
    the compute dtype. ``lr`` defaults to bench's for ``name``
    (:func:`bench_lr`)."""
    device = as_torch_device(device)
    data_shape = (batch, 3, image, image)
    if net is None:
        net = vision.get_model(name, classes=classes)
    prog, arg_shapes, aux_shapes = build_graph(net, data_shape)
    runner = mirror_wrap(prog.make_runner())
    rng = np.random.RandomState(seed)
    masters = tuple(torch.from_numpy(host_init(n, s, rng)).to(device)
                    for n, s in zip(prog.arg_names, arg_shapes))
    aux = tuple(torch.from_numpy(host_init(n, s, rng)).to(device)
                for n, s in zip(prog.aux_names, aux_shapes))
    images = rng.standard_normal(data_shape)
    images = (_bf16_from_f64(images) if compute_dtype == torch.bfloat16
              else torch.from_numpy(images).to(compute_dtype)).to(device)
    labels = torch.from_numpy(
        rng.randint(0, classes, (batch,)).astype(np.int32)).to(device)
    update = get_op('mp_sgd_mom_update').fn
    attrs = dict(TRAIN_ATTRS, lr=bench_lr(name) if lr is None else lr)
    data_idx = prog.arg_names.index('data')

    def step(masters, aux, vel, images, labels):
        loss, grads, new_aux = loss_and_grads(runner, prog, masters, aux,
                                              images, labels, compute_dtype)
        new_m, new_v = [], []
        with torch.no_grad():
            for i, (m, g, v) in enumerate(zip(masters, grads, vel)):
                if i == data_idx:
                    new_m.append(m)
                    new_v.append(v)
                    continue
                _, nv, m32 = update(attrs, m.to(compute_dtype), g, v, m)
                new_m.append(m32)
                new_v.append(nv)
        return tuple(new_m), new_aux, tuple(new_v), loss

    vel = tuple(torch.zeros_like(m) for m in masters)
    return step, masters, aux, vel, images, labels, prog
