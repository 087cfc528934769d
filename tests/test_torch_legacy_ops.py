"""The port's legacy names (mxnet_tpu_torch.ops.legacy_ops) against the JAX
package's, and the registry as a whole, on the CPU.

- Each alias of ``mxnet_tpu/ops/legacy_ops.py`` whose target the port has
  is the same OpDef as that target, as in the JAX registry.
- The port's ``list_ops()`` is the JAX registry's (``import mxnet_tpu``
  imports every ops module): all 359 names. ``WAITING``, the names that
  waited for later slices, is empty.
- ``Convolution_v1`` against the JAX op (values and gradients, f32: rtol
  1e-5, atol 1e-5 x the largest |jax| value, sums in another order);
  ``_CrossDeviceCopy`` is the identity and ``_NoGradient`` passes no
  gradient, in both packages.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ops import legacy_ops as jlegacy
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.ops import legacy_ops as tlegacy
from mxnet_tpu_torch.ops import registry as treg

# the JAX registry's names that later slices bring, by what brings them:
# none since sparse storage and the contrib ops came
WAITING = {}


def test_every_jax_name_is_registered_but_the_waiting_ones():
    jax_names, port_names = set(jreg.list_ops()), set(treg.list_ops())
    assert port_names <= jax_names
    assert jax_names - port_names == set(WAITING)
    # every name of the JAX registry, and no other
    assert port_names == jax_names and len(port_names) == 359


@pytest.mark.parametrize('alias', sorted(jlegacy._ALIASES))
def test_alias_is_its_targets_opdef(alias):
    target = jlegacy._ALIASES[alias]
    assert jreg.get(alias) is jreg.get(target)
    if alias in WAITING:
        assert not treg.exists(alias)
        return
    assert tlegacy._ALIASES[alias] == target
    assert treg.get(alias) is treg.get(target)
    assert callable(getattr(nd, alias))


def test_every_alias_group_matches_jax():
    """Names that share an OpDef in the port share one in the JAX registry."""
    names = treg.list_ops()
    for group in jreg.op_alias_groups():
        kept = [n for n in group if n in names]
        assert len({id(treg.get(n)) for n in kept}) <= 1, kept


@pytest.mark.parametrize('no_bias', [False, True])
def test_convolution_v1_matches_jax(no_bias):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4, 7, 6).astype(np.float32)
    w = rng.randn(6, 2, 3, 3).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    attrs = {'kernel': (3, 3), 'stride': (2, 1), 'pad': (1, 0),
             'dilate': (1, 2), 'num_filter': 6, 'num_group': 2,
             'no_bias': no_bias}
    inputs = [x, w] if no_bias else [x, w, b]
    cot = rng.randn(2, 6, 4, 2).astype(np.float32)
    op = jreg.get('Convolution_v1')
    out, vjp = jax.vjp(lambda *a: op.fn(attrs, *a),
                       *[jnp.asarray(a) for a in inputs])
    want = [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(cot))]
    args = [torch.from_numpy(a).requires_grad_() for a in inputs]
    got = treg.get('Convolution_v1').fn(attrs, *args)
    grads = torch.autograd.grad(got, args, torch.from_numpy(cot))
    for g, w_ in zip([got] + list(grads), want):
        assert tuple(g.shape) == w_.shape
        np.testing.assert_allclose(g.detach().numpy(), w_, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w_).max()))
    t = treg.get('Convolution_v1')
    assert t.param_defaults == op.param_defaults
    assert t.arg_names({'no_bias': True}) == ['data', 'weight']


def test_cross_device_copy_and_no_gradient():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    for lib, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        a = lib.nd.array(x, ctx=ctx)
        a.attach_grad()
        with lib.autograd.record():
            y = (lib.nd._CrossDeviceCopy(a) * 2).sum() \
                + (lib.nd._NoGradient(a) * 3).sum()
        y.backward()
        np.testing.assert_array_equal(a.grad.asnumpy(), np.full((2, 3), 2.0))
        np.testing.assert_array_equal(
            lib.nd._NoGradient(a).asnumpy(), x)
    assert not treg.get('_NoGradient').differentiable


def test_legacy_names_through_nd():
    """A few of the aliases called through nd against the JAX package's."""
    a = np.array([[1.5, -2.0], [3.0, 0.5]], np.float32)
    b = np.array([[2.0, 4.0], [-1.0, 0.25]], np.float32)
    for name, kwargs, arrays in (('_Plus', {}, (a, b)),
                                 ('_RPowerScalar', {'scalar': 2.0}, (a,)),
                                 ('broadcast_minus', {}, (a, b[:1])),
                                 ('_broadcast_backward', {'axis': 0}, (a,)),
                                 ('_sparse_dot', {}, (a, b)),
                                 ('_sparse_slice', {'begin': (0, 1),
                                                    'end': (2, 2)}, (a,))):
        got = getattr(nd, name)(*[nd.array(x, ctx=mt.cpu()) for x in arrays],
                                **kwargs)
        want = getattr(mx.nd, name)(*[mx.nd.array(x) for x in arrays],
                                    **kwargs)
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-6,
                                   err_msg=name)
