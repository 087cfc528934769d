"""The port's optimizer stack (mxnet_tpu_torch.ops.optimizer_ops,
.optimizer, .lr_scheduler) against the JAX package's, on the CPU.

- The nine fused update ops against ``mxnet_tpu.ops.registry.get(name).fn``
  on the same numpy inputs, f32 and bf16 (the ``mp_`` ops: a bf16 weight
  and grad over f32 momentum and master), with ``wd``, ``rescale_grad``,
  ``clip_gradient`` (and ``clip_weights``) at their defaults and set; then
  ``mutate_inputs`` through ``nd`` (``out=weight`` rebinds the states).
- Every ported optimizer class over three updates of two parameters
  through ``get_updater``, against ``mxnet_tpu.optimizer`` driven the same
  way, with ``multi_precision`` on bf16 weights, a scheduler, weight decay
  and its multipliers, gradient rescaling and clipping.
- The schedulers, a ``get_states``/``set_states`` round trip, and SGLD's
  drift (its update less the noise, with ``nd.random.normal`` giving zeros
  on both sides) exactly; its noise is held by distribution in
  test_torch_random.py.

The JAX side of the optimizer runs in one jitted program (``mx.nd`` over
traced arrays), where eager mx.nd ops compile one program each.

Tolerances (|port - jax| <= atol + rtol * |jax|), with their reasons:
- f32: rtol 2e-6, atol 1e-7; both sides compute the same f32 steps, and
  XLA fuses a chain of them (square roots and quotients, as in Ftrl)
  with other roundings: a few f32 ulps;
- bf16: one bf16 ulp, rtol 2**-7 and atol 1e-6: both round each step to
  bf16, and XLA may keep an f32 intermediate between two fused steps;
- integer and bit-for-bit results (the schedulers, the states' round
  trip): exact.
"""
import functools
import pickle

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import lr_scheduler as jsched
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch import cpu, nd
from mxnet_tpu_torch import lr_scheduler as tsched
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.ops import registry as treg

UPDATE_OPS = ('sgd_update', 'sgd_mom_update', 'mp_sgd_update',
              'mp_sgd_mom_update', 'nag_mom_update', 'adam_update',
              'rmsprop_update', 'rmspropalex_update', 'ftrl_update')
SHAPE = (4, 6)
F32 = dict(rtol=2e-6, atol=1e-7)
BF16 = dict(rtol=2 ** -7, atol=1e-6)


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.float().numpy().astype(ml_dtypes.bfloat16)
        return x.numpy()
    return np.asarray(x)


def _to_torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))


def _close(got, want, what):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    tol = BF16 if want.dtype == ml_dtypes.bfloat16 else F32
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32),
                               err_msg=str(what), **tol)


def test_update_ops_are_registered_as_in_jax():
    for name in UPDATE_OPS:
        t, j = treg.get(name), jreg.get(name)
        assert t.input_names == j.input_names, name
        assert t.param_defaults == j.param_defaults, name
        assert t.mutate_inputs == j.mutate_inputs, name
        assert t.num_outputs == j.num_outputs, name
        assert t.num_visible_outputs == j.num_visible_outputs, name
        assert callable(getattr(nd, name)), name


# ---------------------------------------------------------------------------
# the update ops
# ---------------------------------------------------------------------------

def _op_inputs(name, dtype):
    """(array, dtype) of each input: the weight and grad in ``dtype``, the
    states in it too but f32 for the mp_ ops; the states that go under a
    square root (var, n) positive, and centered RMSProp's n above g**2."""
    rng = np.random.RandomState(UPDATE_OPS.index(name))
    out = []
    for inp in jreg.get(name).input_names:
        a = rng.standard_normal(SHAPE).astype(np.float32)
        if inp in ('var', 'n'):
            a = np.abs(a) + (1.0 if name == 'rmspropalex_update' else 0.1)
        elif inp == 'g':
            a = a * 0.1
        elif inp == 'grad':
            a = a * 0.6
        out.append((a, 'float32' if name.startswith('mp_') and inp in
                    ('mom', 'weight32') else dtype))
    return out


# clip_gradient 0.3 clips most of the grads (std 0.6 times rescale 0.5)
SET_ATTRS = {'wd': 0.01, 'rescale_grad': 0.5, 'clip_gradient': 0.3}


def _op_attrs(name, which):
    attrs = {'lr': 0.05}
    if which == 'set':
        attrs.update(SET_ATTRS)
        if 'clip_weights' in jreg.get(name).param_defaults:
            attrs['clip_weights'] = 0.8
        if 'momentum' in jreg.get(name).param_defaults:
            attrs['momentum'] = 0.9
    return attrs


OP_CASES = [(n, d, w) for n in UPDATE_OPS for d in ('float32', 'bfloat16')
            for w in ('defaults', 'set')]


@pytest.mark.parametrize('name,dtype,which', OP_CASES)
def test_update_op_matches_jax(name, dtype, which):
    """Every output (the weight and each state) in value and dtype."""
    arrays = _op_inputs(name, dtype)
    attrs = _op_attrs(name, which)
    got = treg.get(name).fn(dict(attrs), *(_to_torch(a, d) for a, d in arrays))
    want = jreg.get(name).fn(dict(attrs), *(jnp.asarray(a, getattr(jnp, d))
                                            for a, d in arrays))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want) == treg.get(name).n_outputs(attrs)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, (name, i))


def test_clip_gradient_only_when_positive():
    """clip_gradient clips only when it is > 0: -1 and 0 leave the grad."""
    w = torch.zeros(3)
    g = torch.tensor([-4.0, 0.5, 4.0])
    for c in (-1.0, 0.0):
        out = treg.get('sgd_update').fn({'lr': 1.0, 'clip_gradient': c}, w, g)
        assert out.tolist() == [4.0, -0.5, -4.0]
    out = treg.get('sgd_update').fn({'lr': 1.0, 'clip_gradient': 1.0}, w, g)
    assert out.tolist() == [1.0, -0.5, -1.0]


def test_mp_update_casts_the_grad_to_f32_first():
    """A bf16 grad of 1 + 2**-8 (exact in bf16) reaches the f32 master
    whole; the weight comes back in its own dtype."""
    w = torch.ones(2, dtype=torch.bfloat16)
    g = torch.full((2,), 1 + 2 ** -7, dtype=torch.bfloat16)
    w32 = torch.ones(2)
    w_out, w32_out = treg.get('mp_sgd_update').fn({'lr': 2 ** -10}, w, g, w32)
    assert w_out.dtype == torch.bfloat16 and w32_out.dtype == torch.float32
    assert w32_out.tolist() == [1 - 2 ** -10 - 2 ** -17] * 2


def test_mutate_inputs_through_nd():
    """``nd.sgd_mom_update(w, g, mom, out=w)`` writes the new momentum back
    into ``mom`` and returns ``w``; ``mp_sgd_mom_update`` rebinds the
    momentum and the f32 master too, as in mxnet_tpu.nd."""
    def steps(ndm, ctx, dtype):
        arrs = [ndm.array(a, ctx=ctx, dtype=d) for a, d in
                _op_inputs('mp_sgd_mom_update', dtype)]
        w, g, mom, w32 = arrs
        ret = ndm.mp_sgd_mom_update(w, g, mom, w32, out=w, lr=0.1, momentum=0.9)
        w2, g2, mom2 = (ndm.array(a, ctx=ctx) for a, _ in
                        _op_inputs('sgd_mom_update', 'float32'))
        ret2 = ndm.sgd_mom_update(w2, g2, mom2, out=w2, lr=0.1, momentum=0.9)
        return [ret is w, ret2 is w2], [w, mom, w32, w2, mom2]
    got_is, got = steps(nd, cpu(), 'bfloat16')
    want_is, want = steps(mx.nd, mx.cpu(), 'bfloat16')
    assert got_is == want_is == [True, True]
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.asnumpy(), w.asnumpy(), i)
        assert g.dtype == w.dtype, i


# ---------------------------------------------------------------------------
# the optimizer classes through Updater
# ---------------------------------------------------------------------------

NAMES = {0: 'fc_weight', 1: 'fc_bias'}


def _sched(mod):
    return mod.FactorScheduler(step=2, factor=0.5)


# (label, optimizer name, kwargs(lr_scheduler module), weight dtype)
OPT_CASES = [
    ('sgd', 'sgd', lambda s: {'learning_rate': 0.1}, 'float32'),
    ('sgd-momentum', 'sgd', lambda s: {'learning_rate': 0.1, 'momentum': 0.9,
                                       'wd': 0.01, 'rescale_grad': 0.5,
                                       'clip_gradient': 0.3}, 'float32'),
    ('sgd-mp', 'sgd', lambda s: {'learning_rate': 0.1, 'multi_precision': True},
     'bfloat16'),
    ('sgd-momentum-mp', 'sgd', lambda s: {'learning_rate': 0.1, 'momentum': 0.9,
                                          'wd': 0.01, 'multi_precision': True},
     'bfloat16'),
    ('sgd-bf16-no-mp', 'sgd', lambda s: {'learning_rate': 0.1, 'momentum': 0.9},
     'bfloat16'),
    ('sgd-scheduler', 'sgd', lambda s: {'learning_rate': 0.1, 'momentum': 0.9,
                                        'lr_scheduler': _sched(s)}, 'float32'),
    ('nag', 'nag', lambda s: {'learning_rate': 0.1, 'momentum': 0.9,
                              'wd': 0.01}, 'float32'),
    ('nag-no-momentum', 'nag', lambda s: {'learning_rate': 0.1}, 'float32'),
    ('dcasgd', 'dcasgd', lambda s: {'learning_rate': 0.1, 'wd': 0.01,
                                    'clip_gradient': 0.3}, 'float32'),
    ('ccsgd', 'ccsgd', lambda s: {'learning_rate': 0.1, 'momentum': 0.5},
     'float32'),
    ('adam', 'adam', lambda s: {'learning_rate': 0.01, 'wd': 0.01,
                                'clip_gradient': 0.3}, 'float32'),
    ('adam-mp', 'adam', lambda s: {'multi_precision': True}, 'bfloat16'),
    ('adagrad', 'adagrad', lambda s: {'learning_rate': 0.1, 'wd': 0.01,
                                      'clip_gradient': 0.3}, 'float32'),
    ('rmsprop', 'rmsprop', lambda s: {'learning_rate': 0.01, 'wd': 0.01},
     'float32'),
    ('rmsprop-clip-weights', 'rmsprop', lambda s: {
        'learning_rate': 0.1, 'clip_weights': 0.8, 'clip_gradient': 0.3},
     'float32'),
    ('rmsprop-centered', 'rmsprop', lambda s: {
        'learning_rate': 0.01, 'centered': True, 'clip_weights': 0.8},
     'float32'),
    ('adadelta', 'adadelta', lambda s: {'wd': 0.01, 'clip_gradient': 0.3},
     'float32'),
    ('ftrl', 'ftrl', lambda s: {'wd': 0.01, 'rescale_grad': 0.5}, 'float32'),
    ('adamax', 'adamax', lambda s: {'wd': 0.01, 'clip_gradient': 0.3},
     'float32'),
    ('nadam', 'nadam', lambda s: {'learning_rate': 0.01, 'wd': 0.01,
                                  'clip_gradient': 0.3}, 'float32'),
    ('nadam-mp', 'nadam', lambda s: {'multi_precision': True}, 'bfloat16'),
    ('test', 'test', lambda s: {'rescale_grad': 0.5}, 'float32'),
]
UPDATES = 3


def _opt_arrays(case):
    """(weights, grads of each update): two parameters, [4, 6] and [6]."""
    rng = np.random.RandomState(OPT_CASES.index(case))
    shapes = (SHAPE, SHAPE[1:])
    weights = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * 0.6).astype(np.float32) for s in shapes]
             for _ in range(UPDATES)]
    return weights, grads


def _flat(states):
    if states is None:
        return []
    if isinstance(states, (tuple, list)):
        return [x for s in states for x in _flat(s)]
    return [states]


def _drive(opt_mod, sched_mod, case, weights, grads):
    """UPDATES updates of every parameter through get_updater: returns the
    weights and every state NDArray, and the optimizer."""
    _, name, kwargs, _ = case
    opt = opt_mod.create(name, param_idx2name=dict(NAMES),
                         **kwargs(sched_mod))
    opt.set_lr_mult({'fc_bias': 2.0})
    updater = opt_mod.get_updater(opt)
    for gs in grads:
        for i, (w, g) in enumerate(zip(weights, gs)):
            updater(i, g, w)
    states = [x for i in sorted(updater.states)
              for x in _flat(updater.states[i])]
    return weights + states, opt


@functools.lru_cache(maxsize=None)
def _jax_updates():
    """Every case's JAX results, from one jitted program over mx.nd."""
    def run(datas):
        outs = []
        for case, (ws, gss) in zip(OPT_CASES, datas):
            def arr(d, dtype=case[3]):
                return mx.nd.NDArray(d.astype(getattr(jnp, dtype)), mx.cpu())
            res, _ = _drive(jopt, jsched, case, [arr(w) for w in ws],
                            [[arr(g) for g in gs] for gs in gss])
            outs.append([r._data for r in res])
        return outs
    datas = [([jnp.asarray(w) for w in ws],
              [[jnp.asarray(g) for g in gs] for gs in gss])
             for ws, gss in (_opt_arrays(c) for c in OPT_CASES)]
    return [[np.asarray(r.astype(jnp.float32)).astype(r.dtype)
             if r.dtype == jnp.bfloat16 else np.asarray(r) for r in rs]
            for rs in jax.jit(run)(datas)]


@pytest.mark.parametrize('case', OPT_CASES, ids=[c[0] for c in OPT_CASES])
def test_optimizer_matches_jax(case):
    """The weights and every state after three updates of two parameters
    (the bias with lr_mult 2 and, being no weight, wd_mult 0)."""
    weights, grads = _opt_arrays(case)
    dtype = case[3]
    res, opt = _drive(topt, tsched, case,
                      [nd.array(w, ctx=cpu(), dtype=dtype) for w in weights],
                      [[nd.array(g, ctx=cpu(), dtype=dtype) for g in gs]
                       for gs in grads])
    want = _jax_updates()[OPT_CASES.index(case)]
    assert len(res) == len(want)
    for i, (g, w) in enumerate(zip(res, want)):
        _close(g.handle, w, (case[0], i))
    # Test's update counts nothing, in both packages
    assert opt.num_update == (0 if case[1] == 'test' else UPDATES)
    assert opt.wd_mult == {'fc_bias': 0.0} and opt.lr_mult == {'fc_bias': 2.0}


def test_multi_precision_keeps_an_f32_master():
    """A bf16 weight under multi_precision gets an (f32 master, state)
    pair; the weight is the master rounded to bf16."""
    opt = topt.create('sgd', learning_rate=0.1, momentum=0.9,
                      multi_precision=True)
    updater = topt.get_updater(opt)
    w = nd.array(np.linspace(-1, 1, 6), ctx=cpu(), dtype='bfloat16')
    g = nd.array(np.full(6, 0.3), ctx=cpu(), dtype='bfloat16')
    updater(0, g, w)
    master, mom = updater.states[0]
    assert str(master.dtype) == str(mom.dtype) == 'float32'
    assert str(w.dtype) == 'bfloat16'
    assert torch.equal(w.handle, master.handle.to(torch.bfloat16))


def test_registry_and_learning_rate():
    assert set(topt.Optimizer.opt_registry) == set(jopt.Optimizer.opt_registry)
    assert isinstance(topt.create('SGD'), topt.SGD)
    assert isinstance(topt.create('ccsgd'), topt.SGD)
    with pytest.raises(ValueError, match='Cannot find optimizer'):
        topt.create('nope')
    opt = topt.create('sgd', learning_rate=0.5)
    opt.set_learning_rate(0.25)
    assert opt.lr == 0.25
    with pytest.raises(DeprecationWarning):
        opt.set_lr_scale({0: 2.0})
    opt = topt.create('sgd', lr_scheduler=tsched.FactorScheduler(1))
    with pytest.raises(UserWarning):
        opt.set_learning_rate(0.1)

    @topt.register
    class MyOpt(topt.SGD):
        pass
    try:
        assert isinstance(topt.create('myopt'), MyOpt)
    finally:
        del topt.Optimizer.opt_registry['myopt']


def test_sgld_waits_for_the_random_ops(monkeypatch):
    """SGLD runs now that the random ops are ported: two updates' drift
    (the noise drawn as zeros on both sides) equals the JAX package's bit
    for bit, with weight decay, rescaling and clipping."""
    import mxnet_tpu.ndarray.random as jrandom
    from mxnet_tpu_torch.ndarray import random as trandom
    monkeypatch.setattr(jrandom, 'normal', lambda loc, scale, shape, dtype,
                        **kw: mx.nd.zeros(shape, dtype=dtype))
    monkeypatch.setattr(trandom, 'normal', lambda loc, scale, shape, dtype,
                        **kw: nd.zeros(shape, ctx=kw['ctx'], dtype=dtype))
    rng = np.random.RandomState(7)
    w0, g0, g1 = (rng.randn(*SHAPE).astype(np.float32) for _ in range(3))
    kw = dict(learning_rate=0.1, wd=0.01, rescale_grad=0.5,
              clip_gradient=0.8)
    jo, to = jopt.create('sgld', **kw), topt.create('sgld', **kw)
    jw, tw = mx.nd.array(w0), nd.array(w0, ctx=cpu())
    for g in (g0, g1):
        jo.update(0, jw, mx.nd.array(g), None)
        to.update(0, tw, nd.array(g, ctx=cpu()), None)
    np.testing.assert_array_equal(tw.asnumpy(), jw.asnumpy())


@pytest.mark.parametrize('name,dump', [('sgd', False), ('adam', True)])
def test_get_states_set_states_round_trip(name, dump):
    """An updater resumed from another's states after one update agrees
    with it bit for bit after the next. The states alone carry SGD's
    momentum; Adam's per-index step counts live in the optimizer, which
    ``dump_optimizer`` carries along."""
    weights, grads = _opt_arrays(OPT_CASES[10])

    kwargs = {'learning_rate': 0.01, 'momentum': 0.9} if name == 'sgd' else {}

    def fresh():
        return ([nd.array(w, ctx=cpu()) for w in weights],
                topt.get_updater(topt.create(name, **kwargs)))
    ws_a, up_a = fresh()
    for i, w in enumerate(ws_a):
        up_a(i, nd.array(grads[0][i], ctx=cpu()), w)
    blob = up_a.get_states(dump_optimizer=dump)
    assert isinstance(pickle.loads(blob), tuple) == dump
    ws_b, up_b = fresh()
    for w_b, w_a in zip(ws_b, ws_a):
        w_b[:] = w_a
    up_b.set_states(blob)
    assert up_b.states_synced == {0: False, 1: False}
    for ws, up in ((ws_a, up_a), (ws_b, up_b)):
        for i, w in enumerate(ws):
            up(i, nd.array(grads[1][i], ctx=cpu()), w)
    for a, b in zip(ws_a + _flat(list(up_a.states.values())),
                    ws_b + _flat(list(up_b.states.values()))):
        assert torch.equal(a.handle, b.handle)


# ---------------------------------------------------------------------------
# the schedulers
# ---------------------------------------------------------------------------

SCHEDULERS = [
    ('factor', lambda m: m.FactorScheduler(step=3, factor=0.5)),
    ('factor-stop', lambda m: m.FactorScheduler(step=1, factor=0.1,
                                                stop_factor_lr=1e-4)),
    ('multifactor', lambda m: m.MultiFactorScheduler(step=[2, 5, 9],
                                                     factor=0.5)),
    ('poly', lambda m: m.PolyScheduler(max_update=10, base_lr=0.1, pwr=2)),
]


@pytest.mark.parametrize('make', [s[1] for s in SCHEDULERS],
                         ids=[s[0] for s in SCHEDULERS])
def test_scheduler_matches_jax(make):
    t, j = make(tsched), make(jsched)
    t.base_lr = j.base_lr = 0.1      # as Optimizer sets it from learning_rate
    assert [t(n) for n in range(14)] == [j(n) for n in range(14)]


@pytest.mark.parametrize('bad', [
    lambda m: m.FactorScheduler(step=0), lambda m: m.FactorScheduler(2, 1.5),
    lambda m: m.MultiFactorScheduler([3, 2]),
    lambda m: m.MultiFactorScheduler([0, 2]), lambda m: m.PolyScheduler(0)])
def test_scheduler_rejects_what_jax_rejects(bad):
    with pytest.raises(ValueError):
        bad(jsched)
    with pytest.raises(ValueError):
        bad(tsched)
