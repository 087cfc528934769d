"""The port's training step (mxnet_tpu_torch.transformer.make_train_step)
against bench.py's own: the ``step`` that ``bench.build_transformer_step()``
returns, jitted, at the small width of test_torch_transformer.py (D=256,
2 layers, S=128, V=512, batch 1) set through bench's environment variables.
bench's attention is the Pallas flash kernel in interpret mode, its
backward jax.vjp of the plain formulation; the port's is the flash
wrapper, which on the CPU runs its plain version under the autograd
Function whose backward recomputes through it. Both draw their masters and
batch from seed 0; both update each master with their registry's
``mp_sgd_mom_update`` (lr 0.01, momentum 0.9).

Tolerances, with their reasons: the two frameworks compute the forward and
backward in bf16 and round at different places (attention in f32 vs bf16
inputs, the GELU, the matmul accumulation order, the embedding's bf16
scatter-add), so each bf16 gradient differs by about one bf16 ulp per
element (2**-8 relative; the relative RMS of the velocities, which are
-lr * grad after step 1, measured 6e-3-1.4e-2):
- the loss of each step: rtol 2e-3 (a mean over 128 rows of f32
  logsumexp - gold; measured 9e-5-4.4e-4);
- the velocities and the update each master took (master - initial
  master), per tensor: a relative RMS error of at most 3e-2.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax

from mxnet_tpu_torch import nd, optimizer
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.transformer import (TRAIN_ATTRS, TransformerConfig,
                                         loss_and_grads, make_train_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {'MXTPU_BENCH_DMODEL': '256', 'MXTPU_BENCH_LAYERS': '2',
         'MXTPU_BENCH_SEQ': '128', 'MXTPU_BENCH_VOCAB': '512',
         'MXTPU_BENCH_BATCH': '1'}
CFG = TransformerConfig(vocab=512, d_model=256, n_layers=2, seq_len=128)
STEPS = 3
LOSS_RTOL = 2e-3
REL_RMS = 3e-2


def _run(step, masters, aux, vel, *batch):
    """(loss, masters, velocities) after each of STEPS steps, as numpy."""
    out = []
    for _ in range(STEPS):
        masters, aux, vel, loss = step(masters, aux, vel, *batch)
        out.append((float(loss), [np.asarray(m) for m in masters],
                    [np.asarray(v) for v in vel]))
    return out


@pytest.fixture(scope='module')
def runs():
    """bench's and the port's three steps, and the initial masters."""
    spec = importlib.util.spec_from_file_location(
        '_bench_under_test', os.path.join(ROOT, 'bench.py'))
    bench = importlib.util.module_from_spec(spec)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in SMALL.items():
            mp.setenv(k, v)
        spec.loader.exec_module(bench)
        step, masters, aux, vel, tokens, labels, key = \
            bench.build_transformer_step()
    jstep = jax.jit(step)
    want = _run(lambda m, a, v, t, l: jstep(m, a, v, t, l, key),
                masters, aux, vel, tokens, labels)
    tstep, tmasters, taux, tvel, ttokens, tlabels = make_train_step(
        CFG, 1, device='cpu')
    got = _run(tstep, tmasters, taux, tvel, ttokens, tlabels)
    batch = (np.asarray(tokens), np.asarray(labels), ttokens.numpy(),
             tlabels.numpy())
    return want, got, [np.asarray(m) for m in masters], \
        [m.numpy() for m in tmasters], batch


def _rel_rms(got, want):
    return float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))


def test_masters_and_batch_are_bench(runs):
    """make_train_step draws bench's masters and batch."""
    _, _, jmasters, tmasters, (jt, jl, tt, tl) = runs
    assert len(tmasters) == len(jmasters) == 3 + 6 * CFG.n_layers
    for a, b in zip(tmasters, jmasters):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tl, jl)
    assert tt.dtype == tl.dtype == np.int32


@pytest.mark.parametrize('step', range(1, STEPS + 1))
def test_loss_matches_bench(runs, step):
    want, got, *_ = runs
    np.testing.assert_allclose(got[step - 1][0], want[step - 1][0],
                               rtol=LOSS_RTOL)


def test_loss_falls(runs):
    _, got, *_ = runs
    losses = [g[0] for g in got]
    assert losses[0] > losses[1] > losses[2], losses


@pytest.mark.parametrize('step', [1, STEPS])
def test_masters_and_velocities_match_bench(runs, step):
    want, got, m0, *_ = runs
    _, jm, jv = want[step - 1]
    _, tm, tv = got[step - 1]
    for i, (a, b, c, d, init) in enumerate(zip(tm, jm, tv, jv, m0)):
        assert a.dtype == c.dtype == np.float32 and a.shape == b.shape
        assert _rel_rms(a - init, b - init) <= REL_RMS, ('master', i)
        assert _rel_rms(c, d) <= REL_RMS, ('velocity', i)


def test_updater_step_equals_the_registry_step():
    """The user-facing route, optimizer.create('sgd', momentum=0.9,
    learning_rate=0.01, multi_precision=True) with get_updater over
    NDArrays of the bf16 weights, with the f32 masters as its master
    state, takes the update the step takes (the registry op with
    TRAIN_ATTRS) on the same gradients: bit for bit."""
    _, masters, _, vel, tokens, labels = make_train_step(CFG, 1, device='cpu')
    params = tuple(m.to(torch.bfloat16).requires_grad_() for m in masters)
    _, grads = loss_and_grads(params, tokens, labels)
    update = treg.get('mp_sgd_mom_update').fn
    new_m, new_v = [], []
    for p, g, v, m in zip(params, grads, vel, masters):
        _, nv, m32 = update(TRAIN_ATTRS, p.detach(), g, v, m)
        new_m.append(m32)
        new_v.append(nv)
    opt = optimizer.create('sgd', momentum=TRAIN_ATTRS['momentum'],
                           learning_rate=TRAIN_ATTRS['lr'],
                           multi_precision=True)
    updater = optimizer.get_updater(opt)
    weights = [nd.from_torch(p.detach()) for p in params]
    for i, (w, m, v) in enumerate(zip(weights, masters, vel)):
        updater.states[i] = (nd.from_torch(m.clone()), nd.from_torch(v.clone()))
        updater(i, nd.from_torch(grads[i]), w)
    for i, w in enumerate(weights):
        w32, mom = updater.states[i]
        assert torch.equal(w32.handle, new_m[i]), i
        assert torch.equal(mom.handle, new_v[i]), i
        assert w.handle.dtype == torch.bfloat16
        assert torch.equal(w.handle, new_m[i].to(torch.bfloat16)), i
