"""The port's flash attention (mxnet_tpu_torch.ops.cuda_kernels) against the
JAX package's Pallas kernel, run in interpret mode on the CPU as
tests/unittest/test_pallas.py runs it.

On the CPU the port's wrapper runs its plain PyTorch version, so these tests
hold that version, and the autograd Function around it, to the reference:
out, lse and gradients, decode shapes (Tq < Tk), a ragged T = 2 * 503, and
the empty and raising cases. The CUDA kernel itself is held against the
same plain version on the card by chip_smoke.py.

Tolerances: f32 on both sides with the sums taken in another order, 2e-5
for out and lse (the JAX package's own kernel-test tolerance) and 1e-4 for
gradients (test_pallas.py's, a backward adds a second reordered sum).
float16 inputs: both sides compute in f32 and round the output to f16 once,
so the outputs agree within one f16 ulp (rtol 2**-10; atol 1e-6 for f16's
subnormals) and the f32 lse within 2e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu_torch.ops import cuda_kernels as ck

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(B, Tq, Tk, H, D, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((B, Tq, H, D)).astype(np.float32),
            rng.standard_normal((B, Tk, H, D)).astype(np.float32),
            rng.standard_normal((B, Tk, H, D)).astype(np.float32))


def _both_lse(arrays, causal, scale=None):
    jq, jk, jv = (jnp.asarray(a) for a in arrays)
    j_out, j_lse = pk.flash_attention_lse(jq, jk, jv, causal, scale, 32, 32)
    t_out, t_lse = ck.flash_attention_lse(
        *(torch.from_numpy(a) for a in arrays), causal, scale)
    return (np.asarray(j_out), np.asarray(j_lse)), (t_out.numpy(), t_lse.numpy())


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('B,Tq,Tk,H,D', [
    (1, 64, 64, 2, 16),
    (2, 32, 128, 2, 16),      # decode shape: the mask is aligned bottom-right
    (2, 1, 32, 2, 8),         # one query row against a cache
    (1, 1006, 1006, 1, 8),    # 2 * 503 rows: the TPU pads q here
])
def test_forward_and_lse_match_pallas(causal, B, Tq, Tk, H, D):
    (j_out, j_lse), (t_out, t_lse) = _both_lse(_inputs(B, Tq, Tk, H, D), causal)
    assert t_out.shape == j_out.shape and t_lse.shape == j_lse.shape == (B, H, Tq)
    np.testing.assert_allclose(t_out, j_out, **FWD_TOL)
    np.testing.assert_allclose(t_lse, j_lse, **FWD_TOL)


@pytest.mark.parametrize('causal', [False, True])
def test_float16_matches_pallas(causal):
    """float16 runs (the JAX kernel takes any float type; the card's kernel
    takes f16 in its scalar body) and gives f16 out, f32 lse."""
    arrays = [a.astype(np.float16) for a in _inputs(2, 40, 40, 2, 16, seed=5)]
    j_out, j_lse = pk.flash_attention_lse(*(jnp.asarray(a) for a in arrays),
                                          causal, None, 32, 32)
    t_out, t_lse = ck.flash_attention_lse(*(torch.from_numpy(a) for a in arrays),
                                          causal)
    assert t_out.dtype == torch.float16 and np.asarray(j_out).dtype == np.float16
    np.testing.assert_allclose(t_out.numpy().astype(np.float32),
                               np.asarray(j_out).astype(np.float32),
                               rtol=2 ** -10, atol=1e-6)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), **FWD_TOL)


def test_explicit_scale_and_out_only_entry():
    arrays = _inputs(1, 16, 48, 2, 16, seed=4)
    (j_out, j_lse), (t_out, t_lse) = _both_lse(arrays, True, scale=0.3)
    np.testing.assert_allclose(t_out, j_out, **FWD_TOL)
    np.testing.assert_allclose(t_lse, j_lse, **FWD_TOL)
    out = ck.flash_attention(*(torch.from_numpy(a) for a in arrays), True, 0.3,
                             block_q=7, block_k=5)   # advisory, as on the TPU
    np.testing.assert_allclose(out.numpy(), j_out, **FWD_TOL)


@pytest.mark.parametrize('with_lse,Tq,Tk', [(False, 32, 32), (True, 16, 32)])
def test_gradients_match_pallas(with_lse, Tq, Tk):
    arrays = _inputs(1, Tq, Tk, 2, 8, seed=1)
    w = np.random.RandomState(2).standard_normal((1, 2, Tq)).astype(np.float32)

    def j_loss(q, k, v):
        if with_lse:
            out, lse = pk.flash_attention_lse(q, k, v, True, None, 16, 16)
            return jnp.sum(out ** 2) + jnp.sum(lse * w)
        return jnp.sum(pk.flash_attention(q, k, v, True, None, 16, 16) ** 2)

    j_grads = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(a) for a in arrays))
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    if with_lse:
        out, lse = ck.flash_attention_lse(*leaves, True)
        loss = (out ** 2).sum() + (lse * torch.from_numpy(w)).sum()
    else:
        loss = (ck.flash_attention(*leaves, True) ** 2).sum()
    loss.backward()
    for t, j in zip(leaves, j_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **GRAD_TOL)


@pytest.mark.parametrize('q_shape,kv_shape', [
    ((0, 8, 2, 4), (0, 8, 2, 4)),     # B = 0
    ((2, 8, 0, 4), (2, 8, 0, 4)),     # H = 0
    ((2, 0, 2, 4), (2, 8, 2, 4)),     # Tq = 0
])
def test_empty_inputs_give_zeros(q_shape, kv_shape):
    j_out, j_lse = pk.flash_attention_lse(jnp.zeros(q_shape), jnp.zeros(kv_shape),
                                          jnp.zeros(kv_shape), True)
    before = ck.flash_fwd.launches
    out, lse = ck.flash_attention_lse(torch.zeros(q_shape), torch.zeros(kv_shape),
                                      torch.zeros(kv_shape), True)
    assert tuple(out.shape) == j_out.shape and tuple(lse.shape) == j_lse.shape
    assert not out.any() and not lse.any() and lse.dtype == torch.float32
    assert ck.flash_fwd.launches == before


@pytest.mark.parametrize('q_shape,kv_shape,causal,match', [
    ((1, 8, 2, 4), (1, 4, 2, 4), True, 'Tq <= Tk'),
    ((1, 8, 2, 4), (1, 0, 2, 4), False, 'at least one key'),
])
def test_raises_like_pallas(q_shape, kv_shape, causal, match):
    with pytest.raises(ValueError, match=match):
        pk.flash_attention(jnp.zeros(q_shape), jnp.zeros(kv_shape),
                           jnp.zeros(kv_shape), causal)
    with pytest.raises(ValueError, match=match):
        ck.flash_attention(torch.zeros(q_shape), torch.zeros(kv_shape),
                           torch.zeros(kv_shape), causal)


def test_no_fallback_off_the_cpu():
    """Tensors that are neither on the CPU nor on a card raise rather than
    run the plain version; mismatched shapes raise before any launch."""
    q = torch.zeros((1, 4, 2, 8), device='meta')
    with pytest.raises(ValueError, match='CUDA tensors'):
        ck.flash_attention(q, q, q)
    with pytest.raises(ValueError, match='shape mismatch'):
        ck.flash_attention(torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 2, 8),
                           torch.zeros(1, 4, 2, 16))


def test_kernel_body_choice():
    """The mma.sync body takes bf16 at D in {16, 32, 64, 128} with 16-byte
    aligned rows, as the served model's q/k/v views are; everything else
    goes to the scalar body."""
    qkv = torch.zeros(2, 8, 4, 3 * 128, dtype=torch.bfloat16)
    q, k, v = qkv.split(128, dim=-1)
    assert ck._variant(q, k, v) == 1
    assert ck._variant(q.float(), k.float(), v.float()) == 0
    odd = torch.zeros(2, 8, 4, 40, dtype=torch.bfloat16)
    assert ck._variant(odd, odd, odd) == 0
