"""The port's row kernels (mxnet_tpu_torch.ops.cuda_kernels: layernorm,
rmsnorm, softmax, softmax cross-entropy) against the JAX package's Pallas
kernels, run in interpret mode on the CPU as tests/unittest/test_pallas.py
runs them, and their gradients against jax.grad through the kernels'
custom_vjp.

On the CPU each wrapper runs its plain PyTorch version, so these tests hold
that version, and the autograd Function around it, to the reference: f32
and bf16, N in {0, 7, 1006} (1006 = 2 * 503 rows, which the TPU pads),
labels outside [0, V), and gamma/beta in a dtype other than x's. The CUDA
kernels are held against the same plain versions on the card by
chip_smoke.py.

Tolerances (|port - jax| <= atol + rtol * |jax|), with their reasons:
- f32 outputs: 1e-5 / 1e-5, test_pallas.py's own for these kernels: both
  sides compute in f32 with the row sums taken in another order.
- bf16 outputs: rtol 2**-7, one bf16 ulp of the value (2**-8 relative, up
  to 2**-7 just above a power of two): both sides round an f32 result
  once, and a few f32 ulps of difference can land on either side of a
  rounding boundary. atol 1e-5 for values near zero.
- f32 gradients: 1e-4 / 1e-4, test_pallas.py's: a backward adds a second
  reordered sum.
- bf16 gradients: rtol 2**-6 and atol 2**-6 * max|grad| (two bf16
  roundings in the chain: the cotangent's and the gradient's, plus the
  softmax backward's bf16 row sum).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu_torch.ops import cuda_kernels as ck

TOL = {'float32': dict(rtol=1e-5, atol=1e-5),
       'bfloat16': dict(rtol=2 ** -7, atol=1e-5)}
GRAD_RTOL = {'float32': 1e-4, 'bfloat16': 2 ** -6}
D = 32
V = 50
# (dtype, N) of the forward-only cases: 0 is the empty batch (no launch),
# 1006 = 2 * 503. N = 7 is covered, in f32 and bf16, with the gradients.
CASES = [('float32', 0), ('float32', 1006), ('bfloat16', 0)]


def _both(a, dtype):
    """numpy ``a`` as a (jax, torch) pair of ``dtype``."""
    return (jnp.asarray(a, dtype=getattr(jnp, dtype)),
            torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype)))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, dtype):
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def _grad_close(got, want, dtype):
    got, want = _np(got), _np(want)
    rtol = GRAD_RTOL[dtype]
    atol = rtol * max(float(np.abs(want).max()), 1.0) if dtype == 'bfloat16' \
        else rtol
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _norm_inputs(N, seed=0, mean=0.0):
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal((N, D)) * 1.5 + mean).astype(np.float32)
    g = (rng.standard_normal(D) * 0.5 + 1).astype(np.float32)
    b = (rng.standard_normal(D) * 0.1).astype(np.float32)
    return x, g, b


def _xent_inputs(N, seed=0):
    rng = np.random.RandomState(seed)
    logits = (rng.standard_normal((N, V)) * 2).astype(np.float32)
    labels = rng.randint(0, V, N).astype(np.int32)
    if N >= 4:
        labels[1], labels[3] = -1, V       # match no column: loss = lse
    return logits, labels


def _case(kernel, dtype, N, seed=0):
    """(jax_fn, port_fn, jax_args, port_args) of one kernel: x in
    ``dtype`` with f32 gamma and beta; the labels close over the function,
    so the arguments are the differentiable inputs."""
    if kernel == 'softmax_xent':
        logits, labels = _xent_inputs(N, seed)
        (jl, tl), (jlab, tlab) = _both(logits, dtype), _both(labels, 'int32')
        return (lambda l: pk.softmax_xent(l, jlab),
                lambda l: ck.softmax_xent(l, tlab), [jl], [tl])
    x, g, b = _norm_inputs(N, seed)
    pairs = [_both(x, dtype), _both(g, 'float32'), _both(b, 'float32')]
    n_args = {'layernorm': 3, 'rmsnorm': 2, 'softmax': 1}[kernel]
    jax_fn = {'layernorm': pk.fused_layernorm, 'rmsnorm': pk.fused_rmsnorm,
              'softmax': pk.fused_softmax}[kernel]
    port_fn = {'layernorm': ck.fused_layernorm, 'rmsnorm': ck.fused_rmsnorm,
               'softmax': ck.fused_softmax}[kernel]
    return (jax_fn, port_fn, [p[0] for p in pairs[:n_args]],
            [p[1] for p in pairs[:n_args]])


KERNELS = ['layernorm', 'rmsnorm', 'softmax', 'softmax_xent']


@pytest.mark.parametrize('dtype,N', CASES)
@pytest.mark.parametrize('kernel', KERNELS)
def test_forward_matches_pallas(kernel, dtype, N):
    jax_fn, port_fn, jargs, targs = _case(kernel, dtype, N)
    got = port_fn(*targs)
    want = jax_fn(*jargs)
    if kernel == 'softmax_xent':
        assert got.dtype == torch.float32 and tuple(got.shape) == (N,)
        _close(got, want, 'float32')
    else:
        assert got.dtype == targs[0].dtype
        _close(got, want, dtype)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('kernel', KERNELS)
def test_forward_and_gradients_match_jax(kernel, dtype):
    """N = 7: the output, and the gradient of every differentiable input
    for a fixed cotangent, against jax.vjp through the kernel's
    custom_vjp (one jitted call for both)."""
    jax_fn, port_fn, jargs, targs = _case(kernel, dtype, 7, seed=1)
    out_shape = (7,) if kernel == 'softmax_xent' else (7, D)
    w = np.random.RandomState(2).standard_normal(out_shape).astype(np.float32)

    @jax.jit
    def jax_vjp(*args):
        out, vjp = jax.vjp(jax_fn, *args)
        return out, vjp(jnp.asarray(w, out.dtype))

    want_out, want_grads = jax_vjp(*jargs)
    leaves = [t.clone().requires_grad_() for t in targs]
    out = port_fn(*leaves)
    out.backward(torch.from_numpy(w).to(out.dtype))
    _close(out, want_out, 'float32' if kernel == 'softmax_xent' else dtype)
    for leaf, want in zip(leaves, want_grads):
        assert leaf.grad.dtype == leaf.dtype
        _grad_close(leaf.grad, want, dtype)


def test_xent_label_outside_the_row_gives_the_logsumexp():
    logits, labels = _xent_inputs(7, seed=4)
    loss = ck.softmax_xent_ref(torch.from_numpy(logits), torch.from_numpy(labels))
    lse = torch.logsumexp(torch.from_numpy(logits), -1)
    np.testing.assert_allclose(loss[[1, 3]].numpy(), lse[[1, 3]].numpy(),
                               rtol=1e-6)
    # an int64 label tensor gives the same losses as int32
    loss64 = ck.softmax_xent(torch.from_numpy(logits),
                             torch.from_numpy(labels).long())
    np.testing.assert_array_equal(loss64.numpy(), loss.numpy())


@pytest.mark.parametrize('x_dtype,g_dtype,b_dtype', [
    ('bfloat16', 'float32', 'float32'),
    ('float32', 'bfloat16', 'float16'),
])
def test_norm_params_in_another_dtype(x_dtype, g_dtype, b_dtype):
    """gamma and beta are read as f32 whatever their dtype; the output
    keeps x's."""
    x, g, b = _norm_inputs(7, seed=5)
    (jx, tx), (jg, tg), (jb, tb) = _both(x, x_dtype), _both(g, g_dtype), \
        _both(b, b_dtype)
    ln = ck.fused_layernorm(tx, tg, tb)
    rms = ck.fused_rmsnorm(tx, tg)
    assert ln.dtype == rms.dtype == tx.dtype
    _close(ln, pk.fused_layernorm(jx, jg, jb), x_dtype)
    _close(rms, pk.fused_rmsnorm(jx, jg), x_dtype)


def test_layernorm_variance_is_two_pass():
    """Rows with a mean of 1000 and a spread of 1.5: mean((x - mu)^2) keeps
    the variance, where E[x^2] - mu^2 in f32 loses 8% of it and moves y by
    7e-2. Held to float64 and to the Pallas kernel within 1e-3: an f32 row
    sum near 32000 rounds at 2**-9 an add, so the mean may be off by ~1e-4,
    which moves (x - mu) * rstd * gamma (rstd 0.67, |gamma| < 2.5) by a
    few 1e-4."""
    x, g, b = _norm_inputs(7, seed=6, mean=1000.0)
    got = ck.fused_layernorm(*(torch.from_numpy(a) for a in (x, g, b)))
    x64 = x.astype(np.float64)
    y64 = (x64 - x64.mean(-1, keepdims=True)) / np.sqrt(
        x64.var(-1, keepdims=True) + 1e-5) * g + b
    np.testing.assert_allclose(got.numpy(), y64, rtol=0, atol=1e-3)
    want = pk.fused_layernorm(*(jnp.asarray(a) for a in (x, g, b)))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-3)


def test_wrappers_refuse_what_they_do_not_take():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match='0-d'):
        ck.softmax_fwd(torch.zeros(()))
    with pytest.raises(ValueError, match='labels must have shape'):
        ck.softmax_xent_fwd(x, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match='V = 0'):
        ck.softmax_xent_fwd(torch.zeros(4, 0), torch.zeros(4, dtype=torch.int32))
    # neither CUDA nor CPU: no quiet fallback to the plain version
    with pytest.raises(ValueError, match='CUDA tensors'):
        ck.layernorm_fwd(x.to('meta'), torch.ones(8), torch.zeros(8))
    with pytest.raises(ValueError, match='CUDA tensors'):
        ck.softmax_fwd(x.to('meta'))


def test_empty_rows_count_no_launch():
    before = (ck.layernorm_fwd.launches, ck.rmsnorm_fwd.launches,
              ck.softmax_fwd.launches, ck.softmax_xent_fwd.launches)
    x = torch.zeros(0, 5, 8)
    assert ck.fused_layernorm(x, torch.ones(8), torch.zeros(8)).shape == x.shape
    assert ck.fused_rmsnorm(x, torch.ones(8)).shape == x.shape
    assert ck.fused_softmax(x).shape == x.shape
    assert ck.softmax_xent(torch.zeros(0, 8),
                           torch.zeros(0, dtype=torch.int32)).shape == (0,)
    # the plain versions run here: no kernel was launched
    assert (ck.layernorm_fwd.launches, ck.rmsnorm_fwd.launches,
            ck.softmax_fwd.launches, ck.softmax_xent_fwd.launches) == before


# (D, dtype, offset, whether the rows fit a register row): rows of whole
# 16-byte vectors up to 4 KB that start 16-byte aligned take LayerNorm's warp
# body and the ring body of softmax and RMSNorm, every other row the block
# body.
_BODY_ROWS = [
    (1024, 'bfloat16', False, True),
    (2048, 'bfloat16', False, True),     # 4 KB rows: the register bodies' widest
    (1000, 'bfloat16', False, True),     # 125 vectors: the last lanes masked
    (1024, 'float32', False, True),
    (50, 'bfloat16', False, False),      # 100-byte rows: not whole vectors
    (4096, 'bfloat16', False, False),    # 8 KB rows: past the registers
    (1024, 'bfloat16', True, False),     # rows start 2 bytes past 16
]
_PICKERS = {'layernorm': (ck._layernorm_body, 'warp'),
            'softmax': (ck._row_body, 'ring'),
            'rmsnorm': (ck._row_body, 'ring')}


@pytest.mark.parametrize('D,dtype,offset,fits', _BODY_ROWS)
@pytest.mark.parametrize('kernel', list(_PICKERS))
def test_body_choice(kernel, D, dtype, offset, fits):
    """Which body a call on the card takes, from the contiguous input's
    dtype, row width and base address (no launch here)."""
    flat = torch.empty(4 * D + 1, dtype=getattr(torch, dtype))
    x = (flat[1:] if offset else flat[:4 * D]).view(4, D)
    pick, register_body = _PICKERS[kernel]
    assert pick(x) == (register_body if fits else 'block')


def _edge_rows(kernel, case):
    """x (numpy f32) with the edge rows of ``case``: a causal score block
    [2, 16, 16] with the upper triangle -inf, or 8 rows of width D with one
    row all zero, all -inf, or holding a NaN."""
    rng = np.random.RandomState(9)
    if case == 'causal -inf':
        x = (rng.standard_normal((2, 16, 16)) * 1.5).astype(np.float32)
        x[:, np.triu(np.ones((16, 16), bool), 1)] = -np.inf
        return x
    x = (rng.standard_normal((8, D)) * 1.5).astype(np.float32)
    x[5] = {'zero row': 0.0, 'all -inf row': -np.inf, 'NaN row': x[5]}[case]
    if case == 'NaN row':
        x[5, 7] = np.nan
    return x


@pytest.mark.parametrize('kernel,case,dtype', [
    ('softmax', 'causal -inf', 'bfloat16'),
    ('softmax', 'all -inf row', 'float32'),
    ('softmax', 'NaN row', 'float32'),
    ('rmsnorm', 'zero row', 'bfloat16'),
    ('rmsnorm', 'all -inf row', 'float32'),
    ('rmsnorm', 'NaN row', 'float32'),
])
def test_edge_rows_match_pallas(kernel, case, dtype):
    """The plain versions (which every body on the card is held to) against
    the Pallas kernels in interpret mode on rows of -inf, NaN and zeros: NaN
    at the same places, a -inf score exactly 0 where its row has a finite
    max, and the file's tolerance elsewhere."""
    x = _edge_rows(kernel, case)
    jx, tx = _both(x, dtype)
    if kernel == 'softmax':
        got = ck.softmax_ref(tx)
        want = jax.jit(pk.fused_softmax)(jx)
    else:
        g = (np.random.RandomState(10).standard_normal(D) * 0.5 + 1).astype(np.float32)
        jg, tg = _both(g, 'float32')
        got = ck.rmsnorm_ref(tx, tg)
        want = jax.jit(pk.fused_rmsnorm)(jx, jg)
    got, want = _np(got), _np(want)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_allclose(got[~nan], want[~nan], **TOL[dtype])
    if kernel == 'softmax':
        masked = np.isinf(x) & ~nan
        assert masked.any() == (case == 'causal -inf')
        assert (got[masked] == 0).all() and (want[masked] == 0).all()
