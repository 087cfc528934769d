#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (a non-zero exit) when it fails, in the
order they run:

(a) identity: the card's name and power limit, as nvidia-smi reports them;
(b) build: every CUDA source of the port (flash_attention.cu,
    row_kernels.cu), compiled in parallel from the sources in this checkout
    with nvcc for sm_90a (timed), with ptxas' register and spill lines;
(c) flash kernel vs plain version on the card, for its out and lse, each
    case on the body the wrapper must pick (printed, and held to the body's
    launch count): the served shape, contiguous and as the strided views of
    the fused qkv that the model passes, causal and not (the wgmma body),
    and with K/V broadcast over heads or batch by a zero stride (the
    mma.sync body at D = 128); small f32 shapes, decode shapes
    (Tq < Tk: Tq = 1, 16, 77), a ragged T = 1006, B*H = 1, Tq = Tk = 1000,
    head dims 16/40/64/256, f16 at a small and the served shape, the empty
    cases, the two ValueError cases, and the autograd gradient;
(g) row kernels vs plain versions on the card (layernorm, rmsnorm, softmax,
    softmax_xent): f32, bf16 and f16 at the model's shapes, a ragged
    N = 1006, widths 32, 50 and 1000, N = 0, an input at an odd offset,
    labels -1 and V, gamma/beta in another dtype than x, rows with a large
    mean; LayerNorm's two bodies at 8 x 1024 rows (the warp body at widths
    1024, 2048 and 1000 in bf16 and 1024 in f32; the block body at widths 50
    and 4096 and at an odd offset); the dtype errors; each autograd
    Function's gradient;
(d) serving: the bench transformer at full width (D=1024, 8 layers,
    8 heads x 128, S=1024, V=16384, bf16, weights from seed 0) behind
    ServingEngine(max_batch=8) answers requests of 8, 5 and 11 rows.
    Their logits are held against a reference forward built on the plain
    attention, and the kernel's launch count, all on the wgmma body, must be
    8 layers x chunks;
(h) the NDArray path at full width, through mxnet_tpu_torch.nd on gpu(0):
    nd.LayerNorm on [8, 1024, 1024] bf16 (on the warp body), nd.softmax on
    one layer's attention scores [8, 8, 1024, 1024] bf16,
    ops.fused_rmsnorm on [8, 1024, 1024] bf16, and bench's training loss:
    the full-width model on bench's 8 x 1024 tokens, its logits cast to f32,
    through nd.softmax_cross_entropy / N against bench's labels. Each is
    held to its plain version, and each kernel's launch count must grow by
    its calls;
(i) mx.rtc on the card (K7): NVRTC's library and version; user kernels
    written in CUDA C and compiled at run time through
    mxnet_tpu_torch.rtc.Rtc(mode='cuda') for sm_90a: k7a the reference's
    mx.rtc test kernel, k7b the JAX test's triple, k7c bench's rms on the
    full-width activations [8, 1024, 1024] bf16 and k7d the tanh GELU on the
    MLP's hidden activations [8, 1024, 4096] bf16. A first compile and a
    cached one (a second Rtc of the same source must not compile), a body
    with a syntax error (MXNetError with NVRTC's log), a 2048-thread block
    and CPU tensors (ValueError, no launch). The main path: an imperative
    step on gpu(0) through the nd surface (x[:] = ..., the pushes, x * 0.5,
    x + y, a slice, .sum()) on layer 0's MLP input, with each user kernel's
    launch count; the step is held to torch on the same tensors and to the
    plain chain, and each user kernel to its plain version;
(e) times from CUDA events: the flash kernel (wgmma body), its plain
    version and PyTorch's scaled_dot_product_attention at the served shape
    and at [1, 16384, 8, 128], the kernel's bound, the host time of one
    call, the full-width forward's tokens/s, and each request's latency;
    each row kernel (LayerNorm on its warp body), its plain version and one
    PyTorch call at the shapes of (h), with their bounds; each user kernel
    of (i), its plain version and one PyTorch call where there is one, with
    their bounds;
(f) where the forward's device time goes (torch.profiler).

The second-to-last line of its output is the kernel record
``{"kernels": [...]}``; the last is ``{"ok": true, "device": {...}}``.
Without CUDA, or without the package beside it, it exits non-zero and
prints neither.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, the dense bf16
# tensor-core FLOP/s and the f32 FLOP/s outside the tensor cores. The bound
# of a kernel is the larger of its bytes over the memory rate and its
# operations over the peak for their type.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
SOURCES = ('flash_attention', 'row_kernels')

SERVE_ROWS = (8, 5, 11)         # requests: full bucket, padded, chunked
MAX_BATCH = 8
TIMED_RUNS = 30


def log(*args):
    print(*args, flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError('chip_smoke check failed: %s' % what)


# ---------------------------------------------------------------------------
# (a) identity
# ---------------------------------------------------------------------------

def card_identity():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


# ---------------------------------------------------------------------------
# (c) kernel vs plain version
# ---------------------------------------------------------------------------

# (label, B, Tq, Tk, H, D, dtype, causal, body): body is the one the
# wrapper must pick. bf16 at D = 128 with 16-byte aligned bases and
# positive 16-byte strides runs the wgmma body (TMA, mbarriers, wgmma);
# bf16 at D in {16, 32, 64}, and at D = 128 with K/V broadcast by a zero
# stride (which no TMA map takes), the mma.sync body; f32, f16 and other
# head dims the scalar body. The served layout's q, k, v are the strided
# views the model gives the kernel: [B, T, H, 3*D] split on the last axis
# (token stride 3*H*D, head stride 3*D, offsets 0, D and 2*D). The
# broadcast cases expand one K/V head over H heads (multi-query attention)
# or one K/V batch row over B.
SERVED_LAYOUT = 'served layout (qkv views)'
BROADCAST = {'K/V expanded over heads': 'heads',
             'K/V expanded over batch': 'batch'}
CASES = [
    ('served shape', 8, 1024, 1024, 8, 128, 'bfloat16', True, 'wgmma'),
    ('served shape', 8, 1024, 1024, 8, 128, 'bfloat16', False, 'wgmma'),
    (SERVED_LAYOUT, 8, 1024, 1024, 8, 128, 'bfloat16', True, 'wgmma'),
    (SERVED_LAYOUT, 8, 1024, 1024, 8, 128, 'bfloat16', False, 'wgmma'),
    ('K/V expanded over heads', 8, 1024, 1024, 8, 128, 'bfloat16', True, 'mma'),
    ('K/V expanded over batch', 2, 256, 256, 4, 128, 'bfloat16', False, 'mma'),
    ('f32 small', 2, 128, 128, 4, 64, 'float32', False, 'scalar'),
    ('f32 small causal', 2, 128, 128, 4, 64, 'float32', True, 'scalar'),
    ('decode Tq=1 Tk=32', 4, 1, 32, 8, 128, 'bfloat16', True, 'wgmma'),
    ('decode Tq=16 Tk=32', 4, 16, 32, 8, 128, 'bfloat16', True, 'wgmma'),
    ('decode Tq=1 Tk=1024', 4, 1, 1024, 8, 128, 'bfloat16', True, 'wgmma'),
    ('decode Tq=16 Tk=1024', 4, 16, 1024, 8, 128, 'bfloat16', True, 'wgmma'),
    ('decode Tq=77 Tk=1024', 4, 77, 1024, 8, 128, 'bfloat16', True, 'wgmma'),
    ('decode f32 Tq=16 Tk=1024', 2, 16, 1024, 4, 64, 'float32', True, 'scalar'),
    ('ragged T=1006', 1, 1006, 1006, 2, 128, 'bfloat16', True, 'wgmma'),
    ('ragged f32 T=1006', 1, 1006, 1006, 2, 64, 'float32', False, 'scalar'),
    ('B*H=1', 1, 1024, 1024, 1, 128, 'bfloat16', True, 'wgmma'),
    ('Tq=Tk=1000', 2, 1000, 1000, 4, 128, 'bfloat16', True, 'wgmma'),
    ('Tq=Tk=1000', 2, 1000, 1000, 4, 128, 'bfloat16', False, 'wgmma'),
    ('D=16', 2, 256, 256, 4, 16, 'bfloat16', True, 'mma'),
    ('D=16 f32', 2, 256, 256, 4, 16, 'float32', True, 'scalar'),
    ('D=64', 2, 256, 256, 4, 64, 'bfloat16', False, 'mma'),
    ('D=40 scalar body', 2, 200, 200, 2, 40, 'bfloat16', True, 'scalar'),
    ('D=256 scalar body', 1, 128, 128, 2, 256, 'bfloat16', True, 'scalar'),
    ('f16 small', 2, 128, 128, 4, 64, 'float16', False, 'scalar'),
    ('f16 served shape', 8, 1024, 1024, 8, 128, 'float16', True, 'scalar'),
]

# Tolerances (|kernel - plain| <= atol + rtol * |plain|), with their reasons:
# - f32: both sides compute in f32 with the sums in another order (and the
#   plain side's matmuls with TF32 off): a few f32 ulps of the row sums,
#   the tolerance the JAX package's own kernel tests use (2e-5).
# - bf16 out: the kernel rounds p to bf16 before the p.v product, and both
#   sides round the output to bf16 once (2**-8 relative each): 1e-2.
# - f16 out (the scalar body: p stays f32, and both sides round the f32
#   output to f16 once): one f16 ulp, rtol 2**-10; atol 1e-6 for f16's
#   subnormals.
# - lse (f32 on both sides, the scores exact products of bf16 inputs
#   summed in f32): 1e-4.
TOL = {'float32': (2e-5, 2e-5), 'bfloat16': (1e-2, 1e-2),
       'float16': (1e-6, 2 ** -10)}
LSE_TOL = (1e-4, 1e-4)


def qkv(B, Tq, Tk, H, D, dtype, device, seed=0, interleaved=False,
        broadcast=None):
    """q, k, v from ``seed``: contiguous, or (``interleaved``, Tq == Tk)
    views of one head-interleaved [B, T, H, 3*D] tensor, as the model
    splits its fused qkv projection, or (``broadcast`` 'heads' or 'batch')
    with k and v of one head or batch row expanded to [B, Tk, H, D]."""
    import torch
    rng = np.random.RandomState(seed)
    cast = dict(device=device, dtype=getattr(torch, dtype))
    if interleaved:
        fused = rng.standard_normal((B, Tq, H, 3 * D)).astype(np.float32)
        return torch.from_numpy(fused).to(**cast).split(D, dim=-1)
    kv_shape = {None: (B, Tk, H, D), 'heads': (B, Tk, 1, D),
                'batch': (1, Tk, H, D)}[broadcast]
    q = rng.standard_normal((B, Tq, H, D)).astype(np.float32)
    k = rng.standard_normal(kv_shape).astype(np.float32)
    v = rng.standard_normal(kv_shape).astype(np.float32)
    q, k, v = (torch.from_numpy(a).to(**cast) for a in (q, k, v))
    return q, k.expand(B, Tk, H, D), v.expand(B, Tk, H, D)


def excess(got, want, atol, rtol):
    """max(|got - want| - rtol*|want|); <= atol means within tolerance."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() - rtol * want.abs()).max())


def kernel_vs_plain(device):
    import torch
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    device = torch.device(device)
    errs = {}
    for label, B, Tq, Tk, H, D, dtype, causal, want_body in CASES:
        q, k, v = qkv(B, Tq, Tk, H, D, dtype, device,
                      interleaved=label == SERVED_LAYOUT,
                      broadcast=BROADCAST.get(label))
        before = dict(ck.flash_fwd.launches_by_body)
        out, lse = ck.flash_fwd(q, k, v, causal)
        ran = {b for b, n in ck.flash_fwd.launches_by_body.items()
               if n != before[b]}
        ref_out, ref_lse = ck.flash_attention_lse_ref(q, k, v, causal)
        atol, rtol = TOL[dtype]
        err = float((out.float() - ref_out.float()).abs().max())
        lse_err = float((lse - ref_lse).abs().max())
        ok = (bool(torch.isfinite(out).all())
              and excess(out, ref_out, atol, rtol) <= atol
              and excess(lse, ref_lse, *LSE_TOL) <= LSE_TOL[0]
              and ran == ({want_body} if device.type == 'cuda' else set()))
        log('  %-26s %-8s causal=%d body=%-6s max|out err| %.3e  '
            'max|lse err| %.3e  %s' % (label, dtype, causal, want_body, err,
                                       lse_err, 'ok' if ok else 'FAIL'))
        check(ok, 'kernel disagrees with its plain version: %s causal=%d '
              'body=%s (ran %s)' % (label, causal, want_body, sorted(ran)))
        errs[(label, causal)] = err
        del q, k, v, out, lse, ref_out, ref_lse

    # empty: zeros and no launch
    for shape_q, shape_kv in (((0, 8, 2, 16), (0, 8, 2, 16)),
                              ((2, 8, 0, 16), (2, 8, 0, 16)),
                              ((2, 0, 2, 16), (2, 8, 2, 16))):
        before = ck.flash_fwd.launches
        q = torch.zeros(shape_q, device=device)
        k = torch.zeros(shape_kv, device=device)
        out, lse = ck.flash_fwd(q, k, k, True)
        check(out.shape == q.shape and lse.shape == (q.shape[0], q.shape[2],
                                                     q.shape[1])
              and ck.flash_fwd.launches == before, 'empty case %s' % (shape_q,))
    # the two ValueError cases
    for shape_q, shape_kv, causal in (((1, 8, 2, 16), (1, 4, 2, 16), True),
                                      ((1, 8, 2, 16), (1, 0, 2, 16), False)):
        q = torch.zeros(shape_q, device=device)
        k = torch.zeros(shape_kv, device=device)
        try:
            ck.flash_fwd(q, k, k, causal)
        except ValueError:
            pass
        else:
            check(False, 'no ValueError for q %s, k %s' % (shape_q, shape_kv))
    log('  empty cases: zeros, no launch; causal Tq>Tk and Tk=0: ValueError')

    # gradient through the autograd Function vs the plain gradient.
    # Tolerance 1e-4: the backward recomputes through the plain version;
    # only the cotangent 2*out comes from the kernel (f32 sums reordered).
    q, k, v = qkv(1, 64, 64, 2, 32, 'float32', device, seed=3)
    grads = []
    for fn in (ck.flash_attention_lse, ck.flash_attention_lse_ref):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out, lse = fn(*leaves, True)
        ((out ** 2).sum() + lse.sum()).backward()
        grads.append([t.grad for t in leaves])
    gerr = max(float((a - b).abs().max()) for a, b in zip(*grads))
    log('  autograd grad vs plain grad: max err %.3e' % gerr)
    check(gerr <= 1e-4, 'gradient disagrees (%.3e)' % gerr)
    return errs


# ---------------------------------------------------------------------------
# (d) serving at full width
# ---------------------------------------------------------------------------

# Logits of the kernel path vs the reference forward on the plain attention,
# both bf16. Each layer's attention output may differ by a bf16 rounding (the
# kernel rounds p to bf16; bf16 resolves 2**-8 relative) and the matmuls run
# at other batch sizes (padded buckets vs the bare request), and 8 residual
# layers carry that into the logits: relative RMS error <= 2e-2. The next
# token must agree up to bf16 ties: the reference's logit at the served
# argmax lies within ARGMAX_SLACK of the reference's max. Single logits of
# the two paths differ by up to 2 bf16 ulps at the max logit's magnitude
# (16..32, an ulp of 0.125); the served argmax's reference logit can then
# sit twice that below the max: 4 ulps, 0.5. Exact agreement is printed too.
# The slack only guards the next token against ties; the relative RMS bound
# is the check that fails a wrong kernel (a wrong tile or mask moves every
# logit of the rows it touches, far past 2e-2).
LOGIT_REL_RMS = 2e-2
ARGMAX_SLACK = 0.5


def on_device(a, device):
    """A served bf16 answer (numpy, ml_dtypes.bfloat16) as an f32 tensor
    on ``device``."""
    import torch
    check(a.dtype.name == 'bfloat16', 'served logits are %s, not bfloat16'
          % a.dtype)
    return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
        .to(device).float()


def serve(device, cfg, rows_list, max_batch):
    import torch
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    from mxnet_tpu_torch.serving import ServingEngine
    from mxnet_tpu_torch.transformer import (TransformerLM, init_params,
                                             params_from_jax)
    t0 = time.perf_counter()
    state = params_from_jax(init_params(cfg, seed=0))
    model = TransformerLM(cfg, dtype=torch.bfloat16, device=device)
    model.load_state_dict(state)
    ref = TransformerLM(cfg, dtype=torch.bfloat16, device=device,
                        attention=ck.flash_attention_ref)
    ref.load_state_dict(state)
    truth = TransformerLM(cfg, dtype=torch.float32, device=device,
                          attention=ck.flash_attention_ref)
    truth.load_state_dict(state)
    del state
    engine = ServingEngine(model, [('tokens', (cfg.seq_len,), np.int32)],
                           output_names=['logits'], max_batch=max_batch,
                           device=device, name='bench_transformer')
    warmed = engine.warmup()
    log('  model built and %d buckets %s warm in %.1f s'
        % (warmed, engine.buckets, time.perf_counter() - t0))

    rng = np.random.RandomState(1)
    requests = [rng.randint(0, cfg.vocab, (r, cfg.seq_len)).astype(np.int32)
                for r in rows_list]
    n_chunks = sum(-(-r // engine.buckets[-1]) for r in rows_list)

    # the main path: counts are zeroed just before and read just after
    ck.flash_fwd.launches = 0
    ck.flash_fwd.launches_by_body = dict.fromkeys(ck._BODIES, 0)
    answers, latencies = [], []
    for req in requests:
        t = time.perf_counter()
        timings = {}
        chunks = engine.dispatch_rows(req, timings=timings)
        answers.append(engine.fetch_chunks(chunks, timings=timings)[0])
        latencies.append((time.perf_counter() - t, timings))
    launches = ck.flash_fwd.launches
    by_body = dict(ck.flash_fwd.launches_by_body)

    check(launches == cfg.n_layers * n_chunks
          and by_body['wgmma'] == launches,
          'flash launches %d (by body %s) != %d layers x %d chunks on the '
          'wgmma body' % (launches, by_body, cfg.n_layers, n_chunks))
    log('  %d requests (%s rows) in %d chunks: %d flash launches = %d layers '
        'x %d chunks, by body %s' % (len(requests), list(rows_list), n_chunks,
                                     launches, cfg.n_layers, n_chunks, by_body))

    worst = {'rel_rms': 0.0, 'agree': 1.0, 'max_abs': 0.0, 'top_gap': 0.0}
    with torch.inference_mode():
        for req, got in zip(requests, answers):
            got_t = on_device(got, device)
            check(got.shape == (req.shape[0], cfg.seq_len, cfg.vocab)
                  and bool(torch.isfinite(got_t).all()), 'logits shape/finite')
            want = ref(torch.from_numpy(req).to(device)).float()
            diff = got_t - want
            rel = float(diff.square().mean().sqrt() / want.square().mean().sqrt())
            pick = got_t.argmax(-1, keepdim=True)
            agree = float((pick[..., 0] == want.argmax(-1)).float().mean())
            gap = float((want.amax(-1) - want.gather(-1, pick)[..., 0]).max())
            worst['rel_rms'] = max(worst['rel_rms'], rel)
            worst['agree'] = min(worst['agree'], agree)
            worst['top_gap'] = max(worst['top_gap'], gap)
            worst['max_abs'] = max(worst['max_abs'], float(diff.abs().max()))
            del want, got_t, diff
    log('  logits vs plain-attention reference: worst rel RMS %.3e, '
        'max |err| %.3e, exact argmax agreement %.4f, reference logit at the '
        'served argmax at most %.4f below its max'
        % (worst['rel_rms'], worst['max_abs'], worst['agree'], worst['top_gap']))
    check(worst['rel_rms'] <= LOGIT_REL_RMS and worst['top_gap'] <= ARGMAX_SLACK,
          'served logits disagree with the reference forward')

    # Where the differences come from, on the first request: the same batch
    # through both bf16 paths (the kernel alone), and each bf16 path against
    # an f32 forward on the plain attention (which of the two is closer to
    # f32 arithmetic).
    with torch.inference_mode():
        tokens = torch.from_numpy(requests[0]).to(device)
        kern = model(tokens).float()
        plain = ref(tokens).float()
        exact = truth(tokens).float()

        def rel(a, b):
            return float((a - b).square().mean().sqrt() / b.square().mean().sqrt())

        log('  request 1 (%d rows), relative RMS: kernel path vs plain path at '
            'the same batch %.3e; vs the f32 forward: kernel path %.3e, plain '
            'bf16 path %.3e, served answer %.3e'
            % (tokens.shape[0], rel(kern, plain), rel(kern, exact),
               rel(plain, exact), rel(on_device(answers[0], device), exact)))
        del kern, plain, exact
    del truth
    return model, ref, launches, latencies, worst


# ---------------------------------------------------------------------------
# (g) row kernels vs plain versions
# ---------------------------------------------------------------------------

ROW_KERNELS = ('layernorm', 'rmsnorm', 'softmax', 'softmax_xent')
ROW_REPLACES = {'layernorm': 'mxnet_tpu/ops/pallas_kernels.py:290',
                'rmsnorm': 'mxnet_tpu/ops/pallas_kernels.py:284',
                'softmax': 'mxnet_tpu/ops/pallas_kernels.py:382',
                'softmax_xent': 'mxnet_tpu/ops/pallas_kernels.py:412'}

# Tolerances of a row kernel against its plain version on the same inputs
# (|kernel - plain| <= atol + rtol * |plain|), with their reasons. Both
# compute in f32 with the row sums in another order (a few f32 ulps of the
# statistics), then round once to the output type:
# - f32 out (and xent's f32 loss, whatever its logits' type): 1e-5 / 1e-5;
# - bf16 out: one bf16 ulp of the value (rtol 2**-7: 2**-8 relative, up to
#   2**-7 just above a power of two), as a few f32 ulps can fall on either
#   side of a rounding boundary; atol 1e-6 near zero;
# - f16 out: one f16 ulp, rtol 2**-10; atol 1e-6 covers f16's subnormals
#   (softmax outputs below 6.1e-5 have an ulp of 6e-8).
# - rows with a mean of 1000 (LayerNorm): atol 2e-3 against the plain
#   version and against float64. An f32 row sum near 1e6 rounds at 0.06 an
#   add, so either mean may be off by ~1e-4, which moves (x - mean) * rstd
#   * gamma by a few 1e-4; the one-pass E[x^2] - mean^2 would be off by
#   about 1e-1 here.
ROW_TOL = {'float32': (1e-5, 1e-5), 'bfloat16': (1e-6, 2 ** -7),
           'float16': (1e-6, 2 ** -10)}
LARGE_MEAN_ATOL = 2e-3
# Gradients of each autograd Function (kernel forward) against the plain
# version's autograd gradient, f32: the norm and xent backwards recompute
# through the plain version (the same arithmetic) and the softmax backward
# reads the kernel's y; 1e-5.
ROW_GRAD_TOL = 1e-5


def model_shapes(cfg, batch=MAX_BATCH):
    """The row kernels' shapes on the model's path: its activations, one
    layer's attention scores, and its logits as [N, V]."""
    act = (batch, cfg.seq_len, cfg.d_model)
    return {'layernorm': act, 'rmsnorm': act,
            'softmax': (batch, cfg.n_heads, cfg.seq_len, cfg.seq_len),
            'softmax_xent': (batch * cfg.seq_len, cfg.vocab)}


def row_inputs(kernel, shape, dtype, device, seed=0, param_dtypes=None,
               offset=False, mean=0.0):
    """Arguments of ``kernel`` at ``shape``, from a seeded generator on
    ``device``: x (N(mean, 1.5), or the logits), then gamma/beta (f32 by
    default, else ``param_dtypes``), or the int32 labels with -1 and V
    among them. ``offset``: x is a contiguous view one element past an
    aligned start, so its rows are not 16-byte aligned."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, dtype)
    numel = int(np.prod(shape))
    flat = (torch.randn(numel + 1, generator=gen, device=device) * 1.5
            + mean).to(dt)
    x = (flat[1:] if offset else flat[:numel]).view(shape)
    if kernel == 'softmax_xent':
        N, V = shape
        labels = torch.randint(0, V, (N,), generator=gen, device=device,
                               dtype=torch.int32)
        labels[::97] = -1
        labels[1::89] = V
        return [x, labels]
    D = shape[-1]
    gd, bd = param_dtypes or ('float32', 'float32')
    gamma = (torch.randn(D, generator=gen, device=device) * 0.5 + 1).to(
        getattr(torch, gd))
    beta = (torch.randn(D, generator=gen, device=device) * 0.1).to(
        getattr(torch, bd))
    return {'layernorm': [x, gamma, beta], 'rmsnorm': [x, gamma],
            'softmax': [x]}[kernel]


def row_fns(kernel):
    """(kernel wrapper, plain version, autograd Function) of ``kernel``."""
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    return {'layernorm': (ck.layernorm_fwd, ck.layernorm_ref, ck.fused_layernorm),
            'rmsnorm': (ck.rmsnorm_fwd, ck.rmsnorm_ref, ck.fused_rmsnorm),
            'softmax': (ck.softmax_fwd, ck.softmax_ref, ck.fused_softmax),
            'softmax_xent': (ck.softmax_xent_fwd, ck.softmax_xent_ref,
                             ck.softmax_xent)}[kernel]


def row_tol(kernel, dtype):
    return ROW_TOL['float32' if kernel == 'softmax_xent' else dtype]


def row_cases(cfg):
    """(kernel, label, shape, dtype, options) of phase (g)."""
    shapes = model_shapes(cfg)
    cases = []
    for kernel in ROW_KERNELS:
        for dtype in ('float32', 'bfloat16', 'float16'):
            cases.append((kernel, 'model shape', shapes[kernel], dtype, {}))
            for shape in ((1006, 32), (1006, 1000), (1006, 50), (7, 1000),
                          (0, 64)):
                cases.append((kernel, 'N=%d width %d' % shape, shape, dtype, {}))
            cases.append((kernel, 'odd offset', (1006, 1000), dtype,
                          {'offset': True}))
    for kernel in ('layernorm', 'rmsnorm'):
        cases.append((kernel, 'x bf16, gamma/beta f32', (1006, 1000),
                      'bfloat16', {}))
        cases.append((kernel, 'x f32, gamma bf16, beta f16', (1006, 1000),
                      'float32', {'param_dtypes': ('bfloat16', 'float16')}))
        cases.append((kernel, 'x f16, gamma/beta bf16', (1006, 1000),
                      'float16', {'param_dtypes': ('bfloat16', 'bfloat16')}))
    return cases


# LayerNorm's two bodies at the model's row count (8 x 1024 rows): (label,
# width, dtype, offset, the body the wrapper must pick). The warp body takes
# rows of whole 16-byte vectors up to 4 KB that start 16-byte aligned; the
# block body every other row.
LN_BODY_CASES = [
    ('warp body, width 1024', 1024, 'bfloat16', False, 'warp'),
    ('warp body, width 2048', 2048, 'bfloat16', False, 'warp'),
    ('warp body, width 1000', 1000, 'bfloat16', False, 'warp'),
    ('warp body, width 1024', 1024, 'float32', False, 'warp'),
    ('block body, width 50', 50, 'bfloat16', False, 'block'),
    ('block body, width 4096', 4096, 'bfloat16', False, 'block'),
    ('block body, odd offset', 1024, 'bfloat16', True, 'block'),
]


def layernorm_bodies_vs_plain(device, cfg):
    """Phase (g): each LayerNorm body on the shapes it takes, with the body
    the wrapper picked."""
    import torch
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    rows = MAX_BATCH * cfg.seq_len
    for i, (label, D, dtype, offset, body) in enumerate(LN_BODY_CASES):
        x, g, b = row_inputs('layernorm', (rows, D), dtype, device, seed=60 + i,
                             offset=offset)
        before = dict(ck.layernorm_fwd.launches_by_body)
        got = ck.layernorm_fwd(x, g, b)
        want = ck.layernorm_ref(x, g, b)
        ran = {k for k, n in ck.layernorm_fwd.launches_by_body.items()
               if n != before[k]}
        atol, rtol = ROW_TOL[dtype]
        err = float((got.float() - want.float()).abs().max())
        ok = (got.shape == want.shape and got.dtype == want.dtype
              and bool(torch.isfinite(got).all())
              and excess(got, want, atol, rtol) <= atol
              and ran == ({body} if device.type == 'cuda' else set()))
        log('  layernorm    %-30s %-8s %-22s body=%-5s max|err| %.3e  %s'
            % (label, dtype, (rows, D), body, err, 'ok' if ok else 'FAIL'))
        check(ok, 'layernorm %s %s disagrees with its plain version or ran '
              '%s' % (label, dtype, sorted(ran)))
        del x, got, want


def row_kernels_vs_plain(device, cfg):
    """Phase (g)."""
    import torch
    for i, (kernel, label, shape, dtype, opts) in enumerate(row_cases(cfg)):
        fwd, ref, _ = row_fns(kernel)
        args = row_inputs(kernel, shape, dtype, device, seed=i, **opts)
        before = fwd.launches
        got = fwd(*args)
        want = ref(*args)
        atol, rtol = row_tol(kernel, dtype)
        err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
        ok = (got.shape == want.shape and got.dtype == want.dtype
              and bool(torch.isfinite(got).all())
              and (got.numel() == 0 or excess(got, want, atol, rtol) <= atol)
              and fwd.launches == before + (1 if got.numel() and device.type == 'cuda' else 0))
        log('  %-12s %-30s %-8s %-22s max|err| %.3e  %s'
            % (kernel, label, dtype, tuple(shape), err, 'ok' if ok else 'FAIL'))
        check(ok, '%s disagrees with its plain version: %s %s %s'
              % (kernel, label, dtype, tuple(shape)))
        del args, got, want

    layernorm_bodies_vs_plain(device, cfg)

    # the two-pass variance: rows with a mean of 1000, against float64 too
    for dtype in ('float32', 'bfloat16'):
        x, g, b = row_inputs('layernorm', (64, cfg.d_model), dtype, device,
                             seed=99, mean=1000.0)
        got = row_fns('layernorm')[0](x, g, b)
        plain = row_fns('layernorm')[1](x, g, b)
        x64 = x.double()
        y64 = ((x64 - x64.mean(-1, keepdim=True))
               * torch.rsqrt(x64.var(-1, unbiased=False, keepdim=True) + 1e-5)
               * g.double() + b.double())
        rtol = ROW_TOL[dtype][1] if dtype == 'bfloat16' else 0.0  # y's rounding
        e_plain = excess(got, plain, LARGE_MEAN_ATOL, rtol)
        e64 = excess(got, y64, LARGE_MEAN_ATOL, rtol)
        log('  layernorm    rows with mean 1000             %-8s |err| beyond '
            'rounding: vs plain %.3e, vs float64 %.3e' % (dtype, e_plain, e64))
        check(e_plain <= LARGE_MEAN_ATOL and e64 <= LARGE_MEAN_ATOL,
              'layernorm loses the variance of rows with a large mean')

    # types the kernels do not take raise
    bad = [(row_fns('softmax')[0], [torch.zeros(4, 8, dtype=torch.int32,
                                                device=device)]),
           (row_fns('softmax_xent')[0], [torch.zeros(4, 8, device=device),
                                         torch.zeros(4, device=device)])]
    if device.type == 'cuda':
        for fn, args in bad:
            try:
                fn(*args)
            except TypeError:
                continue
            check(False, '%s took a type it does not take' % fn.__name__)
        log('  int x and float labels: TypeError')

    # each autograd Function's gradient vs the plain gradient (f32)
    for kernel in ROW_KERNELS:
        _, ref, function = row_fns(kernel)
        shape = (64, 50) if kernel == 'softmax_xent' else (64, 96)
        args = row_inputs(kernel, shape, 'float32', device, seed=7)
        w = torch.randn(shape[:1] if kernel == 'softmax_xent' else shape,
                        generator=torch.Generator(device=device).manual_seed(8),
                        device=device)
        grads = []
        for fn in (function, ref):
            leaves = [a.clone().requires_grad_() if a.is_floating_point() else a
                      for a in args]
            (fn(*leaves) * w).sum().backward()
            grads.append([a.grad for a in leaves if a.is_floating_point()])
        gerr = max(float((a - b).abs().max()) for a, b in zip(*grads))
        log('  %-12s autograd grad vs plain grad: max err %.3e' % (kernel, gerr))
        check(gerr <= ROW_GRAD_TOL, '%s gradient disagrees (%.3e)' % (kernel, gerr))


# ---------------------------------------------------------------------------
# (h) the NDArray path at full width
# ---------------------------------------------------------------------------

# bench's loss through the kernel against the plain version's mean(lse -
# gold) on the same f32 logits: each row's loss (about 10) agrees to a few
# f32 ulps, and the sums over 65,536 rows run in another order: 1e-5
# relative.
LOSS_RTOL = 1e-5


def nd_path(device, cfg, model):
    """Phase (h). Returns ({wrapper name: launches}, {kernel: max |err|
    against the plain version})."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    from mxnet_tpu_torch.transformer import bench_batch
    ctx = mt.gpu(device.index or 0) if device.type == 'cuda' else mt.cpu()
    shapes = model_shapes(cfg)
    x, gamma, beta = row_inputs('layernorm', shapes['layernorm'], 'bfloat16',
                                device, seed=11)
    scores, = row_inputs('softmax', shapes['softmax'], 'bfloat16', device,
                         seed=12)
    tokens, labels = bench_batch(cfg, MAX_BATCH, seed=0)
    tokens = torch.from_numpy(tokens).to(device)
    N, V = tokens.numel(), cfg.vocab
    lab = nd.array(labels.reshape(-1), ctx=ctx)
    x_nd, g_nd, b_nd = (nd.from_torch(t, ctx) for t in (x, gamma, beta))
    s_nd = nd.from_torch(scores, ctx)

    counters = [ck.flash_fwd] + [row_fns(k)[0] for k in ROW_KERNELS]
    # the main path: counts are zeroed just before and read just after
    for fwd in counters:
        fwd.launches = 0
        if hasattr(fwd, 'launches_by_body'):
            fwd.launches_by_body = dict.fromkeys(fwd.launches_by_body, 0)
    ln = nd.LayerNorm(x_nd, g_nd, b_nd, eps=1e-5)
    sm = nd.softmax(s_nd)
    rms = mt.ops.fused_rmsnorm(x, gamma)
    with torch.no_grad():
        logits = model(tokens).float()               # bench.py:270
    loss = nd.softmax_cross_entropy(nd.from_torch(logits.reshape(-1, V), ctx),
                                    lab)
    loss.wait_to_read()
    launches = {fwd.__name__: fwd.launches for fwd in counters}
    ln_bodies = dict(ck.layernorm_fwd.launches_by_body)

    want = {'flash_fwd': cfg.n_layers, 'layernorm_fwd': 1, 'rmsnorm_fwd': 1,
            'softmax_fwd': 1, 'softmax_xent_fwd': 1}
    want_bodies = {'block': 0, 'warp': 1}
    if device.type != 'cuda':
        want = dict.fromkeys(want, 0)                # plain versions on the CPU
        want_bodies = dict.fromkeys(want_bodies, 0)
    log('  launches: %s; layernorm by body %s' % (launches, ln_bodies))
    check(launches == want and ln_bodies == want_bodies,
          'launch counts %s (layernorm by body %s) != %s (%s)'
          % (launches, ln_bodies, want, want_bodies))

    errs = {}
    for kernel, got, ref_args in (('layernorm', ln.handle, (x, gamma, beta)),
                                  ('softmax', sm.handle, (scores,)),
                                  ('rmsnorm', rms, (x, gamma))):
        want_t = row_fns(kernel)[1](*ref_args)
        atol, rtol = ROW_TOL['bfloat16']
        errs[kernel] = float((got.float() - want_t.float()).abs().max())
        ok = (got.dtype == torch.bfloat16 and got.shape == want_t.shape
              and bool(torch.isfinite(got).all())
              and excess(got, want_t, atol, rtol) <= atol)
        log('  nd %-10s %-22s bf16: max|err| vs plain %.3e  %s'
            % (kernel, tuple(got.shape), errs[kernel], 'ok' if ok else 'FAIL'))
        check(ok, 'nd path %s disagrees with its plain version' % kernel)
        del want_t

    labels_t = torch.from_numpy(labels.reshape(-1)).to(device)
    got_loss = float(loss.asscalar()) / N
    per_row = ck.softmax_xent_ref(logits.reshape(-1, V), labels_t)
    plain_loss = float(per_row.mean())
    kernel_rows = ck.softmax_xent_fwd(logits.reshape(-1, V), labels_t)
    errs['softmax_xent'] = float((kernel_rows - per_row).abs().max())
    lse = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, labels_t.view(tokens.shape).long()[..., None])[..., 0]
    bench_loss = float((lse - gold).mean())
    log('  bench loss at full width (%d tokens, V=%d): nd.softmax_cross_entropy'
        ' / N %.6f, plain mean(lse - gold) %.6f, torch.logsumexp form %.6f, '
        'max|row err| %.3e' % (N, V, got_loss, plain_loss, bench_loss,
                               errs['softmax_xent']))
    check(np.isfinite(got_loss) and loss.shape == () and loss.dtype == np.float32
          and abs(got_loss - plain_loss) <= LOSS_RTOL * abs(plain_loss),
          'bench loss through the kernel disagrees with the plain version')
    return launches, errs


# ---------------------------------------------------------------------------
# (i) mx.rtc on the card: user kernels compiled at run time by NVRTC (K7)
# ---------------------------------------------------------------------------

RTC_REPLACES = 'mxnet_tpu/rtc.py:79'

# The user kernels, written as a user of mx.rtc writes them: CUDA C bodies
# over the declared inputs and outputs, each of which comes with its
# <name>_ndim and <name>_dims[] constants.
# k7a: the reference's own mx.rtc test kernel, as it was written.
K7A_REFERENCE = """
__shared__ float s_rec[10];
s_rec[threadIdx.x] = x[threadIdx.x];
y[threadIdx.x] = expf(s_rec[threadIdx.x]*5.0);
"""
# k7b: the JAX package's test kernel `triple` (tests/unittest/test_rtc.py).
K7B_TRIPLE = """
const int i = blockIdx.x * blockDim.x + threadIdx.x;
if (i < x_dims[0]) y[i] = x[i] * 3.0f;
"""
# k7c: bench's rms (transformer._rms): normalise in f32, round to x's type,
# then scale by g. One row a block, blocks of at most 256 threads (a power
# of two), the sum of squares reduced in shared memory.
K7C_RMS = """
const int D = x_dims[x_ndim - 1];
const __nv_bfloat16* xr = x + (long long)blockIdx.x * D;
__nv_bfloat16* yr = y + (long long)blockIdx.x * D;
__shared__ float part[256];
float s = 0.f;
for (int j = threadIdx.x; j < D; j += blockDim.x) {
  const float v = __bfloat162float(xr[j]);
  s += v * v;
}
part[threadIdx.x] = s;
__syncthreads();
for (int w = blockDim.x / 2; w > 0; w >>= 1) {
  if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
  __syncthreads();
}
const float inv = rsqrtf(part[0] / D + 1e-6f);
for (int j = threadIdx.x; j < D; j += blockDim.x) {
  const float n = __bfloat162float(__float2bfloat16_rn(__bfloat162float(xr[j]) * inv));
  yr[j] = __float2bfloat16_rn(n * __bfloat162float(g[j]));
}
"""
# k7d: GELU, tanh form, over every element of h (the MLP's hidden
# activations), f32 inside, grid-stride so that any grid covers it.
K7D_GELU = """
long long n = 1;
for (int d = 0; d < h_ndim; ++d) n *= h_dims[d];
for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
     i += (long long)gridDim.x * blockDim.x) {
  const float v = __bfloat162float(h[i]);
  const float u = 0.7978845608028654f * (v + 0.044715f * v * v * v);
  y[i] = __float2bfloat16_rn(0.5f * v * (1.0f + tanhf(u)));
}
"""
RMS_BLOCK = 256

# Tolerances of each user kernel against its plain version on the same
# inputs (|kernel - plain| <= atol + rtol * |plain|), with their reasons:
# - k7a, k7b (f32): expf is within 2 ulps of exp, and x * 3 is exact:
#   rtol 1e-6 (about 8 f32 ulps), atol 0.
# - k7d (bf16 out, one rounding of an f32 value): one bf16 ulp (rtol 2**-7,
#   atol 1e-6). tanhf and fused multiply-adds can move the f32 value across
#   a bf16 rounding boundary; atol covers GELU's outputs near zero.
# - k7c (bf16 out, two roundings, as bench rounds): two bf16 ulps (rtol
#   2**-6, atol 1e-6). The f32 sums of squares differ in their order, so
#   the normalised value n may round to the neighbouring bf16 value (one ulp
#   of n, up to 2**-7 relative); n * g then rounds again, so one ulp does
#   not hold (a few elements in a million differ by two).
# For both, fewer than RTC_DIFF_SHARE of the elements may differ at all: a
# kernel that is off everywhere fails that even inside the ulps. The limit
# is about 20 times the readings on an H100 (k7c: 37 of 8.4M elements,
# 4.41e-6; k7d: none), so a body that moves its f32 value by a few parts in
# a million (an eps of 1e-5 for bench's 1e-6) fails it.
RTC_TOL = {'rtc_k7a_reference': (0.0, 1e-6), 'rtc_k7b_triple': (0.0, 1e-6),
           'rtc_k7c_rms': (1e-6, 2 ** -6), 'rtc_k7d_gelu': (1e-6, 2 ** -7)}
RTC_DIFF_SHARE = 1e-4
# f32 operations an element: k7a mul, exp; k7b mul; k7c mul, add; mul, mul;
# k7d 3 mul, add, mul, tanh, add, 2 mul (tanh counted as one).
RTC_OPS_PER_ELEMENT = {'rtc_k7a_reference': 2, 'rtc_k7b_triple': 1,
                       'rtc_k7c_rms': 4, 'rtc_k7d_gelu': 9}
# The step on the NDArray surface against the plain chain (bench's _rms and
# the plain GELU in torch): the user kernels' outputs differ from the plain
# versions by a bf16 ulp in a few elements per million, which the matmul and
# the sum spread. It read a relative RMS of 2.7e-5 on an H100; the limit is
# about 20 times that. The step's bf16 total has a limit of its own (its
# rounding to bf16 comes first).
STEP_REL_RMS = 5e-4


def rtc_kernels(cfg, batch=MAX_BATCH):
    """{name: (body, inputs, outputs, grid_dims, block_dims)} of k7a-k7d at
    the shapes of the main path; inputs and outputs are (name, shape,
    dtype); grid_dims None takes Rtc's default geometry."""
    act = (batch, cfg.seq_len, cfg.d_model)
    hid = (batch, cfg.seq_len, 4 * cfg.d_model)
    rows = batch * cfg.seq_len
    return {
        'rtc_k7a_reference': (K7A_REFERENCE, [('x', (10,), 'float32')],
                              [('y', (10,), 'float32')], (1, 1, 1), (10, 1, 1)),
        'rtc_k7b_triple': (K7B_TRIPLE, [('x', (8,), 'float32')],
                           [('y', (8,), 'float32')], None, None),
        'rtc_k7c_rms': (K7C_RMS, [('x', act, 'bfloat16'),
                                  ('g', (cfg.d_model,), 'bfloat16')],
                        [('y', act, 'bfloat16')], (rows, 1, 1),
                        (RMS_BLOCK, 1, 1)),
        'rtc_k7d_gelu': (K7D_GELU, [('h', hid, 'bfloat16')],
                         [('y', hid, 'bfloat16')], None, None),
    }


def make_rtc(name, spec, ctx):
    """An Rtc(mode='cuda') of ``spec`` (see :func:`rtc_kernels`), its
    arguments declared by NDArrays on ``ctx``."""
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.rtc import Rtc
    body, ins, outs, _, _ = spec
    return Rtc(name, [(n, nd.zeros(s, ctx, d)) for n, s, d in ins],
               [(n, nd.zeros(s, ctx, d)) for n, s, d in outs], body, mode='cuda')


def rtc_plain(name):
    """The plain PyTorch version of user kernel ``name``."""
    import torch
    from mxnet_tpu_torch.transformer import _rms

    def gelu(h):
        v = h.float()
        u = 0.7978845608028654 * (v + 0.044715 * v * v * v)
        return (0.5 * v * (1.0 + torch.tanh(u))).to(h.dtype)
    return {'rtc_k7a_reference': lambda x: torch.exp(x * 5.0),
            'rtc_k7b_triple': lambda x: x * 3.0,
            'rtc_k7c_rms': _rms, 'rtc_k7d_gelu': gelu}[name]


def rtc_library(name, args):
    """One PyTorch call computing the user kernel's function (a yardstick
    only; the port never calls it), or None where there is none."""
    import torch
    import torch.nn.functional as F
    if name == 'rtc_k7b_triple':
        return lambda: torch.mul(args[0], 3.0)
    if name == 'rtc_k7d_gelu':
        return lambda: F.gelu(args[0], approximate='tanh')
    return None


def rtc_inputs(name, spec, device, seed):
    """Seeded inputs of user kernel ``name`` at its shapes."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for arg, shape, dtype in spec[1]:
        t = torch.randn(shape, generator=gen, device=device)
        if arg == 'g':
            t = t * 0.5 + 1.0
        elif name == 'rtc_k7d_gelu':
            t = t * 2.0
        elif name == 'rtc_k7a_reference':
            t = t.clamp(-1.0, 1.0)
        out.append(t.to(getattr(torch, dtype)))
    return out


def push(rtc, spec, args, device):
    """Push ``args`` (tensors) through ``rtc``; its output tensors."""
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.context import Context
    ctx = Context('gpu', device.index or 0)
    outs = [nd.zeros(s, ctx, d) for _, s, d in spec[2]]
    rtc.push([nd.from_torch(a, ctx) for a in args], outs, spec[3], spec[4])
    return [o.handle for o in outs]


def rtc_engine_checks(device, cfg):
    """NVRTC's library, a first compile and a cached one, the compile error
    and the launch-geometry error."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import MXNetError, nd
    from mxnet_tpu_torch.ops import nvrtc
    from mxnet_tpu_torch.rtc import Rtc
    info = nvrtc.info()
    log('  NVRTC %d.%d from %s, include %s, arch %s'
        % (*info['version'], info['path'], info['include'], info['arch']))
    ctx = mt.gpu(device.index or 0)
    spec = rtc_kernels(cfg)['rtc_k7c_rms']
    args = [nd.from_torch(a, ctx)
            for a in rtc_inputs('rtc_k7c_rms', spec, device, seed=30)]
    outs = [nd.zeros(spec[2][0][1], ctx, 'bfloat16')]
    times = []
    for _ in range(2):            # the second Rtc of the same source
        rtc = make_rtc('rtc_k7c_rms', spec, ctx)
        before = nvrtc.stats['compiles']
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rtc.push(args, outs, *spec[3:])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        compiled = nvrtc.stats['compiles'] - before
        check(compiled == (1 if len(times) == 1 else 0),
              'push %d compiled %d times' % (len(times), compiled))
    n = 200
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        rtc.push(args, outs, *spec[3:])
    torch.cuda.synchronize()
    steady_us = (time.perf_counter() - t0) / n * 1e6
    log('  k7c push and kernel, host clock: first %.1f ms (NVRTC compile and '
        'module load %.1f ms); a second Rtc of the same source %.3f ms, no '
        'compile; %d pushes of one Rtc back to back: %.1f us a push'
        % (times[0], nvrtc.stats['compile_ms'], times[1], n, steady_us))

    x, y = nd.zeros((4,), ctx), nd.zeros((4,), ctx)
    bad = Rtc('rtc_syntax_error', [('x', x)], [('y', y)],
              'y[threadIdx.x] = x[threadIdx.x] +;', mode='cuda')
    try:
        bad.push([x], [y])
    except MXNetError as e:
        msg = str(e)
        check('rtc_syntax_error' in msg and 'error' in msg,
              "the compile error does not carry NVRTC's log: %s" % msg)
        log("  a body with a syntax error: MXNetError with NVRTC's log: %s"
            % ' | '.join(ln.strip() for ln in msg.splitlines()
                         if 'error' in ln)[:300])
    else:
        check(False, 'a body with a syntax error compiled')
    before = nvrtc.launch.launches
    try:
        rtc.push(args, outs, grid_dims=(1,), block_dims=(2048,))
    except ValueError as e:
        log('  a 2048-thread block: ValueError before any launch (%s)' % e)
    else:
        check(False, 'a 2048-thread block was taken')
    check(nvrtc.launch.launches == before, 'a refused geometry launched')
    cpu_x, cpu_y = nd.zeros((4,), mt.cpu()), nd.zeros((4,), mt.cpu())
    try:
        Rtc('rtc_on_cpu', [('x', cpu_x)], [('y', cpu_y)], 'y[0] = x[0];',
            mode='cuda').push([cpu_x], [cpu_y])
    except ValueError:
        log("  CPU tensors: ValueError, nothing runs in the kernel's place")
    else:
        check(False, "mode='cuda' ran on CPU tensors")
    check(nvrtc.launch.launches == before, 'a refused push launched')


def first_mlp_input(model, tokens):
    """Layer 0 of the model up to its MLP: the residual stream after
    attention, which the MLP's pre-norm reads."""
    from mxnet_tpu_torch.transformer import HEAD_DIM, _rms
    B, S = tokens.shape
    H = model.cfg.n_heads
    blk = model.layers[0]
    x = model.embed[tokens]
    q, k, v = (_rms(x, blk.g1) @ blk.wqkv).view(B, S, H, 3 * HEAD_DIM) \
        .split(HEAD_DIM, dim=-1)
    a = model.attention(q, k, v, causal=True)
    return x + a.reshape(B, S, H * HEAD_DIM) @ blk.wo


def rel_rms(a, b):
    a, b = a.float(), b.float()
    return float((a - b).square().mean().sqrt() / b.square().mean().sqrt())


def rtc_path(device, cfg, model):
    """Phase (i)'s main path: an imperative step on gpu(0) at full width
    through the nd surface and the user kernels. Returns ({kernel:
    launches}, {kernel: Rtc})."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.ops import nvrtc
    from mxnet_tpu_torch.transformer import bench_batch
    ctx = mt.gpu(device.index or 0)
    specs = rtc_kernels(cfg)
    rtcs = {name: make_rtc(name, spec, ctx) for name, spec in specs.items()}
    tokens = torch.from_numpy(bench_batch(cfg, MAX_BATCH, seed=0)[0]).to(device)
    blk = model.layers[0]
    with torch.no_grad():
        resid = first_mlp_input(model, tokens)
    g2, wup = blk.g2.detach(), blk.wup.detach()
    act = tuple(resid.shape)
    hid = act[:-1] + (wup.shape[1],)

    # the main path: counts are zeroed just before and read just after
    for r in rtcs.values():
        r.launches = 0
    nvrtc.launch.launches = 0
    # the reference's mx.rtc usage: fill with x[:] = 1, push, read y
    x = nd.zeros((10,), ctx)
    x[:] = 1
    y = nd.zeros((10,), ctx)
    rtcs['rtc_k7a_reference'].push([x], [y], *specs['rtc_k7a_reference'][3:])
    t = nd.arange(0, 8, ctx=ctx)
    t3 = nd.zeros((8,), ctx)
    rtcs['rtc_k7b_triple'].push([t], [t3])
    # layer 0's MLP at full width: pre-norm and GELU through user kernels
    acts = nd.zeros(act, ctx, 'bfloat16')
    acts[:] = nd.from_torch(resid, ctx)
    normed = nd.zeros(act, ctx, 'bfloat16')
    rtcs['rtc_k7c_rms'].push([acts, nd.from_torch(g2, ctx)], [normed],
                             *specs['rtc_k7c_rms'][3:])
    hidden = nd.from_torch(normed.handle @ wup, ctx)
    gelu = nd.zeros(hid, ctx, 'bfloat16')
    rtcs['rtc_k7d_gelu'].push([hidden], [gelu])
    mix = gelu * 0.5 + hidden
    row = mix[0, 3, :4]
    total = mix.sum()
    scaled = y + t3[1:3].sum()
    nd.waitall()
    launches = {name: r.launches for name, r in rtcs.items()}
    log('  launches: %s (NVRTC launches %d)' % (launches, nvrtc.launch.launches))
    check(launches == dict.fromkeys(rtcs, 1) and nvrtc.launch.launches == 4,
          'user-kernel launches %s' % launches)

    # the step against torch on the same tensors, and against the plain chain
    e5 = torch.exp(torch.tensor(5.0, device=device))
    want_t3 = torch.arange(8, dtype=torch.float32, device=device) * 3
    check(bool(torch.allclose(y.handle, e5.expand(10), rtol=1e-6, atol=0))
          and bool(torch.equal(t3.handle, want_t3))
          and bool(torch.equal(acts.handle, resid)),
          'k7a/k7b or the x[:] fill disagree')
    want_mix = gelu.handle * 0.5 + hidden.handle
    check(bool(torch.equal(mix.handle, want_mix))
          and bool(torch.equal(row.handle, want_mix[0, 3, :4]))
          and total.shape == (1,) and total.handle.dtype == want_mix.dtype
          and bool(torch.equal(total.handle, want_mix.sum().reshape(1)))
          and bool(torch.allclose(scaled.handle, e5 + 9.0, rtol=1e-6, atol=0)),
          'the nd step disagrees with torch on the same tensors')
    with torch.no_grad():
        plain_hidden = rtc_plain('rtc_k7c_rms')(resid, g2) @ wup
        plain_mix = rtc_plain('rtc_k7d_gelu')(plain_hidden) * 0.5 + plain_hidden
    got_sum = float(total.asscalar())
    want_sum = float(plain_mix.float().sum())
    abs_sum = float(plain_mix.float().abs().sum())
    err_mix = rel_rms(mix.handle, plain_mix)
    # the total is a bf16 value: rounded once, by up to half a bf16 ulp of
    # the f32 total (2**(e - 9) for a total in [2**(e-1), 2**e)), beside
    # which the user kernels' few differing elements spread as above
    sum_tol = 2.0 ** (math.frexp(want_sum)[1] - 9) + STEP_REL_RMS * abs_sum
    log('  step at full width (%s -> %s bf16): x[:] fill exact; nd ops equal '
        'torch on the same tensors; vs the plain chain: rel RMS %.3e, sum '
        '%.6g vs %.6g (|diff| %.6g, limit %.6g; |diff| / sum|x| %.3e)'
        % (act, hid, err_mix, got_sum, want_sum, abs(got_sum - want_sum),
           sum_tol, abs(got_sum - want_sum) / abs_sum))
    check(err_mix <= STEP_REL_RMS and abs(got_sum - want_sum) <= sum_tol
          and bool(torch.isfinite(mix.handle).all()),
          'the step disagrees with the plain chain')
    return launches, rtcs


def rtc_vs_plain(device, cfg, rtcs):
    """Each user kernel against its plain version on seeded inputs at the
    main path's shapes. Returns {kernel: max |err|}."""
    import torch
    errs = {}
    for i, (name, spec) in enumerate(rtc_kernels(cfg).items()):
        args = rtc_inputs(name, spec, device, seed=40 + i)
        got, = push(rtcs[name], spec, args, device)
        want = rtc_plain(name)(*args)
        atol, rtol = RTC_TOL[name]
        errs[name] = float((got.float() - want.float()).abs().max())
        share = float((got != want).float().mean())
        ok = (got.shape == want.shape and got.dtype == want.dtype
              and bool(torch.isfinite(got).all())
              and excess(got, want, atol, rtol) <= atol
              and share < RTC_DIFF_SHARE)
        log('  %-18s %-22s %-8s max|err| vs plain %.3e, %.2e of the elements '
            'differ  %s' % (name, tuple(got.shape),
                            str(got.dtype).replace('torch.', ''), errs[name],
                            share, 'ok' if ok else 'FAIL'))
        check(ok, '%s disagrees with its plain version' % name)
        del args, got, want
    return errs


def rtc_times(device, cfg, rtcs):
    """Each user kernel at the main path's shapes from a cold L2: its time
    through Rtc.push, its plain version's, one PyTorch call's and its
    bound."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.context import Context
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    out = {}
    ctx = Context('gpu', device.index or 0)
    for name, spec in rtc_kernels(cfg).items():
        args = rtc_inputs(name, spec, device, seed=50)
        # the NDArrays are made outside the timed call: nd.zeros fills on
        # the card, and Rtc.push itself only allocates its outputs
        ins = [nd.from_torch(a, ctx) for a in args]
        outs = [nd.zeros(s, ctx, d) for _, s, d in spec[2]]
        kernel_ms = device_ms(lambda: rtcs[name].push(ins, outs, *spec[3:]),
                              flush=flush)
        plain_ms = device_ms(lambda: rtc_plain(name)(*args), flush=flush)
        lib = rtc_library(name, args)
        library_ms = device_ms(lib, flush=flush) if lib is not None else None
        res = outs[0].handle
        nbytes = sum(a.numel() * a.element_size() for a in args) \
            + res.numel() * res.element_size()
        ops = RTC_OPS_PER_ELEMENT[name] * args[0].numel()
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = 'bytes' if t_bytes >= t_ops else 'operations'
        extra = ''
        if name == 'rtc_k7c_rms' and hasattr(F, 'rms_norm'):
            x, g = args
            extra = ('; F.rms_norm %.4f ms (not the same function: it does '
                     'not round before g)'
                     % device_ms(lambda: F.rms_norm(x, (x.shape[-1],), g, 1e-6),
                                 flush=flush))
        log('  %-18s %-22s kernel %.4f ms, plain %.4f ms, library %s ms, bound '
            '%.4f ms (%s: %.1f MB), bound / kernel %.3f%s'
            % (name, tuple(args[0].shape), kernel_ms, plain_ms,
               'n/a' if library_ms is None else '%.4f' % library_ms, bound_ms,
               bound_by, nbytes / 1e6, bound_ms / kernel_ms, extra))
        out[name] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
        del args, res, ins, outs
    del flush
    return out


# ---------------------------------------------------------------------------
# (e) times of the row kernels
# ---------------------------------------------------------------------------

# operations per element of each row kernel's arithmetic (f32, outside the
# tensor cores): layernorm add; sub, mul, add; sub, mul, mul, add -> 8;
# rmsnorm mul, add; mul, mul -> 4; softmax max; sub, exp, add; sub, exp,
# div -> 7; xent max; sub, exp, add -> 4.
ROW_OPS_PER_ELEMENT = {'layernorm': 8, 'rmsnorm': 4, 'softmax': 7,
                       'softmax_xent': 4}


def row_bound_ms(kernel, args, out):
    """(bound ms, 'bytes' or 'operations', bytes, ops): each input read once
    and the output written once over the memory rate, against the f32
    operations over the f32 rate."""
    nbytes = sum(a.numel() * a.element_size() for a in args) \
        + out.numel() * out.element_size()
    ops = ROW_OPS_PER_ELEMENT[kernel] * args[0].numel()
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops else 'operations',
            nbytes, ops)


def library_call(kernel, args):
    """One PyTorch call computing the kernel's function, timed as a
    yardstick only (the port never calls it), or None."""
    import torch
    import torch.nn.functional as F
    if kernel == 'layernorm':
        x, g, b = args
        g, b = g.to(x.dtype), b.to(x.dtype)
        return lambda: F.layer_norm(x, (x.shape[-1],), g, b, 1e-5)
    if kernel == 'rmsnorm':
        if not hasattr(F, 'rms_norm'):
            return None
        x, g = args
        g = g.to(x.dtype)
        return lambda: F.rms_norm(x, (x.shape[-1],), g, 1e-6)
    if kernel == 'softmax':
        return lambda: torch.softmax(args[0], -1)
    logits, labels = args
    labels = labels.long()
    return lambda: F.cross_entropy(logits, labels, reduction='none')


def row_times(device, cfg):
    """Each row kernel at its shape on the model's path (bf16 activations
    and scores, f32 logits), from a cold L2: its time, its plain version's,
    one PyTorch call's and its bound."""
    import torch
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    shapes = model_shapes(cfg)
    out = {}
    for kernel in ROW_KERNELS:
        dtype = 'float32' if kernel == 'softmax_xent' else 'bfloat16'
        args = row_inputs(kernel, shapes[kernel], dtype, device, seed=21)
        if kernel == 'softmax_xent':
            args[1].clamp_(0, cfg.vocab - 1)         # bench's labels are in range
        fwd, ref, _ = row_fns(kernel)
        kernel_ms = device_ms(lambda: fwd(*args), flush=flush)
        plain_ms = device_ms(lambda: ref(*args), flush=flush, runs=10)
        lib = library_call(kernel, args)
        library_ms = device_ms(lib, flush=flush) if lib is not None else None
        bound_ms, bound_by, nbytes, ops = row_bound_ms(kernel, args, fwd(*args))
        extra = ''
        if kernel == 'layernorm':
            from mxnet_tpu_torch.ops import cuda_kernels as ck
            check(ck._layernorm_body(args[0]) == 'warp', 'layernorm body')
            extra = ' (warp body)'
        log('  %-12s %-22s %-8s kernel %.4f ms%s, plain %.4f ms, library %s '
            'ms, bound %.4f ms (%s: %.1f MB, %.2f GFLOP), bound / kernel %.3f'
            % (kernel, tuple(shapes[kernel]), dtype, kernel_ms, extra, plain_ms,
               'n/a' if library_ms is None else '%.4f' % library_ms, bound_ms,
               bound_by, nbytes / 1e6, ops / 1e9, bound_ms / kernel_ms))
        out[kernel] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound_ms, bound_by=bound_by)
        del args
    del flush
    return out


# ---------------------------------------------------------------------------
# (e) times
# ---------------------------------------------------------------------------

def device_ms(fn, runs=TIMED_RUNS, warmup=3, flush=None):
    """Median device time of ``fn()`` in ms over ``runs`` CUDA-event pairs.
    A sleep kernel ahead of each start event lets the host enqueue the
    launch before the device reaches it, so host overhead is not timed.
    ``flush``: a buffer larger than the L2 cache, overwritten before each
    start event, so that ``fn`` finds its inputs in device memory."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        if flush is not None:
            flush.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def flash_bound_ms(B, T, H, D):
    """Least time for bf16 causal attention with Tq = Tk = T: q, k, v read
    and out (bf16), lse (f32) written once, vs 4*D FLOPs for each visible
    (query, key) pair (q.k and p.v), T*(T+1)/2 of them per head."""
    nbytes = 4 * B * T * H * D * 2 + B * H * T * 4
    flops = 4 * D * (T * (T + 1) // 2) * B * H
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops else 'operations',
            nbytes, flops)


def times(device, model, ref, cfg):
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    from mxnet_tpu_torch.transformer import HEAD_DIM
    B, T, H, D = MAX_BATCH, cfg.seq_len, cfg.n_heads, HEAD_DIM
    q, k, v = qkv(B, T, T, H, D, 'bfloat16', device, seed=5)
    check(ck._BODIES[ck._variant(q, k, v)] == 'wgmma', 'served shape body')
    kernel_ms = device_ms(lambda: ck.flash_fwd(q, k, v, True))
    plain_ms = device_ms(lambda: ck.flash_attention_lse_ref(q, k, v, True))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = device_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    bound_ms, bound_by, nbytes, flops = flash_bound_ms(B, T, H, D)
    log('  flash at [%d, %d, %d, %d] bf16 causal: wgmma body %.4f ms, plain '
        '%.4f ms, SDPA %.4f ms, bound %.4f ms (%s: %.1f MB, %.2f GFLOP), '
        'bound / kernel %.3f'
        % (B, T, H, D, kernel_ms, plain_ms, library_ms, bound_ms,
           bound_by, nbytes / 1e6, flops / 1e9, bound_ms / kernel_ms))
    nc_ms = device_ms(lambda: ck.flash_fwd(q, k, v, False))
    nc_lib = device_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=False))
    log('  flash non-causal at the same shape: wgmma body %.4f ms, SDPA %.4f ms'
        % (nc_ms, nc_lib))
    # the steady state of the tile loop, where a work item has 128 tiles
    ql, kl, vl = (t.transpose(1, 2) for t in qkv(1, 16384, 16384, H, D,
                                                  'bfloat16', device, seed=6))
    for causal in (True, False):
        pairs = 16384 * 16385 // 2 if causal else 16384 ** 2
        gflop = 4 * D * pairs * H / 1e9
        k_ms = device_ms(lambda: ck.flash_fwd(*(t.transpose(1, 2) for t in
                                                (ql, kl, vl)), causal), runs=10)
        l_ms = device_ms(lambda: F.scaled_dot_product_attention(
            ql, kl, vl, is_causal=causal), runs=10)
        log('  flash at [1, 16384, %d, %d] bf16 causal=%d: wgmma body %.4f ms '
            '(%.0f TFLOP/s), SDPA %.4f ms (%.0f TFLOP/s)'
            % (H, D, causal, k_ms, gflop / k_ms, l_ms, gflop / l_ms))
    del ql, kl, vl
    log('  host time of one flash_fwd call (enqueue, 200 back to back, the '
        'card busy): wgmma body %.1f us (three tensor maps encoded)'
        % host_us(lambda: ck.flash_fwd(q, k, v, True)))

    tokens = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab, (MAX_BATCH, cfg.seq_len)).astype(np.int32)).to(device)
    with torch.inference_mode():
        fwd_ms = device_ms(lambda: model(tokens), runs=20)
        ref_fwd_ms = device_ms(lambda: ref(tokens), runs=20)
    tok = MAX_BATCH * cfg.seq_len
    log('  full-width forward, batch %d x %d: %.3f ms (%.0f tokens/s); with the '
        'plain attention %.3f ms (%.0f tokens/s)'
        % (MAX_BATCH, cfg.seq_len, fwd_ms, tok / fwd_ms * 1e3, ref_fwd_ms,
           tok / ref_fwd_ms * 1e3))
    return dict(kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, fwd_ms=fwd_ms,
                ref_fwd_ms=ref_fwd_ms)


def host_us(fn, n=200):
    """Host time of one ``fn()`` call in us: ``n`` calls enqueued behind a
    sleep kernel that keeps the card busy, so that no call waits on it."""
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / n * 1e6


def profile_forward(device, model, cfg, n=3):
    """Device time by kernel over ``n`` forwards, and the device's idle share
    of the span from the first kernel's start to the last one's end."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    tokens = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab, (MAX_BATCH, cfg.seq_len)).astype(np.int32)).to(device)
    with torch.inference_mode():
        model(tokens)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                model(tokens)
            torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log('  the profiler recorded no device activity: not measured')
        return
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels))
    log('  %d kernels, %.3f ms busy per forward, idle share %.4f of the %.3f ms '
        'span' % (len(kernels), busy / n / 1e3, 1 - busy / span, span / n / 1e3))
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log('    %6.2f%%  %8.3f ms/forward  %s' % (100 * us / busy, us / n / 1e3,
                                                 name[:110]))


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available; this script runs on the card',
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.transformer import TransformerConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device('cuda', 0)
    t_start = time.perf_counter()

    log('(a) identity')
    card = card_identity()
    log(card)
    log('  torch %s, CUDA %s, %s' % (torch.__version__, torch.version.cuda,
                                     torch.cuda.get_device_name(0)))

    log('(b) build')
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:    # one nvcc per source
        list(pool.map(_build.load, SOURCES))
    log('  %s built and loaded in %.1f s'
        % (', '.join(n + '.cu' for n in SOURCES), time.perf_counter() - t0))
    for name in SOURCES:
        for line in _build.build_log(name).splitlines():
            if 'Function properties' in line or 'registers' in line or 'spill' in line:
                log('   ', line.strip())

    log('(c) flash kernel vs plain version')
    errs = kernel_vs_plain(device)

    cfg = TransformerConfig()
    log('(g) row kernels vs plain versions')
    row_kernels_vs_plain(device, cfg)

    log('(d) serving at full width')
    model, ref, launches, latencies, worst = serve(device, cfg, SERVE_ROWS,
                                                   MAX_BATCH)
    for rows, (sec, tm) in zip(SERVE_ROWS, latencies):
        log('  request of %2d rows: %.2f ms (%.0f tokens/s); host pad %.2f ms, '
            'dispatch %.2f ms, fetch (device wait, copy) %.2f ms'
            % (rows, sec * 1e3, rows * cfg.seq_len / sec, tm['pad_ms'],
               tm['dispatch_ms'], tm['fetch_ms']))

    log('(h) the NDArray path at full width')
    row_launches, nd_errs = nd_path(device, cfg, model)

    log('(i) mx.rtc on the card: user kernels compiled by NVRTC')
    rtc_engine_checks(device, cfg)
    rtc_launches, rtcs = rtc_path(device, cfg, model)
    rtc_errs = rtc_vs_plain(device, cfg, rtcs)

    log('(e) times (median of CUDA-event runs)')
    t = times(device, model, ref, cfg)
    rt = row_times(device, cfg)
    rtc_t = rtc_times(device, cfg, rtcs)
    log('(f) where the time goes: torch.profiler over 3 forwards at batch %d'
        % MAX_BATCH)
    profile_forward(device, model, cfg)
    log('  total %.1f s' % (time.perf_counter() - t_start))

    record = {'kernels': [{
        'name': 'flash_attention', 'route': 'cuda',
        'source': 'mxnet_tpu_torch/ops/csrc/flash_attention.cu',
        'replaces': 'mxnet_tpu/ops/pallas_kernels.py:90',
        'body': 'wgmma', 'launches': launches,
        'max_abs_err': errs[(SERVED_LAYOUT, True)],
        'ms': t['kernel_ms'], 'plain_ms': t['plain_ms'],
        'bound_ms': t['bound_ms'], 'bound_by': t['bound_by'],
        'library_ms': t['library_ms']}]}
    for kernel in ROW_KERNELS:
        record['kernels'].append({
            'name': kernel, 'route': 'cuda',
            'source': 'mxnet_tpu_torch/ops/csrc/row_kernels.cu',
            'replaces': ROW_REPLACES[kernel],
            **({'body': 'warp'} if kernel == 'layernorm' else {}),
            'launches': row_launches[row_fns(kernel)[0].__name__],
            'max_abs_err': nd_errs[kernel], **rt[kernel]})
    for name in rtc_kernels(cfg):
        record['kernels'].append({
            'name': name, 'route': 'cuda', 'source': 'chip_smoke.py',
            'replaces': RTC_REPLACES, 'launches': rtc_launches[name],
            'max_abs_err': rtc_errs[name], **rtc_t[name]})
    log(json.dumps(record))
    # the run uses one card, whatever the machine holds
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': 1}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
