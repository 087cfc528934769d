#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (a non-zero exit) when it fails:

(a) identity: the card's name and power limit, as nvidia-smi reports them;
(b) build: every CUDA kernel of the served path, compiled from the sources
    in this checkout with nvcc for sm_90a (timed);
(c) kernel vs plain version on the card, for the flash-attention kernel's
    out and lse: the served shape, contiguous and as the strided views of
    the fused qkv that the model passes, small f32 shapes, decode shapes
    (Tq < Tk), a ragged T = 1006, head dims 16/40/64/256, the empty cases,
    the two ValueError cases, and the autograd gradient;
(d) serving: the bench transformer at full width (D=1024, 8 layers,
    8 heads x 128, S=1024, V=16384, bf16, weights from seed 0) behind
    ServingEngine(max_batch=8) answers requests of 8, 5 and 11 rows.
    Their logits are held against a reference forward built on the plain
    attention, and the kernel's launch count must be 8 layers x chunks;
(e) times from CUDA events: the kernel, its plain version and PyTorch's
    scaled_dot_product_attention at the served shape, the kernel's bound,
    the full-width forward's tokens/s, and each request's latency.

The second-to-last line of its output is the kernel record
``{"kernels": [...]}``; the last is ``{"ok": true, "device": {...}}``.
Without CUDA, or without the package beside it, it exits non-zero and
prints neither.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and the dense bf16
# tensor-core FLOP/s. The bound of a kernel is the larger of its bytes over
# the memory rate and its operations over the peak for its type.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

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

# (label, B, Tq, Tk, H, D, dtype, causal). Kernel bodies: bf16 at
# D in {16, 32, 64, 128} with aligned rows runs the mma.sync body; f32, and
# bf16 at other head dims, the scalar body. The served layout's q, k, v are
# the strided views the model gives the kernel: [B, T, H, 3*D] split on the
# last axis (token stride 3*H*D, head stride 3*D, offsets 0, D and 2*D).
SERVED_LAYOUT = 'served layout (qkv views)'
CASES = [
    ('served shape', 8, 1024, 1024, 8, 128, 'bfloat16', True),
    (SERVED_LAYOUT, 8, 1024, 1024, 8, 128, 'bfloat16', True),
    ('f32 small', 2, 128, 128, 4, 64, 'float32', False),
    ('f32 small causal', 2, 128, 128, 4, 64, 'float32', True),
    ('decode Tq=1 Tk=32', 4, 1, 32, 8, 128, 'bfloat16', True),
    ('decode Tq=16 Tk=32', 4, 16, 32, 8, 128, 'bfloat16', True),
    ('decode Tq=1 Tk=1024', 4, 1, 1024, 8, 128, 'bfloat16', True),
    ('decode Tq=16 Tk=1024', 4, 16, 1024, 8, 128, 'bfloat16', True),
    ('decode f32 Tq=16 Tk=1024', 2, 16, 1024, 4, 64, 'float32', True),
    ('ragged T=1006', 1, 1006, 1006, 2, 128, 'bfloat16', True),
    ('ragged f32 T=1006', 1, 1006, 1006, 2, 64, 'float32', False),
    ('D=16', 2, 256, 256, 4, 16, 'bfloat16', True),
    ('D=16 f32', 2, 256, 256, 4, 16, 'float32', True),
    ('D=64', 2, 256, 256, 4, 64, 'bfloat16', False),
    ('D=40 scalar body', 2, 200, 200, 2, 40, 'bfloat16', True),
    ('D=256 scalar body', 1, 128, 128, 2, 256, 'bfloat16', True),
]

# Tolerances (|kernel - plain| <= atol + rtol * |plain|), with their reasons:
# - f32: both sides compute in f32 with the sums in another order (and the
#   plain side's matmuls with TF32 off): a few f32 ulps of the row sums,
#   the tolerance the JAX package's own kernel tests use (2e-5).
# - bf16 out: the kernel rounds p to bf16 before the p.v product, and both
#   sides round the output to bf16 once (2**-8 relative each): 1e-2.
# - lse (f32 on both sides, the scores exact products of bf16 inputs
#   summed in f32): 1e-4.
TOL = {'float32': (2e-5, 2e-5), 'bfloat16': (1e-2, 1e-2)}
LSE_TOL = (1e-4, 1e-4)


def qkv(B, Tq, Tk, H, D, dtype, device, seed=0, interleaved=False):
    """q, k, v from ``seed``: contiguous, or (``interleaved``, Tq == Tk)
    views of one head-interleaved [B, T, H, 3*D] tensor, as the model
    splits its fused qkv projection."""
    import torch
    rng = np.random.RandomState(seed)
    if interleaved:
        fused = rng.standard_normal((B, Tq, H, 3 * D)).astype(np.float32)
        return torch.from_numpy(fused).to(
            device=device, dtype=getattr(torch, dtype)).split(D, dim=-1)
    q = rng.standard_normal((B, Tq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Tk, H, D)).astype(np.float32)
    v = rng.standard_normal((B, Tk, H, D)).astype(np.float32)
    return [torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype))
            for a in (q, k, v)]


def excess(got, want, atol, rtol):
    """max(|got - want| - rtol*|want|); <= atol means within tolerance."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() - rtol * want.abs()).max())


def kernel_vs_plain(device):
    import torch
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    errs = {}
    for label, B, Tq, Tk, H, D, dtype, causal in CASES:
        q, k, v = qkv(B, Tq, Tk, H, D, dtype, device,
                      interleaved=label == SERVED_LAYOUT)
        out, lse = ck.flash_fwd(q, k, v, causal)
        ref_out, ref_lse = ck.flash_attention_lse_ref(q, k, v, causal)
        atol, rtol = TOL[dtype]
        err = float((out.float() - ref_out.float()).abs().max())
        lse_err = float((lse - ref_lse).abs().max())
        ok = (bool(torch.isfinite(out).all())
              and excess(out, ref_out, atol, rtol) <= atol
              and excess(lse, ref_lse, *LSE_TOL) <= LSE_TOL[0])
        log('  %-26s %-8s causal=%d body=%s  max|out err| %.3e  '
            'max|lse err| %.3e  %s' % (label, dtype, causal,
                                       'mma' if ck._variant(q, k, v) else 'scalar',
                                       err, lse_err, 'ok' if ok else 'FAIL'))
        check(ok, 'kernel disagrees with its plain version: %s' % label)
        errs[label] = err

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
    answers, latencies = [], []
    for req in requests:
        t = time.perf_counter()
        timings = {}
        chunks = engine.dispatch_rows(req, timings=timings)
        answers.append(engine.fetch_chunks(chunks, timings=timings)[0])
        latencies.append((time.perf_counter() - t, timings))
    launches = ck.flash_fwd.launches

    check(launches == cfg.n_layers * n_chunks,
          'flash launches %d != %d layers x %d chunks'
          % (launches, cfg.n_layers, n_chunks))
    log('  %d requests (%s rows) in %d chunks: %d flash launches = %d layers '
        'x %d chunks' % (len(requests), list(rows_list), n_chunks, launches,
                         cfg.n_layers, n_chunks))

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
# (e) times
# ---------------------------------------------------------------------------

def device_ms(fn, runs=TIMED_RUNS, warmup=3):
    """Median device time of ``fn()`` in ms over ``runs`` CUDA-event pairs.
    A sleep kernel ahead of each start event lets the host enqueue the
    launch before the device reaches it, so host overhead is not timed."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
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
    kernel_ms = device_ms(lambda: ck.flash_fwd(q, k, v, True))
    plain_ms = device_ms(lambda: ck.flash_attention_lse_ref(q, k, v, True))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = device_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    bound_ms, bound_by, nbytes, flops = flash_bound_ms(B, T, H, D)
    log('  flash at [%d, %d, %d, %d] bf16 causal: kernel %.4f ms, plain %.4f ms, '
        'SDPA %.4f ms, bound %.4f ms (%s: %.1f MB, %.2f GFLOP)'
        % (B, T, H, D, kernel_ms, plain_ms, library_ms, bound_ms, bound_by,
           nbytes / 1e6, flops / 1e9))

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
    _build.load('flash_attention')
    log('  flash_attention.cu built and loaded in %.1f s' % (time.perf_counter() - t0))
    for line in _build.build_log('flash_attention').splitlines():
        if 'Function properties' in line or 'registers' in line or 'spill' in line:
            log('   ', line.strip())

    log('(c) kernel vs plain version')
    errs = kernel_vs_plain(device)

    log('(d) serving at full width')
    cfg = TransformerConfig()
    model, ref, launches, latencies, worst = serve(device, cfg, SERVE_ROWS,
                                                   MAX_BATCH)
    for rows, (sec, tm) in zip(SERVE_ROWS, latencies):
        log('  request of %2d rows: %.2f ms (%.0f tokens/s); host pad %.2f ms, '
            'dispatch %.2f ms, fetch (device wait, copy) %.2f ms'
            % (rows, sec * 1e3, rows * cfg.seq_len / sec, tm['pad_ms'],
               tm['dispatch_ms'], tm['fetch_ms']))

    log('(e) times (median of CUDA-event runs)')
    t = times(device, model, ref, cfg)
    log('(f) where the time goes: torch.profiler over 3 forwards at batch %d'
        % MAX_BATCH)
    profile_forward(device, model, cfg)
    log('  total %.1f s' % (time.perf_counter() - t_start))

    record = {'kernels': [{
        'name': 'flash_attention', 'route': 'cuda',
        'source': 'mxnet_tpu_torch/ops/csrc/flash_attention.cu',
        'replaces': 'mxnet_tpu/ops/pallas_kernels.py:90',
        'launches': launches, 'max_abs_err': errs[SERVED_LAYOUT],
        'ms': t['kernel_ms'], 'plain_ms': t['plain_ms'],
        'bound_ms': t['bound_ms'], 'bound_by': t['bound_by'],
        'library_ms': t['library_ms']}]}
    log(json.dumps(record))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
