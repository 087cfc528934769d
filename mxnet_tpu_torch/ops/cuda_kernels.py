"""Hand-written CUDA kernels for the hot ops: the counterpart of
``mxnet_tpu/ops/pallas_kernels.py``.

- :func:`flash_attention` / :func:`flash_attention_lse` — attention by an
  online softmax over K/V tiles, with no [Tq, Tk] score matrix in device
  memory (``csrc/flash_attention.cu``). One kernel serves both, as one
  ``pallas_call`` does on the TPU.
- :func:`fused_layernorm`, :func:`fused_rmsnorm`, :func:`fused_softmax` and
  :func:`softmax_xent` — last-axis row kernels (``csrc/row_kernels.cu``):
  one pass of statistics in f32 and one of output per row, with no padding
  of the row count.

A wrapper launches its kernel for CUDA tensors and raises on what the
kernel does not take; it runs the plain PyTorch version beside it only
for tensors on the CPU (the role interpret mode plays for Pallas). Each
wrapper counts its launches in a plain integer (``flash_fwd.launches``,
``layernorm_fwd.launches``, ...), so a run can show that its path went
through the kernel. Where a kernel has several bodies, the wrapper picks
one from the call's dtype, shape, strides and addresses before it
launches (:func:`_variant` for attention, :func:`_layernorm_body`), never
retries with another, and counts each body's launches in
``launches_by_body``. Backward passes
recompute through the plain version (a ``torch.autograd.Function``),
as the JAX package's ``custom_vjp`` does: the kernels are forward-only.
"""
import ctypes
import math

import torch

from . import _build

__all__ = ['flash_attention', 'flash_attention_lse', 'flash_attention_ref',
           'flash_attention_lse_ref', 'flash_fwd', 'MAX_HEAD_DIM',
           'fused_layernorm', 'fused_rmsnorm', 'fused_softmax', 'softmax_xent',
           'layernorm_ref', 'rmsnorm_ref', 'softmax_ref', 'softmax_xent_ref',
           'layernorm_fwd', 'rmsnorm_fwd', 'softmax_fwd', 'softmax_xent_fwd']

_NEG = -1e30
MAX_HEAD_DIM = 256          # largest head dim the kernel takes
_MMA_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_INT32_MAX = 2 ** 31 - 1
_MAX_Q_TILES = 65535      # the grid's y extent; the smallest q tile is 32 rows


# ---------------------------------------------------------------------------
# Plain versions (the counterparts of _flash_ref and _flash_lse_ref)
# ---------------------------------------------------------------------------

def _scores(q, k, causal, scale):
    s = torch.einsum('bqhd,bkhd->bhqk', q.float() * scale, k.float())
    if causal:
        Tq, Tk = q.shape[1], k.shape[1]
        mask = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).tril(Tk - Tq)
        s = s.masked_fill(~mask, _NEG)
    return s


def flash_attention_lse_ref(q, k, v, causal=False, scale=None):
    """(out, lse) in plain PyTorch, f32 inside: out in q's dtype, lse
    [B, H, Tq] f32. Differentiable; the kernel's backward runs through it."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = _scores(q, k, causal, scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum('bhqk,bkhd->bqhd', p, v.float())
    return out.to(q.dtype), lse


def flash_attention_ref(q, k, v, causal=False, scale=None):
    """softmax(q kᵀ scale) v in plain PyTorch, f32 inside, out in q's dtype."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    p = torch.softmax(_scores(q, k, causal, scale), dim=-1)
    return torch.einsum('bhqk,bkhd->bqhd', p, v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# The kernel's wrapper
# ---------------------------------------------------------------------------

def _lib():
    lib = _build.load('flash_attention')
    fn = lib.mxtt_flash_fwd
    if fn.argtypes is None:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = ([i32, i32, vp, vp, vp, vp, vp] + [i32] * 5 + [i64] * 12
                       + [ctypes.c_float, i32, vp])
        fn.restype = ctypes.c_int
        lib.mxtt_error_string.argtypes = [i32]
        lib.mxtt_error_string.restype = ctypes.c_char_p
    return lib


def _check_shapes(q, k, v, causal):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError('flash attention takes [B, T, H, D] tensors, got '
                         'ranks %d, %d, %d' % (q.dim(), k.dim(), v.dim()))
    B, Tq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError('shape mismatch: q %s, k %s, v %s'
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    Tk = k.shape[1]
    if causal and Tq > Tk:
        # bottom-right alignment would give the first Tq-Tk query rows no
        # visible key (a softmax over nothing)
        raise ValueError('causal attention requires Tq <= Tk '
                         '(got Tq=%d, Tk=%d)' % (Tq, Tk))
    if Tk == 0:
        raise ValueError('attention requires at least one key (Tk=0)')
    return B, Tq, H, D, Tk


_BODIES = ('scalar', 'mma', 'wgmma')    # by variant number


def _variant(q, k, v, scale=None):
    """The flash body for these tensors: 2 (wgmma, with TMA) for bf16 at
    D = 128 with a positive scale (its softmax runs in base 2 from the
    row max of the unscaled scores) and positive strides (a TMA map takes
    no zero stride, so K/V broadcast with ``expand`` stay on mma.sync),
    1 (mma.sync) for bf16 at another head dim it is built for or at
    D = 128 outside those limits, 0 (scalar) otherwise. Both tensor-core
    bodies need 16-byte aligned bases and every stride but the last a
    multiple of 8 elements (TMA's 16-byte strides); ``scale`` defaults to
    D**-0.5."""
    D = q.shape[-1]
    if q.dtype != torch.bfloat16 or D not in _MMA_HEAD_DIMS:
        return 0
    for t in (q, k, v):
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
            return 0
    scale = D ** -0.5 if scale is None else scale
    B, Tq, H = q.shape[:3]
    items = B * H * -(-Tq // 128)          # the wgmma body's work items
    strided = all(s > 0 for t in (q, k, v) for s in t.stride()[:3])
    return 2 if (D == 128 and scale > 0 and strided
                 and items <= _INT32_MAX) else 1


def _launch_cuda(q, k, v, causal, scale):
    """Launch the flash kernel on CUDA tensors with the body :func:`_variant`
    picks."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    for name, t in (('k', k), ('v', v)):
        if t.device != q.device:
            raise ValueError('%s is on %s, q on %s' % (name, t.device, q.device))
        if t.dtype != q.dtype:
            raise TypeError('%s is %s, q is %s' % (name, t.dtype, q.dtype))
    if q.dtype not in _DTYPE_CODE:
        raise TypeError('the flash kernel takes float32, bfloat16 or float16, '
                        'got %s' % q.dtype)
    if D > MAX_HEAD_DIM:
        raise ValueError('the flash kernel takes head dims up to %d, got %d'
                         % (MAX_HEAD_DIM, D))
    for name, t in (('q', q), ('k', k), ('v', v)):
        if t.stride(-1) != 1:
            raise ValueError('%s must have a unit stride on its last axis '
                             '(got strides %s)' % (name, t.stride()))
    if B * H > _INT32_MAX or Tk > _INT32_MAX or Tq > _MAX_Q_TILES * 32:
        raise ValueError('shape too large for the flash kernel: %s'
                         % (tuple(q.shape),))
    out = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    lib = _lib()
    variant = _variant(q, k, v, scale)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mxtt_flash_fwd(
            variant, _DTYPE_CODE[q.dtype], q.data_ptr(),
            k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            B, H, Tq, Tk, D, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3], float(scale), int(causal),
            stream)
    if err:
        raise RuntimeError('flash attention kernel launch failed (%s body): '
                           '%s (%d)' % (_BODIES[variant],
                                        lib.mxtt_error_string(err).decode(), err))
    flash_fwd.launches += 1
    flash_fwd.launches_by_body[_BODIES[variant]] += 1
    return out, lse


def flash_fwd(q, k, v, causal=False, scale=None):
    """(out, lse) of the forward pass: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors. No autograd; see
    :func:`flash_attention_lse` for that."""
    B, Tq, H, D, Tk = _check_shapes(q, k, v, causal)
    scale = D ** -0.5 if scale is None else float(scale)
    if B * H == 0 or Tq == 0:          # nothing to launch
        return (torch.zeros((B, Tq, H, D), dtype=q.dtype, device=q.device),
                torch.zeros((B, H, Tq), dtype=torch.float32, device=q.device))
    if q.device.type == 'cuda':
        return _launch_cuda(q, k, v, causal, scale)
    if q.device.type != 'cpu' or k.device != q.device or v.device != q.device:
        raise ValueError('flash attention runs on CUDA tensors (the kernel) '
                         'or CPU tensors (the plain version); got q on %s, '
                         'k on %s, v on %s' % (q.device, k.device, v.device))
    with torch.no_grad():
        return flash_attention_lse_ref(q, k, v, causal, scale)


flash_fwd.launches = 0
flash_fwd.launches_by_body = dict.fromkeys(_BODIES, 0)


class _FlashFunction(torch.autograd.Function):
    """The kernel's forward; a backward that recomputes through the plain
    version (the counterpart of the custom_vjp pair in pallas_kernels)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out, lse = flash_attention_lse_ref(q, k, v, ctx.causal, ctx.scale)
            used = [(o, g) for o, g in ((out, g_out), (lse, g_lse))
                    if g is not None]
            dq, dk, dv = torch.autograd.grad([o for o, _ in used], (q, k, v),
                                             [g for _, g in used],
                                             allow_unused=True)
        return dq, dk, dv, None, None


def flash_attention_lse(q, k, v, causal=False, scale=None, block_q=128,
                        block_k=128):
    """Attention on [B, T, H, D] that also returns the row log-sum-exp
    [B, H, Tq] in f32. ``scale`` defaults to D**-0.5 and multiplies q in
    f32; the causal mask is aligned bottom-right (query i sees keys
    <= i + Tk - Tq). ``block_q``/``block_k`` are advisory, as on the TPU:
    the kernel picks its own tiles. Raises ValueError on causal Tq > Tk
    and on Tk == 0; returns zeros, launching nothing, when B*H == 0 or
    Tq == 0."""
    del block_q, block_k
    return _FlashFunction.apply(q, k, v, bool(causal), scale)


def flash_attention(q, k, v, causal=False, scale=None, block_q=128,
                    block_k=128):
    """:func:`flash_attention_lse` without the lse."""
    del block_q, block_k
    return _FlashFunction.apply(q, k, v, bool(causal), scale)[0]


# ---------------------------------------------------------------------------
# Row kernels: LayerNorm, RMSNorm, softmax and softmax cross-entropy over the
# last axis (csrc/row_kernels.cu)
# ---------------------------------------------------------------------------

_ROW_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_LABEL_DTYPES = {torch.int32: 0, torch.int64: 1}
_MAX_ROWS = 2 ** 31 - 1      # the grid's x extent: one block per row


def layernorm_ref(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis in plain PyTorch (the counterpart of
    ``_ln_ref``): f32 mean and two-pass variance, gamma and beta applied
    in f32, the result in x's dtype."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def rmsnorm_ref(x, gamma, eps=1e-6):
    """x * rsqrt(mean(x^2) + eps) * gamma over the last axis in plain
    PyTorch (the counterpart of ``_rms_ref``): f32 inside, x's dtype out."""
    x32 = x.float()
    inv = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * inv * gamma.float()).to(x.dtype)


def softmax_ref(x):
    """Last-axis softmax in plain PyTorch (the body of ``_softmax_kernel``):
    f32 inside, x's dtype out."""
    x32 = x.float()
    e = torch.exp(x32 - x32.amax(-1, keepdim=True))
    return (e / e.sum(-1, keepdim=True)).to(x.dtype)


def softmax_xent_ref(logits, labels):
    """Per-row logsumexp(logits) - logits[label] as f32 [N], in plain
    PyTorch (the body of ``_xent_kernel``). A label outside [0, V) matches
    no column: its gold logit is 0."""
    x = logits.float()
    m = x.amax(-1, keepdim=True)
    lse = torch.log(torch.exp(x - m).sum(-1)) + m[:, 0]
    cols = torch.arange(x.shape[-1], device=x.device)
    onehot = cols == labels.reshape(-1, 1)
    return lse - torch.where(onehot, x, torch.zeros((), device=x.device)).sum(-1)


def _row_lib():
    lib = _build.load('row_kernels')
    if lib.mxtt_softmax.argtypes is None:
        vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                             ctypes.c_float)
        lib.mxtt_layernorm.argtypes = [i32, i32, vp, vp, i32, vp, i32, vp, i64,
                                       i64, f32, vp]
        lib.mxtt_rmsnorm.argtypes = [i32, vp, vp, i32, vp, i64, i64, f32, vp]
        lib.mxtt_softmax.argtypes = [i32, vp, vp, i64, i64, vp]
        lib.mxtt_softmax_xent.argtypes = [i32, vp, vp, i32, vp, i64, i64, vp]
        for fn in (lib.mxtt_layernorm, lib.mxtt_rmsnorm, lib.mxtt_softmax,
                   lib.mxtt_softmax_xent):
            fn.restype = ctypes.c_int
        lib.mxtt_row_error_string.argtypes = [i32]
        lib.mxtt_row_error_string.restype = ctypes.c_char_p
    return lib


def _rows(x, what):
    """(N, D): the row count and width of ``x`` over its last axis."""
    if x.dim() == 0:
        raise ValueError('%s works over the last axis; got a 0-d tensor' % what)
    return math.prod(x.shape[:-1]), x.shape[-1]


def _check_on_cpu(what, *tensors):
    """The plain version runs for CPU tensors only."""
    devices = {t.device for t in tensors}
    if devices != {torch.device('cpu')}:
        raise ValueError('%s runs on CUDA tensors (the kernel) or CPU tensors '
                         '(the plain version); got tensors on %s'
                         % (what, sorted(str(d) for d in devices)))


def _check_row_input(x, what):
    if x.dtype not in _ROW_DTYPES:
        raise TypeError('the %s kernel takes float32, bfloat16 or float16, '
                        'got %s' % (what, x.dtype))
    N, D = _rows(x, what)
    if N > _MAX_ROWS:
        raise ValueError('the %s kernel takes at most %d rows, got %d'
                         % (what, _MAX_ROWS, N))
    return N, D


def _check_param(p, name, x, D, what):
    if p.device != x.device:
        raise ValueError('%s is on %s, x on %s' % (name, p.device, x.device))
    if p.dtype not in _ROW_DTYPES:
        raise TypeError('%s of the %s kernel must be float32, bfloat16 or '
                        'float16, got %s' % (name, what, p.dtype))
    if tuple(p.shape) != (D,):
        raise ValueError('%s must have shape (%d,), got %s'
                         % (name, D, tuple(p.shape)))
    return p.contiguous()


def _raise_on(err, lib, what):
    if err:
        raise RuntimeError('%s kernel launch failed: %s (%d)'
                           % (what, lib.mxtt_row_error_string(err).decode(), err))


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


_LN_BODIES = ('block', 'warp')          # by body number
_MAX_WARP_ROW_BYTES = 4096


def _layernorm_body(x):
    """The LayerNorm body for the contiguous ``x``: 'warp' (one warp a row,
    the row in registers) where its rows start 16-byte aligned and are a
    whole number of 16-byte vectors up to 4 KB, else 'block' (one block a
    row, any width and alignment)."""
    row_bytes = x.shape[-1] * x.element_size()
    if (x.dtype in _ROW_DTYPES and 0 < row_bytes <= _MAX_WARP_ROW_BYTES
            and row_bytes % 16 == 0 and x.data_ptr() % 16 == 0):
        return 'warp'
    return 'block'


def _launch_norm(fwd, kind, x, params, eps):
    """Launch the layernorm or rmsnorm kernel over x's rows and count the
    launch on ``fwd``. LayerNorm takes the body :func:`_layernorm_body`
    picks."""
    N, D = _check_row_input(x, kind)
    params = [_check_param(p, n, x, D, kind)
              for p, n in zip(params, ('gamma', 'beta'))]
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if N == 0 or D == 0:                    # nothing to launch
        return out
    x = x.contiguous()
    lib = _row_lib()
    args = []
    for p in params:
        args += [p.data_ptr(), _ROW_DTYPES[p.dtype]]
    with torch.cuda.device(x.device):
        if kind == 'layernorm':
            body = _layernorm_body(x)
            err = lib.mxtt_layernorm(_LN_BODIES.index(body), _ROW_DTYPES[x.dtype],
                                     x.data_ptr(), *args, out.data_ptr(), N, D,
                                     float(eps), _stream(x.device))
        else:
            err = lib.mxtt_rmsnorm(_ROW_DTYPES[x.dtype], x.data_ptr(), *args,
                                   out.data_ptr(), N, D, float(eps),
                                   _stream(x.device))
    _raise_on(err, lib, kind)
    fwd.launches += 1
    if kind == 'layernorm':
        fwd.launches_by_body[body] += 1
    return out


def layernorm_fwd(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. No autograd; see :func:`fused_layernorm`.

    x is float32, bfloat16 or float16 of any shape (its leading axes are the
    rows); gamma and beta are [D] in any of those three dtypes, read as f32.
    The result has x's shape and dtype. Raises TypeError on another dtype and
    ValueError on a 0-d x or a parameter of another shape or device."""
    _rows(x, 'layernorm')
    if x.device.type == 'cuda':
        return _launch_norm(layernorm_fwd, 'layernorm', x, (gamma, beta), eps)
    _check_on_cpu('layernorm', x, gamma, beta)
    with torch.no_grad():
        return layernorm_ref(x, gamma, beta, eps)


layernorm_fwd.launches = 0
layernorm_fwd.launches_by_body = dict.fromkeys(_LN_BODIES, 0)


def rmsnorm_fwd(x, gamma, eps=1e-6):
    """RMSNorm over the last axis: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. No autograd; see :func:`fused_rmsnorm`.
    Takes what :func:`layernorm_fwd` takes, without beta."""
    _rows(x, 'rmsnorm')
    if x.device.type == 'cuda':
        return _launch_norm(rmsnorm_fwd, 'rmsnorm', x, (gamma,), eps)
    _check_on_cpu('rmsnorm', x, gamma)
    with torch.no_grad():
        return rmsnorm_ref(x, gamma, eps)


rmsnorm_fwd.launches = 0


def softmax_fwd(x):
    """Last-axis softmax: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. No autograd; see :func:`fused_softmax`.
    x is float32, bfloat16 or float16 (TypeError otherwise); the result has
    its shape and dtype. Raises ValueError on a 0-d x."""
    _rows(x, 'softmax')
    if x.device.type == 'cuda':
        N, D = _check_row_input(x, 'softmax')
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        if N == 0 or D == 0:                # nothing to launch
            return out
        x = x.contiguous()
        lib = _row_lib()
        with torch.cuda.device(x.device):
            err = lib.mxtt_softmax(_ROW_DTYPES[x.dtype], x.data_ptr(),
                                   out.data_ptr(), N, D, _stream(x.device))
        _raise_on(err, lib, 'softmax')
        softmax_fwd.launches += 1
        return out
    _check_on_cpu('softmax', x)
    with torch.no_grad():
        return softmax_ref(x)


softmax_fwd.launches = 0


def softmax_xent_fwd(logits, labels):
    """Per-row cross-entropy logsumexp(logits) - logits[label] as f32 [N]:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors. No
    autograd; see :func:`softmax_xent`.

    logits are [N, V] float32, bfloat16 or float16; labels are [N] int32 or
    int64 (TypeError otherwise). A label outside [0, V) gives the row's
    logsumexp (its gold logit is 0) and is never read as an address. Raises
    ValueError for V = 0 (a softmax over nothing); N = 0 gives an empty
    result without a launch."""
    if logits.dim() != 2:
        raise ValueError('softmax_xent takes [N, V] logits, got shape %s'
                         % (tuple(logits.shape),))
    N, V = logits.shape
    if tuple(labels.shape) != (N,):
        raise ValueError('labels must have shape (%d,), got %s'
                         % (N, tuple(labels.shape)))
    if V == 0:
        raise ValueError('softmax_xent needs at least one class (V = 0)')
    if logits.device.type == 'cuda':
        _check_row_input(logits, 'softmax_xent')
        if labels.device != logits.device:
            raise ValueError('labels are on %s, logits on %s'
                             % (labels.device, logits.device))
        if labels.dtype not in _LABEL_DTYPES:
            raise TypeError('the softmax_xent kernel takes int32 or int64 '
                            'labels, got %s' % labels.dtype)
        loss = torch.empty((N,), dtype=torch.float32, device=logits.device)
        if N == 0:                          # nothing to launch
            return loss
        logits, labels = logits.contiguous(), labels.contiguous()
        lib = _row_lib()
        with torch.cuda.device(logits.device):
            err = lib.mxtt_softmax_xent(
                _ROW_DTYPES[logits.dtype], logits.data_ptr(), labels.data_ptr(),
                _LABEL_DTYPES[labels.dtype], loss.data_ptr(), N, V,
                _stream(logits.device))
        _raise_on(err, lib, 'softmax_xent')
        softmax_xent_fwd.launches += 1
        return loss
    _check_on_cpu('softmax_xent', logits, labels)
    with torch.no_grad():
        return softmax_xent_ref(logits, labels)


softmax_xent_fwd.launches = 0


def _ref_grads(ref, inputs, grad, *args):
    """The gradients of ``ref(*inputs, *args)`` for the cotangent ``grad``:
    the backward of the norm kernels, which recompute through their plain
    versions as the JAX package's custom_vjp does."""
    leaves = [t.detach().requires_grad_() for t in inputs]
    with torch.enable_grad():
        out = ref(*leaves, *args)
        return torch.autograd.grad(out, leaves, grad)


class _LayerNormFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.save_for_backward(x, gamma, beta)
        ctx.eps = eps
        return layernorm_fwd(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, g):
        return (*_ref_grads(layernorm_ref, ctx.saved_tensors, g, ctx.eps), None)


class _RMSNormFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, eps):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return rmsnorm_fwd(x, gamma, eps)

    @staticmethod
    def backward(ctx, g):
        return (*_ref_grads(rmsnorm_ref, ctx.saved_tensors, g, ctx.eps), None)


class _SoftmaxFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = softmax_fwd(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        # d/dx softmax = y * (g - sum(g * y)) along the row
        y, = ctx.saved_tensors
        return y * (g - (g * y).sum(-1, keepdim=True))


class _XentFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        ctx.save_for_backward(logits, labels)
        return softmax_xent_fwd(logits, labels)

    @staticmethod
    def backward(ctx, g):
        # (softmax - onehot) * g; a label outside [0, V) has a zero one-hot
        # row, as jax.nn.one_hot gives it. No gradient for the labels.
        logits, labels = ctx.saved_tensors
        p = softmax_ref(logits.float())
        cols = torch.arange(logits.shape[-1], device=logits.device)
        onehot = (cols == labels.reshape(-1, 1)).to(p.dtype)
        return ((p - onehot) * g[:, None]).to(logits.dtype), None


def fused_layernorm(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis (the counterpart of the JAX package's
    ``fused_layernorm``): :func:`layernorm_fwd` forward, a backward that
    recomputes through :func:`layernorm_ref`."""
    return _LayerNormFunction.apply(x, gamma, beta, float(eps))


def fused_rmsnorm(x, gamma, eps=1e-6):
    """RMSNorm over the last axis (the counterpart of ``fused_rmsnorm``):
    :func:`rmsnorm_fwd` forward, a backward through :func:`rmsnorm_ref`."""
    return _RMSNormFunction.apply(x, gamma, float(eps))


def fused_softmax(x):
    """Last-axis softmax (the counterpart of ``fused_softmax``):
    :func:`softmax_fwd` forward, backward y * (g - sum(g * y))."""
    return _SoftmaxFunction.apply(x)


def softmax_xent(logits, labels):
    """Per-example cross-entropy [N] f32 from logits [N, V] and integer
    labels [N] (the counterpart of ``softmax_xent``), without a softmax in
    device memory: :func:`softmax_xent_fwd` forward, backward
    (softmax - onehot) * g in the logits' dtype."""
    return _XentFunction.apply(logits, labels)
