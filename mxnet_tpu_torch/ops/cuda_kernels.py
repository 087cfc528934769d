"""Hand-written CUDA kernels for the hot ops: the counterpart of
``mxnet_tpu/ops/pallas_kernels.py``.

- :func:`flash_attention` / :func:`flash_attention_lse` — attention by an
  online softmax over K/V tiles, with no [Tq, Tk] score matrix in device
  memory (``csrc/flash_attention.cu``). One kernel serves both, as one
  ``pallas_call`` does on the TPU.

A wrapper launches its kernel for CUDA tensors and raises on what the
kernel does not take; it runs the plain PyTorch version beside it only
for tensors on the CPU (the role interpret mode plays for Pallas). Each
wrapper counts its launches in a plain integer (``flash_fwd.launches``),
so a run can show that its path went through the kernel. Backward passes
recompute through the plain version (a ``torch.autograd.Function``),
as the JAX package's ``custom_vjp`` does: the kernels are forward-only.
"""
import ctypes

import torch

from . import _build

__all__ = ['flash_attention', 'flash_attention_lse', 'flash_attention_ref',
           'flash_attention_lse_ref', 'flash_fwd', 'MAX_HEAD_DIM']

_NEG = -1e30
MAX_HEAD_DIM = 256          # largest head dim the kernel takes
_MMA_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
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


def _variant(q, k, v):
    """1 (the mma.sync body) for bf16 at a head dim it is built for with
    16-byte aligned rows, else 0 (the scalar body)."""
    D = q.shape[-1]
    if q.dtype != torch.bfloat16 or D not in _MMA_HEAD_DIMS:
        return 0
    for t in (q, k, v):
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
            return 0
    return 1


def _launch_cuda(q, k, v, causal, scale):
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    for name, t in (('k', k), ('v', v)):
        if t.device != q.device:
            raise ValueError('%s is on %s, q on %s' % (name, t.device, q.device))
        if t.dtype != q.dtype:
            raise TypeError('%s is %s, q is %s' % (name, t.dtype, q.dtype))
    if q.dtype not in _DTYPE_CODE:
        raise TypeError('the flash kernel takes float32 or bfloat16, got %s'
                        % q.dtype)
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
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mxtt_flash_fwd(
            _variant(q, k, v), _DTYPE_CODE[q.dtype], q.data_ptr(),
            k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            B, H, Tq, Tk, D, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3], float(scale), int(causal),
            stream)
    if err:
        raise RuntimeError('flash attention kernel launch failed: %s (%d)'
                           % (lib.mxtt_error_string(err).decode(), err))
    flash_fwd.launches += 1
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
