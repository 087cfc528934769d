"""Neural-network layer ops: the counterpart of ``mxnet_tpu/ops/nn.py`` for
the ops whose JAX versions dispatch to Pallas kernels — LayerNorm, softmax
and softmax_cross_entropy — registered under the same names, input names
and parameter defaults.

Each keeps both of the JAX op's branches, which differ in their numbers:
the kernel branch (the CUDA row kernels of :mod:`.cuda_kernels`; their
plain versions for CPU tensors) and the plain branch. :func:`use_fused`
chooses between them as the JAX package's ``use_fused()`` does, with the
card in the TPU's place.
"""
import torch

from ..config import flags
from . import cuda_kernels as ck
from .registry import register

__all__ = ['use_fused']


def use_fused(x):
    """True when the registry ops take their kernel branch for ``x``: always
    for a CUDA tensor; for a CPU tensor only when ``MXTPU_FORCE_PALLAS`` is
    set (the kernel wrappers then run their plain versions)."""
    if x.device.type == 'cuda':
        return True
    flags.reload('MXTPU_FORCE_PALLAS')  # tests toggle it per case
    return flags.get('MXTPU_FORCE_PALLAS')


@register('LayerNorm', input_names=['data', 'gamma', 'beta'],
          param_defaults={'axis': -1, 'eps': 1e-5})
def _layer_norm(attrs, x, gamma, beta):
    ax = int(attrs.get('axis', -1)) % x.ndim
    eps = attrs.get('eps', 1e-5)
    if ax == x.ndim - 1 and use_fused(x):
        return ck.fused_layernorm(x, gamma, beta, eps)
    x32 = x.float()
    mean = x32.mean(ax, keepdim=True)
    var = (x32 - mean).square().mean(ax, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    bshape = tuple(x.shape[ax] if i == ax else 1 for i in range(x.ndim))
    # y is rounded to x's dtype before gamma and beta, which then promote
    # (bf16 x with f32 gamma gives f32), as in the JAX op
    return y.to(x.dtype) * gamma.reshape(bshape) + beta.reshape(bshape)


@register('softmax', param_defaults={'axis': -1, 'temperature': None})
def _softmax(attrs, x):
    t = attrs.get('temperature', None)
    if t:
        x = x / t
    if not x.is_floating_point():
        x = x.float()       # jax.nn.softmax of an integer x is f32
    ax = int(attrs.get('axis', -1)) % x.ndim
    if ax == x.ndim - 1 and use_fused(x):
        return ck.fused_softmax(x)
    return torch.softmax(x, dim=ax)


@register('softmax_cross_entropy', input_names=['data', 'label'])
def _softmax_cross_entropy(attrs, data, label):
    lab = label.to(torch.int32)
    if use_fused(data):
        # per-row logsumexp - gold in one kernel: no softmax in memory
        return ck.softmax_xent(data, lab).sum().to(data.dtype)
    logp = torch.log_softmax(data, dim=-1)
    # jnp.take_along_axis: a negative label counts from the end, and one
    # still outside [0, V) picks NaN
    V = data.shape[-1]
    idx = torch.where(lab < 0, lab + V, lab)
    inside = (idx >= 0) & (idx < V)
    picked = torch.gather(logp, -1, idx.clamp(0, V - 1).long()[:, None])[:, 0]
    return -picked.masked_fill(~inside, float('nan')).sum()
