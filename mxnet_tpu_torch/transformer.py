"""The GPT-style decoder that ``bench.py`` measures
(``build_transformer_step``): a torch module for serving, and bench's
training step.

:func:`forward` is the counterpart of bench's ``fwd``: token embedding, L
pre-norm blocks (RMSNorm, head-interleaved fused qkv, causal flash
attention, output projection, RMSNorm, 4x GELU MLP), a final RMSNorm and
an untied head, over a sequence of weights in bench's order.
:class:`TransformerLM` holds them as parameters; :func:`make_train_step`
builds bench's step (bf16 copies of f32 masters, the loss
``mean(logsumexp - gold)`` on f32 logits, one ``mp_sgd_mom_update`` per
master). Weights keep bench's ``x @ W`` layout ([in, out]) and its order,
so :func:`params_from_jax` carries bench's masters across as they are, and
:func:`init_params` draws the same numbers from the same seed.
"""
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .context import as_torch_device
from .ops import registry
from .ops.cuda_kernels import flash_attention

__all__ = ['HEAD_DIM', 'TransformerConfig', 'TransformerLM', 'forward',
           'init_params', 'bench_batch', 'params_from_jax', 'bench_loss',
           'loss_and_grads', 'make_train_step', 'TRAIN_ATTRS']

HEAD_DIM = 128              # bench's DH: heads are d_model // HEAD_DIM
_LAYER_PARAMS = ('g1', 'wqkv', 'wo', 'g2', 'wup', 'wdn')


@dataclass(frozen=True)
class TransformerConfig:
    """Widths of the model; the defaults are bench's full width."""
    vocab: int = 16384
    d_model: int = 1024
    n_layers: int = 8
    seq_len: int = 1024

    def __post_init__(self):
        if self.d_model % HEAD_DIM:
            raise ValueError('d_model %d is not a multiple of the head dim %d'
                             % (self.d_model, HEAD_DIM))

    @property
    def n_heads(self):
        return self.d_model // HEAD_DIM


def _param_shapes(V, D, L):
    """(name, shape) of every parameter, in bench's order."""
    out = [('embed', (V, D))]
    for i in range(L):
        out += [('layers.%d.%s' % (i, n), s) for n, s in zip(
            _LAYER_PARAMS,
            ((D,), (D, 3 * D), (D, D), (D,), (D, 4 * D), (4 * D, D)))]
    return out + [('gf', (D,)), ('head', (D, V))]


def _draw_params(cfg, rng):
    def p(*shape, scale=None):
        s = scale if scale is not None else shape[0] ** -0.5
        return (rng.standard_normal(shape) * s).astype(np.float32)

    D, V = cfg.d_model, cfg.vocab
    params = [p(V, D, scale=0.02)]
    for _ in range(cfg.n_layers):
        params += [np.ones((D,), np.float32), p(D, 3 * D), p(D, D),
                   np.ones((D,), np.float32), p(D, 4 * D), p(4 * D, D)]
    params += [np.ones((D,), np.float32), p(D, V, scale=0.02 ** 0.5)]
    return tuple(params)


def init_params(cfg, seed=0):
    """Float32 numpy weights in bench's order, drawn as bench draws them:
    one ``RandomState(seed)``, N(0, 1) scaled by ``shape[0] ** -0.5`` by
    default, 0.02 for the embedding, 0.02**0.5 for the head, and ones for
    the norm gains."""
    return _draw_params(cfg, np.random.RandomState(seed))


def _draw_batch(cfg, batch, rng):
    shape = (batch, cfg.seq_len)
    tokens = rng.randint(0, cfg.vocab, shape).astype(np.int32)
    labels = rng.randint(0, cfg.vocab, shape).astype(np.int32)
    return tokens, labels


def bench_batch(cfg, batch, seed=0):
    """(tokens, labels): bench's training batch, int32 [batch, seq_len]
    each, drawn as ``bench.build_transformer_step`` draws them: from the
    ``RandomState(seed)`` that drew its weights, after them."""
    rng = np.random.RandomState(seed)
    _draw_params(cfg, rng)
    return _draw_batch(cfg, batch, rng)


def params_from_jax(masters):
    """Bench's master tuple (embed, [g1, wqkv, wo, g2, wup, wdn] x L, gf,
    head; JAX or numpy arrays) as a state dict for :class:`TransformerLM`
    (float32 CPU tensors; ``load_state_dict`` casts and moves them)."""
    arrays = [np.array(m, dtype=np.float32) for m in masters]
    if len(arrays) < 3 or (len(arrays) - 3) % len(_LAYER_PARAMS):
        raise ValueError('expected 3 + 6*L parameter arrays, got %d'
                         % len(arrays))
    V, D = arrays[0].shape
    L = (len(arrays) - 3) // len(_LAYER_PARAMS)
    state = {}
    for (name, shape), a in zip(_param_shapes(V, D, L), arrays):
        if a.shape != shape:
            raise ValueError('%s: expected shape %s, got %s'
                             % (name, shape, a.shape))
        state[name] = torch.from_numpy(a)
    return state


class _Block(nn.Module):
    def __init__(self, D, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.g1 = nn.Parameter(torch.ones(D, **kw))
        self.wqkv = nn.Parameter(torch.empty(D, 3 * D, **kw))
        self.wo = nn.Parameter(torch.empty(D, D, **kw))
        self.g2 = nn.Parameter(torch.ones(D, **kw))
        self.wup = nn.Parameter(torch.empty(D, 4 * D, **kw))
        self.wdn = nn.Parameter(torch.empty(4 * D, D, **kw))


def _rms(x, g):
    # bench's rms: normalise in f32, cast back to x's type, then scale by g
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6)).to(x.dtype) * g


def forward(params, tokens, attention=flash_attention):
    """Bench's ``fwd``: logits [B, S, V] in the weights' dtype for tokens
    [B, S] (int), with ``params`` the weights in bench's order (embed,
    [g1, wqkv, wo, g2, wup, wdn] x L, gf, head). ``attention(q, k, v,
    causal=True)`` defaults to the CUDA flash kernel."""
    it = iter(params)
    embed = next(it)
    B, S = tokens.shape
    H = embed.shape[1] // HEAD_DIM
    x = embed[tokens]
    for _ in range((len(params) - 3) // len(_LAYER_PARAMS)):
        g1, wqkv, wo, g2, wup, wdn = (next(it) for _ in _LAYER_PARAMS)
        h = _rms(x, g1)
        # head-interleaved: qkv is [.., H, (q|k|v) x DH], as bench splits it
        q, k, v = (h @ wqkv).view(B, S, H, 3 * HEAD_DIM).split(HEAD_DIM, dim=-1)
        a = attention(q, k, v, causal=True)
        x = x + a.reshape(B, S, H * HEAD_DIM) @ wo
        h = _rms(x, g2)
        # jax.nn.gelu's default is the tanh form
        x = x + F.gelu(h @ wup, approximate='tanh') @ wdn
    gf, head = next(it), next(it)
    return _rms(x, gf) @ head


class TransformerLM(nn.Module):
    """Bench's decoder. ``forward(tokens [B, S] int)`` returns logits
    [B, S, V] in the parameter dtype (:func:`forward` over its parameters
    in bench's order). ``attention(q, k, v, causal=True)``
    defaults to the CUDA flash kernel; a reference model passes the plain
    version (``ops.cuda_kernels.flash_attention_ref``) explicitly.
    ``device`` defaults to the current context (the card)."""

    def __init__(self, cfg=TransformerConfig(), dtype=torch.bfloat16,
                 device=None, attention=flash_attention):
        super().__init__()
        device = as_torch_device(device)
        kw = dict(dtype=dtype, device=device)
        D, V = cfg.d_model, cfg.vocab
        self.cfg = cfg
        self.attention = attention
        self.embed = nn.Parameter(torch.empty(V, D, **kw))
        self.layers = nn.ModuleList(_Block(D, dtype, device)
                                    for _ in range(cfg.n_layers))
        self.gf = nn.Parameter(torch.ones(D, **kw))
        self.head = nn.Parameter(torch.empty(D, V, **kw))

    def forward(self, tokens):
        params = ((self.embed,)
                  + tuple(getattr(b, n) for b in self.layers for n in _LAYER_PARAMS)
                  + (self.gf, self.head))
        return forward(params, tokens, self.attention)


def bench_loss(params, tokens, labels, attention=flash_attention):
    """Bench's loss of the weights ``params`` on a batch: ``mean(logsumexp
    (logits) - gold)`` on the logits cast to f32."""
    logits = forward(params, tokens, attention).float()
    lse = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()


def loss_and_grads(params, tokens, labels, attention=flash_attention):
    """:func:`bench_loss` and its gradients with respect to ``params``
    (leaves that require them, in bench's order)."""
    loss = bench_loss(params, tokens, labels, attention)
    return loss.detach(), torch.autograd.grad(loss, params)


# bench's update (bench.py's attrs of mp_sgd_mom_update)
TRAIN_ATTRS = {'lr': 0.01, 'momentum': 0.9, 'wd': 0.0, 'rescale_grad': 1.0,
               'clip_gradient': -1.0}


def make_train_step(cfg=TransformerConfig(), batch=8, device=None,
                    attention=flash_attention, seed=0):
    """Bench's transformer training step (``bench.build_transformer_step``)
    on ``device`` (default: the current context, the card).

    Returns ``(step, masters, aux, vel, tokens, labels)`` as bench does
    (without its unused PRNG key): f32 masters drawn from ``seed`` as bench
    draws them, zero velocities, and bench's batch (int32 [batch, seq_len]
    tokens and labels, drawn after the weights). ``step(masters, aux, vel,
    tokens, labels)`` returns ``(masters, aux, vel, loss)``: the bf16
    copies of the masters are the leaves of autograd through
    :func:`forward` (``attention`` defaults to the flash kernel, whose
    backward recomputes through the plain version), the loss is
    ``mean(logsumexp(logits) - gold)`` on the logits cast to f32, and each
    master takes one call of the registry op ``mp_sgd_mom_update`` with
    :data:`TRAIN_ATTRS`, its bf16 gradient cast to f32 there."""
    device = as_torch_device(device)
    rng = np.random.RandomState(seed)
    masters = tuple(torch.from_numpy(p).to(device)
                    for p in _draw_params(cfg, rng))
    tokens, labels = (torch.from_numpy(a).to(device)
                      for a in _draw_batch(cfg, batch, rng))
    vel = tuple(torch.zeros_like(m) for m in masters)
    update = registry.get('mp_sgd_mom_update').fn

    def step(masters, aux, vel, tokens, labels):
        params = tuple(m.to(torch.bfloat16).requires_grad_() for m in masters)
        loss, grads = loss_and_grads(params, tokens, labels, attention)
        new_m, new_v = [], []
        with torch.no_grad():
            for m, p, g, v in zip(masters, params, grads, vel):
                _, nv, m32 = update(TRAIN_ATTRS, p.detach(), g, v, m)
                new_m.append(m32)
                new_v.append(nv)
        return tuple(new_m), aux, tuple(new_v), loss

    return step, masters, (), vel, tokens, labels
