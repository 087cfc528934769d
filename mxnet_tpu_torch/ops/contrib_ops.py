"""Contrib ops: the counterpart of ``mxnet_tpu/ops/contrib_ops.py`` for
its CTC loss (``_contrib_CTCLoss``, with the alias ``ctc_loss``).

The loss is the JAX package's forward recursion in log space, step for
step (not ``F.ctc_loss``, whose numbers differ): alpha over the extended
label sequence (blanks interleaved, length ``2 L + 1``), a loop over the
time steps, the gradient by autograd through it. Kept as the JAX package
has them (ROADMAP.md §3):

- the log-zero is ``-1e10``, so an alignment that cannot fit (more labels
  than steps allow) gives a loss of about ``1e10`` where ``F.ctc_loss``
  gives ``inf``;
- an empty label reads the last extended position twice (``idx_prev``
  clips to ``idx_last``), so its loss is the true one less ``ln 2``.

The detection and signal ops of the JAX module are not ported yet
(ROADMAP.md §1 item 9).
"""
import torch

from .registry import register, register_alias

_NEG_INF = -1e10


@register('_contrib_CTCLoss',
          input_names=['data', 'label', 'data_lengths', 'label_lengths'],
          optional_inputs={'data_lengths': 'use_data_lengths',
                           'label_lengths': 'use_label_lengths'},
          param_defaults={'use_data_lengths': False, 'use_label_lengths': False,
                          'blank_label': 'first', 'padding_mask': None})
def _ctc_loss(attrs, data, label, *opt):
    """data (T, N, V) unnormalised activations, label (N, L). Blank
    ``'first'`` reserves index 0 (labels 1..V-1), ``'last'`` V-1 (labels
    0..V-2). Label lengths come from ``label_lengths``
    (``use_label_lengths``), the first ``padding_mask`` entry, or the count
    of entries inside the blank convention's range; ``data_lengths``
    freezes each sample's alpha past its length. Step 0 always counts.
    Returns the loss (N,)."""
    use_dl = attrs.get('use_data_lengths', False)
    use_ll = attrs.get('use_label_lengths', False)
    opt = [o for o in opt if o is not None]
    data_lengths = opt.pop(0) if use_dl and opt else None
    label_lengths = opt.pop(0) if use_ll and opt else None

    T, N, V = data.shape
    dev = data.device
    blank_first = attrs.get('blank_label', 'first') == 'first'
    blank = 0 if blank_first else V - 1
    logp = torch.log_softmax(data, dim=-1)
    labels = label.to(torch.int64)
    L = labels.shape[1]

    pad = attrs.get('padding_mask', None)
    if label_lengths is not None:
        lab_len = label_lengths.to(torch.int64)
    elif pad is not None:
        is_pad = labels == int(pad)
        lab_len = torch.where(is_pad.any(dim=1),
                              is_pad.to(torch.int32).argmax(dim=1),
                              torch.full_like(labels[:, 0], L))
    elif blank_first:
        lab_len = (labels > 0).sum(dim=1)
    else:
        lab_len = ((labels >= 0) & (labels < V - 1)).sum(dim=1)

    # entries past each sample's length must not poison the `same` mask or
    # the gather with out-of-range values (padding_mask may be -1)
    valid = torch.arange(L, device=dev)[None, :] < lab_len[:, None]
    labels = torch.where(valid, labels.clamp(0, V - 1),
                         torch.full_like(labels, blank))

    # extended label sequence: blank interleaved, length 2L+1
    S = 2 * L + 1
    ext = torch.full((N, S), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = labels
    ext_len = 2 * lab_len + 1

    # alpha in f32 at least, as jnp.full's default dtype makes it
    adt = torch.promote_types(logp.dtype, torch.float32)
    alpha = torch.cat([logp[0, :, blank, None].to(adt),
                       logp[0].gather(1, ext[:, 1:2]).to(adt),
                       torch.full((N, S - 2), _NEG_INF, dtype=adt,
                                  device=dev)], dim=1)
    same = torch.cat([torch.zeros((N, 2), dtype=torch.bool, device=dev),
                      ext[:, 2:] == ext[:, :-2]], dim=1)
    skip_blocked = (ext == blank) | same
    pad1 = torch.full((N, 1), _NEG_INF, dtype=adt, device=dev)
    pad2 = torch.full((N, 2), _NEG_INF, dtype=adt, device=dev)
    live_len = data_lengths.to(torch.int64) if data_lengths is not None \
        else None
    for t in range(1, T):
        a1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        a2 = torch.cat([pad2, alpha[:, :-2]], dim=1)
        a2 = torch.where(skip_blocked, torch.full_like(a2, _NEG_INF), a2)
        merged = torch.logaddexp(torch.logaddexp(alpha, a1), a2)
        new_alpha = merged + logp[t].gather(1, ext)
        if live_len is not None:
            new_alpha = torch.where((t < live_len)[:, None], new_alpha,
                                    alpha)
        alpha = new_alpha
    idx_last = (ext_len - 1).clamp(0, S - 1)
    idx_prev = (ext_len - 2).clamp(0, S - 1)
    ll = torch.logaddexp(alpha.gather(1, idx_last[:, None])[:, 0],
                         alpha.gather(1, idx_prev[:, None])[:, 0])
    return -ll


register_alias('ctc_loss', '_contrib_CTCLoss')
