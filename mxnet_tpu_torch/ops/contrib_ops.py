"""Contrib ops: the counterpart of ``mxnet_tpu/ops/contrib_ops.py``: the
CTC loss (``_contrib_CTCLoss``, with the alias ``ctc_loss``), the
detection ops (``ROIPooling``, ``_contrib_PSROIPooling``,
``_contrib_DeformablePSROIPooling``, the MultiBox family, ``box_iou``,
``Proposal`` and ``MultiProposal``), the vision ops (``BilinearSampler``,
``GridGenerator``, ``SpatialTransformer``, ``Correlation``,
``_contrib_DeformableConvolution``), the signal and quantization ops
(``fft``, ``ifft``, ``count_sketch``, ``quantize``, ``dequantize``) and
``IdentityAttachKLSparseReg``.

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

The detection and vision ops compute what the JAX functions compute,
quirks included (ROADMAP.md §3): ``Correlation`` wraps around (a roll)
and reads neither ``kernel_size``, ``stride1`` nor ``pad_size``;
``MultiBoxDetection`` suppresses in one pass (a box is dropped if any
higher-ranked box of its class that passed the score threshold overlaps
it, suppressed or not); ``MultiProposal`` sweeps greedily and leaves the
unfilled tail zero; ``quantize`` rounds int8 half to even and uint8 as
``floor(x + 0.5)``; ``ifft`` scales by n. Rankings sort ``-score``
stably and ``argmax`` takes the first maximum, as jnp's do.

The JAX functions vmap over the batch or the rois and build whole
tensors that do not fit at full width (an A x A IoU a sample at SSD300's
8,732 anchors; a [C, H, W] mask a bin and roi for ROIPooling). Here
they go a block at a time with the same result:

- ``ROIPooling``'s max is separable over a bin's rows and columns; its
  gradient (a custom ``autograd.Function``) splits each bin's gradient
  evenly among the positions that tie for the max, as jnp's max does;
- ``MultiBoxDetection`` builds the IoU a block of rows at a time;
- ``MultiProposal``'s greedy sweep goes by blocks of ranks: the boxes
  kept in earlier blocks suppress a block in one step, and inside a
  block the sweep's equations (kept[i] = candidate[i] and no kept j < i
  overlaps i) are iterated to their fixed point, which is unique and is
  the greedy result;
- ``PSROIPooling`` sums a bin as two products with the bin's row and
  column masks; ``DeformablePSROIPooling`` samples only the channel
  that each output reads;
- ``Correlation``'s gradient (a custom ``autograd.Function``) goes a
  shift at a time without keeping the shifted copies.

An op whose sweep reads its data on the host returns empty outputs of
the right shape on ``meta`` tensors (shape inference).
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


def _is_meta(*tensors):
    return any(t is not None and t.device.type == 'meta' for t in tensors)


def _div_const(x, c):
    """``x / c`` for a constant ``c`` as the JAX package computes it: XLA's
    jit multiplies by the f32 reciprocal, which can differ from the
    quotient in the last place (7 / 3 gives 2.3333335, not 2.3333333), and
    so move a bin's floor or ceil."""
    return x * torch.tensor(1.0 / c, dtype=torch.float32).to(x.dtype)


def _chunk(per_item, budget=1 << 26):
    """How many items of ``per_item`` elements make a block of about
    ``budget`` elements (at least one)."""
    return max(1, budget // max(1, per_item))


# ---------------------------------------------------------------------------
# ROIPooling
# ---------------------------------------------------------------------------

def _roi_masks(rois, scale, ph, pw, H, W, device):
    """Each roi's bins as masks: rows [R, ph, H] and columns [R, pw, W]."""
    r = torch.round(rois[:, 1:5] * scale).to(torch.int64)
    x1, y1, x2, y2 = r.unbind(1)
    rh = torch.clamp(y2 - y1 + 1, min=1)
    rw = torch.clamp(x2 - x1 + 1, min=1)
    py = torch.arange(ph, device=device)
    px = torch.arange(pw, device=device)
    ylo = y1[:, None] + torch.div(py[None] * rh[:, None], ph,
                                  rounding_mode='floor')
    yhi = y1[:, None] + torch.div((py[None] + 1) * rh[:, None] + ph - 1, ph,
                                  rounding_mode='floor')
    xlo = x1[:, None] + torch.div(px[None] * rw[:, None], pw,
                                  rounding_mode='floor')
    xhi = x1[:, None] + torch.div((px[None] + 1) * rw[:, None] + pw - 1, pw,
                                  rounding_mode='floor')
    ys = torch.arange(H, device=device)
    xs = torch.arange(W, device=device)
    rows = (ys >= ylo[..., None]) & (ys < yhi[..., None])
    cols = (xs >= xlo[..., None]) & (xs < xhi[..., None])
    return rows, cols


class _ROIPoolFunction(torch.autograd.Function):
    """Max over each bin of each roi; the gradient split evenly among the
    positions that tie for a bin's max."""

    @staticmethod
    def forward(ctx, data, b, rows, cols):
        N, C, H, W = data.shape
        R, ph, pw = rows.shape[0], rows.shape[1], cols.shape[1]
        ninf = torch.tensor(float('-inf'), dtype=data.dtype,
                            device=data.device)
        out = torch.empty((R, C, ph, pw), dtype=data.dtype,
                          device=data.device)
        step = _chunk(C * H * W)
        for s in range(0, R, step):
            e = min(R, s + step)
            imgs = data[b[s:e]]
            # the max over a bin's columns, then over its rows
            colmax = torch.stack(
                [torch.where(cols[s:e, j, None, None, :], imgs, ninf).amax(3)
                 for j in range(pw)], dim=-1)
            out[s:e] = torch.stack(
                [torch.where(rows[s:e, i, None, :, None], colmax, ninf
                             ).amax(2) for i in range(ph)], dim=2)
        ctx.save_for_backward(data, b, rows, cols, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        data, b, rows, cols, out = ctx.saved_tensors
        N, C, H, W = data.shape
        R, ph, pw = out.shape[0], out.shape[2], out.shape[3]
        # a bin with no finite max gives 0 and passes no gradient
        grad = torch.where(torch.isfinite(out), grad, torch.zeros_like(grad))
        gdata = torch.zeros_like(data)
        step = _chunk(C * H * W)
        for s in range(0, R, step):
            e = min(R, s + step)
            imgs = data[b[s:e]]
            gimg = torch.zeros_like(imgs)
            for i in range(ph):
                in_row = rows[s:e, i, None, :, None]
                for j in range(pw):
                    tie = (imgs == out[s:e, :, i, j, None, None]) & in_row \
                        & cols[s:e, j, None, None, :]
                    n = tie.sum(dim=(2, 3)).clamp(min=1)
                    gimg += tie * (grad[s:e, :, i, j] / n)[..., None, None]
            gdata.index_add_(0, b[s:e], gimg)
        return gdata, None, None, None


@register('ROIPooling', input_names=['data', 'rois'],
          param_defaults={'pooled_size': (0, 0), 'spatial_scale': 1.0})
def _roi_pooling(attrs, data, rois):
    """data (N, C, H, W), rois (R, 5) of (batch, x1, y1, x2, y2) ->
    (R, C, ph, pw): each roi rounded to the feature grid at
    ``spatial_scale``, each bin's max (0 for an empty bin)."""
    ph, pw = attrs['pooled_size']
    scale = attrs.get('spatial_scale', 1.0)
    N, C, H, W = data.shape
    R = rois.shape[0]
    if _is_meta(data, rois):
        return data.new_empty((R, C, ph, pw))
    b = rois[:, 0].to(torch.int64).clamp(0, N - 1)
    rows, cols = _roi_masks(rois, scale, ph, pw, H, W, data.device)
    out = _ROIPoolFunction.apply(data, b, rows, cols)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


# ---------------------------------------------------------------------------
# BilinearSampler / GridGenerator / SpatialTransformer
# ---------------------------------------------------------------------------

def _bilinear_sample(data, grid):
    """data (N, C, H, W), grid (N, 2, Ho, Wo) of (x, y) in [-1, 1]; a
    corner outside the image reads 0."""
    N, C, H, W = data.shape
    gx = (grid[:, 0] + 1) * (W - 1) / 2
    gy = (grid[:, 1] + 1) * (H - 1) / 2
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = gx - x0
    wy = gy - y0
    flat = data.reshape(N, C, H * W)

    def gather(yy, xx):
        yi = torch.clamp(yy, 0, H - 1).to(torch.int64)
        xi = torch.clamp(xx, 0, W - 1).to(torch.int64)
        valid = (yy >= 0) & (yy <= H - 1) & (xx >= 0) & (xx <= W - 1)
        idx = (yi * W + xi).reshape(N, 1, -1).expand(N, C, -1)
        vals = flat.gather(2, idx).reshape((N, C) + tuple(yy.shape[1:]))
        return torch.where(valid[:, None], vals, torch.zeros_like(vals))

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    wx, wy = wx[:, None], wy[:, None]
    return (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy) +
            v10 * (1 - wx) * wy + v11 * wx * wy)


@register('BilinearSampler', input_names=['data', 'grid'])
def _bilinear_sampler(attrs, data, grid):
    return _bilinear_sample(data, grid)


@register('GridGenerator', input_names=['data'],
          param_defaults={'transform_type': 'affine', 'target_shape': (0, 0)})
def _grid_generator(attrs, data):
    """'affine': data (N, 6) -> the affine map of a target grid in [-1, 1]
    (N, 2, th, tw); 'warp': data a flow field (N, 2, H, W) added to the
    pixel grid and normalised to [-1, 1]."""
    th, tw = attrs['target_shape']
    if attrs.get('transform_type', 'affine') == 'affine':
        N = data.shape[0]
        dt = torch.promote_types(data.dtype, torch.float32)
        theta = data.reshape(N, 2, 3).to(dt)
        ys = torch.linspace(-1, 1, th, dtype=dt, device=data.device)
        xs = torch.linspace(-1, 1, tw, dtype=dt, device=data.device)
        gy, gx = torch.meshgrid(ys, xs, indexing='ij')
        coords = torch.stack([gx.reshape(-1), gy.reshape(-1),
                              torch.ones_like(gx).reshape(-1)])
        return torch.matmul(theta, coords).reshape(N, 2, th, tw)
    N, _, H, W = data.shape
    ys = torch.arange(H, dtype=data.dtype, device=data.device)
    xs = torch.arange(W, dtype=data.dtype, device=data.device)
    gy, gx = torch.meshgrid(ys, xs, indexing='ij')
    fx = _div_const((data[:, 0] + gx) * 2, max(W - 1, 1)) - 1
    fy = _div_const((data[:, 1] + gy) * 2, max(H - 1, 1)) - 1
    return torch.stack([fx, fy], dim=1)


@register('SpatialTransformer', input_names=['data', 'loc'],
          param_defaults={'target_shape': (0, 0), 'transform_type': 'affine',
                          'sampler_type': 'bilinear'})
def _spatial_transformer(attrs, data, loc):
    grid = _grid_generator({'transform_type': 'affine',
                            'target_shape': attrs['target_shape']}, loc)
    return _bilinear_sample(data, grid)


# ---------------------------------------------------------------------------
# Correlation (FlowNet)
# ---------------------------------------------------------------------------

def _shifts(attrs):
    d = int(attrs.get('max_displacement', 1))
    s2 = int(attrs.get('stride2', 1))
    r = range(-d, d + 1, s2)
    return [(dy, dx) for dy in r for dx in r]


class _CorrelationFunction(torch.autograd.Function):
    """The channel mean of a * roll(b) (or |a - roll(b)|) a shift at a
    time; the backward recomputes each shifted copy."""

    @staticmethod
    def forward(ctx, a, b, shifts, mult):
        outs = []
        for sh in shifts:
            moved = torch.roll(b, sh, dims=(2, 3))
            outs.append((a * moved).mean(dim=1) if mult
                        else torch.abs(a - moved).mean(dim=1))
        ctx.save_for_backward(a, b)
        ctx.shifts, ctx.mult = shifts, mult
        return torch.stack(outs, dim=1)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        C = a.shape[1]
        ga = torch.zeros_like(a)
        gb = torch.zeros_like(b)
        for k, sh in enumerate(ctx.shifts):
            moved = torch.roll(b, sh, dims=(2, 3))
            g = grad[:, k, None] / C
            if ctx.mult:
                ga += g * moved
                gm = g * a
            else:
                sg = torch.sign(a - moved)
                ga += g * sg
                gm = -(g * sg)
            gb += torch.roll(gm, (-sh[0], -sh[1]), dims=(2, 3))
        return ga, gb, None, None


@register('Correlation', input_names=['data1', 'data2'],
          param_defaults={'kernel_size': 1, 'max_displacement': 1, 'stride1': 1,
                          'stride2': 1, 'pad_size': 0, 'is_multiply': True})
def _correlation(attrs, a, b):
    """(N, S*S, H, W): for each shift (dy, dx) in range(-d, d + 1, stride2)
    squared, the channel mean of a * roll(b, (dy, dx)) (or of
    |a - roll(b)|)."""
    shifts = _shifts(attrs)
    mult = attrs.get('is_multiply', True)
    if _is_meta(a, b):
        return a.new_empty((a.shape[0], len(shifts)) + tuple(a.shape[2:]))
    return _CorrelationFunction.apply(a, b, shifts, bool(mult))


# ---------------------------------------------------------------------------
# fft / ifft / count_sketch / dequantize
# ---------------------------------------------------------------------------

@register('_contrib_fft', param_defaults={'compute_size': 128})
def _fft(attrs, x):
    """The FFT along the last axis, in complex64; the output interleaves
    the real and imaginary parts (..., 2n) in the input's dtype."""
    y = torch.fft.fft(x.to(torch.complex64), dim=-1)
    out = torch.stack([y.real, y.imag], dim=-1)
    return out.reshape(tuple(x.shape[:-1]) + (2 * x.shape[-1],)).to(x.dtype)


@register('_contrib_ifft', param_defaults={'compute_size': 128})
def _ifft(attrs, x):
    """The inverse of ``fft``'s layout, the real part, scaled by n."""
    n = x.shape[-1] // 2
    xr = x.reshape(tuple(x.shape[:-1]) + (n, 2)).float()
    y = torch.fft.ifft(torch.complex(xr[..., 0], xr[..., 1]), dim=-1)
    return (y.real * n).to(x.dtype)


@register('_contrib_count_sketch', input_names=['data', 'h', 's'],
          param_defaults={'out_dim': 0, 'processing_batch_size': 32})
def _count_sketch(attrs, data, h, s):
    """out[..., h[i]] += data[..., i] * s[i]."""
    out_dim = int(attrs['out_dim'])
    idx = h.reshape(-1).to(torch.int64)
    sign = s.reshape(-1)
    out = torch.zeros(tuple(data.shape[:-1]) + (out_dim,), dtype=data.dtype,
                      device=data.device)
    return out.index_add(data.dim() - 1, idx, (data * sign).to(data.dtype))


@register('_contrib_dequantize', input_names=['data', 'min_range', 'max_range'],
          param_defaults={'out_type': 'float32'}, differentiable=False)
def _dequantize(attrs, data, min_range, max_range):
    """int8 or uint8 codes back to f32 over [min_range, max_range]."""
    int8 = data.dtype == torch.int8
    qmin = -128.0 if int8 else 0.0
    qmax = 127.0 if int8 else 255.0
    scale = _div_const(max_range - min_range, qmax - qmin)
    return (data.to(torch.float32) - qmin) * scale + min_range


# ---------------------------------------------------------------------------
# the MultiBox family (SSD)
# ---------------------------------------------------------------------------

@register('_contrib_MultiBoxPrior',
          param_defaults={'sizes': (1.0,), 'ratios': (1.0,), 'clip': False,
                          'steps': (-1.0, -1.0), 'offsets': (0.5, 0.5)},
          differentiable=False)
def _multibox_prior(attrs, data):
    """(1, H * W * K, 4) corner anchors centred on each cell of data's
    (H, W): sizes[0] with each ratio, then each further size with
    ratios[0]."""
    H, W = data.shape[2], data.shape[3]
    dev = data.device
    f32 = torch.float32
    sizes = attrs.get('sizes', (1.0,))
    ratios = attrs.get('ratios', (1.0,))
    steps = attrs.get('steps', (-1.0, -1.0))
    offs = attrs.get('offsets', (0.5, 0.5))
    step_y = steps[0] if steps[0] > 0 else 1.0 / H
    step_x = steps[1] if steps[1] > 0 else 1.0 / W
    cy = (torch.arange(H, dtype=f32, device=dev) + offs[0]) * step_y
    cx = (torch.arange(W, dtype=f32, device=dev) + offs[1]) * step_x
    cyg, cxg = torch.meshgrid(cy, cx, indexing='ij')
    boxes = []
    combos = [(sizes[0], r) for r in ratios] + \
             [(s, ratios[0]) for s in sizes[1:]]
    for s, r in combos:
        root = torch.sqrt(torch.tensor(r, dtype=f32, device=dev))
        w = s * root / 2
        h = s / root / 2
        boxes.append(torch.stack([cxg - w, cyg - h, cxg + w, cyg + h], dim=-1))
    out = torch.stack(boxes, dim=2).reshape(-1, 4)
    if attrs.get('clip', False):
        out = torch.clamp(out, 0, 1)
    return out[None]


def _box_iou(a, b):
    """a (..., A, 4), b (..., B, 4) corner boxes -> (..., A, B)."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(br - tl, min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = torch.clamp((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1]),
                         min=0)
    area_b = torch.clamp((b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]),
                         min=0)
    return inter / torch.clamp(area_a[..., :, None] + area_b[..., None, :]
                               - inter, min=1e-12)


@register('_contrib_MultiBoxTarget',
          input_names=['anchor', 'label', 'cls_pred'],
          param_defaults={'overlap_threshold': 0.5, 'ignore_label': -1.0,
                          'negative_mining_ratio': -1.0,
                          'negative_mining_thresh': 0.5, 'minimum_negative_samples': 0,
                          'variances': (0.1, 0.1, 0.2, 0.2)},
          num_outputs=3, differentiable=False)
def _multibox_target(attrs, anchor, label, cls_pred):
    """anchor (1, A, 4), label (N, M, 5) of (class, box), -1 for padding
    -> (loc_target (N, A*4), loc_mask (N, A*4), cls_target (N, A)): an
    anchor matches the ground truth it overlaps most above the threshold,
    and each ground truth forces its best anchor (the last ground truth
    to name an anchor decides it, as a sequential scatter does)."""
    anchors = anchor.reshape(-1, 4)
    A = anchors.shape[0]
    N, M = label.shape[0], label.shape[1]
    var = attrs.get('variances', (0.1, 0.1, 0.2, 0.2))
    thresh = attrs.get('overlap_threshold', 0.5)
    valid = label[..., 0] >= 0                       # (N, M)
    gt = label[..., 1:5]
    iou = _box_iou(anchors, gt)                      # (N, A, M)
    iou = torch.where(valid[:, None, :], iou, torch.full_like(iou, -1.0))
    best_gt = iou.argmax(dim=2)                      # first maximum
    best_iou = iou.amax(dim=2)
    matched = best_iou > thresh
    best_anchor = iou.argmax(dim=1)                  # (N, M)
    last = torch.full((N, A), -1, dtype=torch.int64, device=label.device)
    last = last.scatter_reduce(
        1, best_anchor, torch.arange(M, device=label.device).expand(N, M),
        reduce='amax')
    force = (last >= 0) & valid.gather(1, last.clamp(min=0))
    matched = matched | force
    cls = torch.where(matched, label[..., 0].gather(1, best_gt) + 1,
                      torch.zeros_like(best_iou))
    g = gt.gather(1, best_gt[..., None].expand(N, A, 4))
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    aw = torch.clamp(anchors[:, 2] - anchors[:, 0], min=1e-8)
    ah = torch.clamp(anchors[:, 3] - anchors[:, 1], min=1e-8)
    gcx = (g[..., 0] + g[..., 2]) / 2
    gcy = (g[..., 1] + g[..., 3]) / 2
    gw = torch.clamp(g[..., 2] - g[..., 0], min=1e-8)
    gh = torch.clamp(g[..., 3] - g[..., 1], min=1e-8)
    tx = _div_const((gcx - acx) / aw, var[0])
    ty = _div_const((gcy - acy) / ah, var[1])
    tw = _div_const(torch.log(gw / aw), var[2])
    th = _div_const(torch.log(gh / ah), var[3])
    loc_t = torch.stack([tx, ty, tw, th], dim=-1)
    m = matched[..., None]
    loc_t = torch.where(m, loc_t, torch.zeros_like(loc_t)).reshape(N, A * 4)
    loc_mask = m.expand(N, A, 4).to(loc_t.dtype).reshape(N, A * 4)
    return loc_t, loc_mask, cls


@register('_contrib_MultiBoxDetection',
          input_names=['cls_prob', 'loc_pred', 'anchor'],
          param_defaults={'clip': True, 'threshold': 0.01, 'background_id': 0,
                          'nms_threshold': 0.5, 'force_suppress': False,
                          'variances': (0.1, 0.1, 0.2, 0.2), 'nms_topk': -1},
          differentiable=False)
def _multibox_detection(attrs, cls_prob, loc_pred, anchor):
    """cls_prob (N, C, A) with the background in row 0, loc_pred (N, A*4),
    anchor (1, A, 4) -> (N, A, 6) of (class id or -1, score, box), ranked
    by score."""
    var = attrs.get('variances', (0.1, 0.1, 0.2, 0.2))
    anchors = anchor.reshape(-1, 4)
    A = anchors.shape[0]
    N = cls_prob.shape[0]
    if _is_meta(cls_prob, loc_pred, anchor):
        return cls_prob.new_empty((N, A, 6))
    nms_thresh = attrs.get('nms_threshold', 0.5)
    score_thresh = attrs.get('threshold', 0.01)
    force = attrs.get('force_suppress', False)

    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    l = loc_pred.reshape(N, A, 4)
    cx = l[..., 0] * var[0] * aw + acx
    cy = l[..., 1] * var[1] * ah + acy
    w = torch.exp(l[..., 2] * var[2]) * aw
    h = torch.exp(l[..., 3] * var[3]) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    if attrs.get('clip', True):
        boxes = torch.clamp(boxes, 0, 1)
    scores = cls_prob[:, 1:]                          # (N, C-1, A)
    cls_id = scores.argmax(dim=1).to(torch.float32)
    score = scores.amax(dim=1)
    keep = score > score_thresh
    order = torch.argsort(-score, dim=1, stable=True)
    boxes_s = boxes.gather(1, order[..., None].expand(N, A, 4))
    cls_s = cls_id.gather(1, order)
    score_s = score.gather(1, order)
    keep_s = keep.gather(1, order)
    suppressed = torch.zeros((N, A), dtype=torch.bool, device=boxes.device)
    rank = torch.arange(A, device=boxes.device)
    step = _chunk(N * A, 1 << 25)
    for s in range(0, A, step):
        e = min(A, s + step)
        over = _box_iou(boxes_s[:, s:e], boxes_s[:, :e]) > nms_thresh
        if not force:
            over &= cls_s[:, s:e, None] == cls_s[:, None, :e]
        over &= rank[s:e, None] > rank[None, :e]
        over &= keep_s[:, None, :e]
        suppressed[:, s:e] = over.any(dim=2)
    valid = keep_s & ~suppressed
    out_id = torch.where(valid, cls_s, torch.full_like(cls_s, -1.0))
    dt = torch.promote_types(torch.float32, score_s.dtype)
    return torch.cat([out_id[..., None].to(dt), score_s[..., None].to(dt),
                      boxes_s.to(dt)], dim=-1)


@register('_contrib_box_iou', input_names=['lhs', 'rhs'],
          param_defaults={'format': 'corner'}, differentiable=False)
def _box_iou_op(attrs, lhs, rhs):
    return _box_iou(lhs.reshape(-1, 4), rhs.reshape(-1, 4))


# ---------------------------------------------------------------------------
# DeformableConvolution
# ---------------------------------------------------------------------------

def _bilinear_at(img, y, x):
    """img (N, G, c, H, W); y, x (N, G, ...) -> (N, G, c, ...): bilinear
    samples, a corner outside the image reading 0."""
    N, G, c, H, W = img.shape
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    wy = y - y0
    wx = x - x0
    flat = img.reshape(N, G, c, H * W)
    tail = tuple(y.shape[2:])

    def g(yy, xx):
        yi = torch.clamp(yy, 0, H - 1).to(torch.int64)
        xi = torch.clamp(xx, 0, W - 1).to(torch.int64)
        ok = (yy >= 0) & (yy <= H - 1) & (xx >= 0) & (xx <= W - 1)
        idx = (yi * W + xi).reshape(N, G, 1, -1).expand(N, G, c, -1)
        v = flat.gather(3, idx).reshape((N, G, c) + tail)
        return torch.where(ok[:, :, None], v, torch.zeros_like(v))

    return (g(y0, x0) * ((1 - wy) * (1 - wx))[:, :, None] +
            g(y0, x0 + 1) * ((1 - wy) * wx)[:, :, None] +
            g(y0 + 1, x0) * (wy * (1 - wx))[:, :, None] +
            g(y0 + 1, x0 + 1) * (wy * wx)[:, :, None])


@register('_contrib_DeformableConvolution',
          input_names=['data', 'offset', 'weight', 'bias'],
          param_defaults={'kernel': (1, 1), 'stride': (1, 1), 'dilate': (1, 1),
                          'pad': (0, 0), 'num_filter': 1, 'num_group': 1,
                          'num_deformable_group': 1, 'workspace': 1024,
                          'no_bias': False, 'layout': None})
def _deformable_convolution(attrs, data, offset, weight, bias=None):
    """A convolution whose taps sample the input bilinearly at the
    kernel grid moved by ``offset`` (N, DG*2*K, OH, OW), laid out [group]
    [tap][(y, x)]: the sampled columns, then one grouped product."""
    kh, kw = attrs['kernel']
    sh, sw = attrs.get('stride', (1, 1))
    dh, dw = attrs.get('dilate', (1, 1))
    ph, pw = attrs.get('pad', (0, 0))
    G = int(attrs.get('num_group', 1))
    DG = int(attrs.get('num_deformable_group', 1))
    N, C, H, W = data.shape
    F = int(attrs['num_filter'])
    OH = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    OW = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    K = kh * kw
    dev = data.device

    oy = torch.arange(OH, device=dev) * sh - ph
    ox = torch.arange(OW, device=dev) * sw - pw
    ky, kx = torch.meshgrid(torch.arange(kh, device=dev) * dh,
                            torch.arange(kw, device=dev) * dw, indexing='ij')
    base_y = (oy[None, :, None] + ky.reshape(-1)[:, None, None]).expand(
        K, OH, OW).to(data.dtype)
    base_x = (ox[None, None, :] + kx.reshape(-1)[:, None, None]).expand(
        K, OH, OW).to(data.dtype)
    off = offset.reshape(N, DG, K, 2, OH, OW)
    y = base_y + off[:, :, :, 0]
    x = base_x + off[:, :, :, 1]
    cols = _bilinear_at(data.reshape(N, DG, C // DG, H, W), y, x)
    cols = cols.reshape(N, G, C // G, K, OH, OW)
    wg = weight.reshape(G, F // G, C // G, K)
    out = torch.einsum('ngckhw,gfck->ngfhw', cols, wg)
    out = out.reshape(N, F, OH, OW).to(data.dtype)
    if bias is not None and not attrs.get('no_bias', False):
        out = out + bias[None, :, None, None]
    return out


# ---------------------------------------------------------------------------
# PSROIPooling and DeformablePSROIPooling (R-FCN)
# ---------------------------------------------------------------------------

def _ps_channels(out_dim, gs, ps, device):
    """The input channel each output (o, i, j) reads: (o * gs + gy) * gs +
    gx, with (gy, gx) the bin scaled to the group grid."""
    iy, ix = torch.meshgrid(torch.arange(ps, device=device),
                            torch.arange(ps, device=device), indexing='ij')
    gy = torch.div(iy * gs, ps, rounding_mode='floor')
    gx = torch.div(ix * gs, ps, rounding_mode='floor')
    o = torch.arange(out_dim, device=device)[:, None, None]
    return (o * gs + gy) * gs + gx, iy, ix


@register('_contrib_DeformablePSROIPooling',
          input_names=['data', 'rois', 'trans'],
          param_defaults={'spatial_scale': 1.0, 'output_dim': 1,
                          'group_size': 1, 'pooled_size': 1, 'part_size': 0,
                          'sample_per_part': 1, 'trans_std': 0.0,
                          'no_trans': False})
def _deformable_psroi_pooling(attrs, data, rois, trans=None):
    """(R, output_dim, ps, ps): each bin the mean of its sample_per_part^2
    bilinear samples that fall inside the map (moved by ``trans`` (R, 2,
    part, part) x trans_std x the roi's size), on its position-sensitive
    channel."""
    scale = float(attrs['spatial_scale'])
    out_dim = int(attrs['output_dim'])
    gs = int(attrs['group_size'])
    ps = int(attrs['pooled_size'])
    part = int(attrs.get('part_size', 0)) or ps
    spp = int(attrs.get('sample_per_part', 1))
    tstd = float(attrs.get('trans_std', 0.0))
    no_trans = attrs.get('no_trans', False) or trans is None
    N, C, H, W = data.shape
    R = rois.shape[0]
    dev = data.device

    chan, iy, ix = _ps_channels(out_dim, gs, ps, dev)
    sy, sx = torch.meshgrid(torch.arange(spp, device=dev),
                            torch.arange(spp, device=dev), indexing='ij')
    b = rois[:, 0].to(torch.int64).clamp(0, N - 1)
    x1 = torch.round(rois[:, 1]) * scale - 0.5
    y1 = torch.round(rois[:, 2]) * scale - 0.5
    x2 = (torch.round(rois[:, 3]) + 1.0) * scale - 0.5
    y2 = (torch.round(rois[:, 4]) + 1.0) * scale - 0.5
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    bin_w = _div_const(rw, ps)
    bin_h = _div_const(rh, ps)
    sub_w = _div_const(bin_w, spp)
    sub_h = _div_const(bin_h, spp)
    if no_trans:
        off_y = torch.zeros((R, ps, ps), dtype=data.dtype, device=dev)
        off_x = off_y
    else:
        py = torch.div(iy * part, ps, rounding_mode='floor')
        px = torch.div(ix * part, ps, rounding_mode='floor')
        off_y = trans[:, 0, py, px] * tstd * rh[:, None, None]
        off_x = trans[:, 1, py, px] * tstd * rw[:, None, None]

    def col(v):
        return v[:, None, None, None, None]

    # sample coordinates (R, ps, ps, spp, spp)
    yy = (col(y1) + iy[None, :, :, None, None] * col(bin_h)
          + off_y[..., None, None] + (sy + 0.5) * col(sub_h))
    xx = (col(x1) + ix[None, :, :, None, None] * col(bin_w)
          + off_x[..., None, None] + (sx + 0.5) * col(sub_w))
    valid = (yy > -0.5) & (yy < H - 0.5) & (xx > -0.5) & (xx < W - 0.5)
    yc = torch.clamp(yy, 0.0, H - 1.0)
    xc = torch.clamp(xx, 0.0, W - 1.0)
    # each output's channel plane, as an offset into the flat data
    plane = ((b[:, None, None, None] * C + chan[None]) * (H * W)
             )[..., None, None]                  # (R, out_dim, ps, ps, 1, 1)
    flat = data.reshape(-1)
    y0 = torch.floor(yc)
    x0 = torch.floor(xc)
    wy = (yc - y0)[:, None]
    wx = (xc - x0)[:, None]

    def g(yq, xq):
        yi = torch.clamp(yq, 0, H - 1).to(torch.int64)
        xi = torch.clamp(xq, 0, W - 1).to(torch.int64)
        ok = ((yq >= 0) & (yq <= H - 1) & (xq >= 0) & (xq <= W - 1))[:, None]
        v = flat[plane + (yi * W + xi)[:, None]]
        return torch.where(ok, v, torch.zeros_like(v))

    sampled = (g(y0, x0) * ((1 - wy) * (1 - wx)) +
               g(y0, x0 + 1) * ((1 - wy) * wx) +
               g(y0 + 1, x0) * (wy * (1 - wx)) +
               g(y0 + 1, x0 + 1) * (wy * wx))
    count = torch.clamp(valid.sum(dim=(-2, -1)), min=1)
    return (sampled * valid[:, None]).sum(dim=(-2, -1)) / count[:, None]


@register('_contrib_PSROIPooling', input_names=['data', 'rois'],
          param_defaults={'spatial_scale': 1.0, 'output_dim': 1,
                          'pooled_size': 1, 'group_size': 0})
def _psroi_pooling(attrs, data, rois):
    """(R, output_dim, ps, ps): each bin the mean of the pixels inside it
    (floor and ceil bin bounds) on its position-sensitive channel."""
    scale = float(attrs['spatial_scale'])
    out_dim = int(attrs['output_dim'])
    ps = int(attrs['pooled_size'])
    gs = int(attrs.get('group_size', 0)) or ps
    N, C, H, W = data.shape
    R = rois.shape[0]
    dev = data.device
    if _is_meta(data, rois):
        return data.new_empty((R, out_dim, ps, ps))

    chan, _, _ = _ps_channels(out_dim, gs, ps, dev)
    b = rois[:, 0].to(torch.int64).clamp(0, N - 1)
    x1 = torch.round(rois[:, 1]) * scale
    y1 = torch.round(rois[:, 2]) * scale
    x2 = (torch.round(rois[:, 3]) + 1.0) * scale
    y2 = (torch.round(rois[:, 4]) + 1.0) * scale
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    bin_w = _div_const(rw, ps)
    bin_h = _div_const(rh, ps)
    p = torch.arange(ps, device=dev)
    y_lo = torch.floor(y1[:, None] + p * bin_h[:, None])[..., None]
    y_hi = torch.ceil(y1[:, None] + (p + 1) * bin_h[:, None])[..., None]
    x_lo = torch.floor(x1[:, None] + p * bin_w[:, None])[..., None]
    x_hi = torch.ceil(x1[:, None] + (p + 1) * bin_w[:, None])[..., None]
    ys = torch.arange(H, dtype=data.dtype, device=dev)
    xs = torch.arange(W, dtype=data.dtype, device=dev)
    ymask = (ys >= torch.clamp(y_lo, min=0)) & (ys < torch.clamp(y_hi, max=H))
    xmask = (xs >= torch.clamp(x_lo, min=0)) & (xs < torch.clamp(x_hi, max=W))
    count = torch.clamp(ymask.sum(-1)[:, :, None] * xmask.sum(-1)[:, None, :],
                        min=1)                          # (R, ps, ps)
    ym = ymask.to(data.dtype)
    xm = xmask.to(data.dtype)
    sel = chan.reshape(1, -1, ps * ps)
    outs = []
    step = _chunk(C * H * W)
    for s in range(0, R, step):
        e = min(R, s + step)
        # a bin's sum: its column mask, then its row mask
        cols_ = torch.matmul(data[b[s:e]], xm[s:e, None].transpose(2, 3))
        sums = torch.matmul(ym[s:e, None], cols_)     # (r, C, ps, ps)
        picked = sums.reshape(e - s, C, ps * ps).gather(
            1, sel.expand(e - s, -1, -1))
        outs.append(picked.reshape(e - s, out_dim, ps, ps))
    return torch.cat(outs) / count[:, None]


# ---------------------------------------------------------------------------
# MultiProposal / Proposal (the RPN's proposals)
# ---------------------------------------------------------------------------

def _gen_anchors(feature_stride, scales, ratios, device):
    """Base anchors centred on a feature_stride cell (A, 4), f32."""
    f32 = torch.float32
    base = torch.tensor([0, 0, feature_stride - 1, feature_stride - 1],
                        dtype=f32, device=device)
    w = base[2] - base[0] + 1
    h = base[3] - base[1] + 1
    cx = base[0] + (w - 1) / 2
    cy = base[1] + (h - 1) / 2
    anchors = []
    for r in ratios:
        size = w * h
        ws = torch.round(torch.sqrt(size / r))
        hs = torch.round(ws * r)
        for s in scales:
            wss = ws * s
            hss = hs * s
            anchors.append(torch.stack([cx - (wss - 1) / 2, cy - (hss - 1) / 2,
                                        cx + (wss - 1) / 2,
                                        cy + (hss - 1) / 2]))
    return torch.stack(anchors)


def _greedy_keep(boxes, cand, thresh, block=256):
    """The greedy sweep over ranked boxes (N, P, 4): kept[i] = cand[i] and
    no kept j < i overlaps i above ``thresh``. A block of ranks at a time:
    the kept boxes of earlier blocks in one step, then the block's own
    equations iterated to their fixed point (unique: rank i depends only
    on ranks before it)."""
    N, P = cand.shape
    kept = torch.zeros_like(cand)
    rank = torch.arange(P, device=cand.device)
    for s in range(0, P, block):
        e = min(P, s + block)
        over = _box_iou(boxes[:, s:e], boxes[:, :e]) > thresh   # (N, b, e)
        c = cand[:, s:e]
        if s:
            c = c & ~(over[:, :, :s] & kept[:, None, :s]).any(dim=2)
        inner = over[:, :, s:e] & (rank[s:e, None] > rank[None, s:e])
        k = c
        while True:
            nxt = c & ~(inner & k[:, None, :]).any(dim=2)
            if torch.equal(nxt, k):
                break
            k = nxt
        kept[:, s:e] = k
    return kept


@register('_contrib_MultiProposal',
          input_names=['cls_prob', 'bbox_pred', 'im_info'],
          param_defaults={'rpn_pre_nms_top_n': 6000, 'rpn_post_nms_top_n': 300,
                          'threshold': 0.7, 'rpn_min_size': 16,
                          'scales': (4.0, 8.0, 16.0, 32.0),
                          'ratios': (0.5, 1.0, 2.0), 'feature_stride': 16,
                          'output_score': False, 'iou_loss': False},
          num_outputs=lambda attrs: 2 if attrs.get('output_score') else 1,
          differentiable=False)
def _multi_proposal(attrs, cls_prob, bbox_pred, im_info):
    """cls_prob (N, 2A, H, W) (background then foreground maps), bbox_pred
    (N, 4A, H, W), im_info (N, 3) of (height, width, scale) -> rois
    (N * post_n, 5) of (image, box), and with ``output_score`` the scores
    (N * post_n, 1): anchors decoded, clipped, too small ones scored -1,
    the top pre_n by score swept greedily, the first post_n kept in rank
    order, the rest zero."""
    stride = int(attrs.get('feature_stride', 16))
    scales = tuple(attrs.get('scales', (4.0, 8.0, 16.0, 32.0)))
    ratios = tuple(attrs.get('ratios', (0.5, 1.0, 2.0)))
    pre_n = int(attrs.get('rpn_pre_nms_top_n', 6000))
    post_n = int(attrs.get('rpn_post_nms_top_n', 300))
    nms_thresh = float(attrs.get('threshold', 0.7))
    min_size = float(attrs.get('rpn_min_size', 16))

    N, _, FH, FW = cls_prob.shape
    A = len(scales) * len(ratios)
    K = FH * FW * A
    pre_n = min(pre_n, K)
    post_n = min(post_n, pre_n)
    if _is_meta(cls_prob, bbox_pred, im_info):
        rois = cls_prob.new_empty((N * post_n, 5))
        if attrs.get('output_score', False):
            return rois, cls_prob.new_empty((N * post_n, 1))
        return rois
    dev = cls_prob.device
    base = _gen_anchors(stride, scales, ratios, dev)
    shift_x = torch.arange(FW, device=dev) * stride
    shift_y = torch.arange(FH, device=dev) * stride
    sy, sx = torch.meshgrid(shift_y, shift_x, indexing='ij')
    shifts = torch.stack([sx, sy, sx, sy], dim=-1).reshape(-1, 4)
    anchors = (base[None] + shifts[:, None]).reshape(-1, 4)

    # scores of the foreground maps and deltas, both in (H, W, A) order
    fg = cls_prob[:, A:].reshape(N, A, FH, FW).permute(0, 2, 3, 1).reshape(
        N, -1)
    d = bbox_pred.reshape(N, A, 4, FH, FW).permute(0, 3, 4, 1, 2).reshape(
        N, -1, 4)
    ih, iw, im_scale = (im_info[:, k, None] for k in range(3))
    aw = anchors[:, 2] - anchors[:, 0] + 1
    ah = anchors[:, 3] - anchors[:, 1] + 1
    acx = anchors[:, 0] + aw * 0.5
    acy = anchors[:, 1] + ah * 0.5
    cx = d[..., 0] * aw + acx
    cy = d[..., 1] * ah + acy
    w = torch.exp(torch.clamp(d[..., 2], -10, 10)) * aw
    h = torch.exp(torch.clamp(d[..., 3], -10, 10)) * ah
    zero = torch.zeros((), dtype=cx.dtype, device=dev)
    x1 = torch.minimum(torch.maximum(cx - w * 0.5, zero), iw - 1)
    y1 = torch.minimum(torch.maximum(cy - h * 0.5, zero), ih - 1)
    x2 = torch.minimum(torch.maximum(cx + w * 0.5, zero), iw - 1)
    y2 = torch.minimum(torch.maximum(cy + h * 0.5, zero), ih - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    keep = ((x2 - x1 + 1 >= min_size * im_scale) &
            (y2 - y1 + 1 >= min_size * im_scale))
    score = torch.where(keep, fg, torch.full_like(fg, -1.0))
    order = torch.argsort(-score, dim=1, stable=True)[:, :pre_n]
    b = boxes.gather(1, order[..., None].expand(N, pre_n, 4))
    s = score.gather(1, order)
    kept = _greedy_keep(b, s > -1.0, nms_thresh)
    # the kept boxes (in rank order) into the first post_n slots; the
    # unfilled tail stays zero
    rank = torch.cumsum(kept.to(torch.int64), dim=1) - 1
    sel = kept & (rank < post_n)
    idx = torch.clamp(rank, 0, post_n - 1)
    out_boxes = torch.zeros((N, post_n, 4), dtype=b.dtype, device=dev)
    out_boxes.scatter_add_(1, idx[..., None].expand(N, pre_n, 4),
                           torch.where(sel[..., None], b, torch.zeros_like(b)))
    out_scores = torch.zeros((N, post_n), dtype=s.dtype, device=dev)
    out_scores.scatter_add_(1, idx, torch.where(sel, s, torch.zeros_like(s)))
    batch_idx = torch.arange(N, dtype=b.dtype, device=dev).repeat_interleave(
        post_n)
    rois = torch.cat([batch_idx[:, None], out_boxes.reshape(N * post_n, 4)],
                     dim=1)
    if attrs.get('output_score', False):
        return rois, out_scores.reshape(N * post_n, 1)
    return rois


@register('_contrib_Proposal',
          input_names=['cls_prob', 'bbox_pred', 'im_info'],
          param_defaults={'rpn_pre_nms_top_n': 6000, 'rpn_post_nms_top_n': 300,
                          'threshold': 0.7, 'rpn_min_size': 16,
                          'scales': (4.0, 8.0, 16.0, 32.0),
                          'ratios': (0.5, 1.0, 2.0), 'feature_stride': 16,
                          'output_score': False, 'iou_loss': False},
          num_outputs=lambda attrs: 2 if attrs.get('output_score') else 1,
          differentiable=False)
def _proposal(attrs, cls_prob, bbox_pred, im_info):
    """The single-image form of MultiProposal (the same function)."""
    return _multi_proposal(attrs, cls_prob, bbox_pred, im_info)


# ---------------------------------------------------------------------------
# quantize
# ---------------------------------------------------------------------------

@register('_contrib_quantize', input_names=['data', 'min_range', 'max_range'],
          param_defaults={'out_type': 'uint8'}, num_outputs=3,
          differentiable=False)
def _quantize(attrs, data, min_range, max_range):
    """f32 -> uint8 (``floor(x + 0.5)``) or int8 (half to even, shifted by
    128) codes over [min_range, max_range], with the range passed on."""
    scale = 255.0 / (max_range - min_range)
    if attrs.get('out_type', 'uint8') == 'int8':
        q = torch.clamp(torch.round((data - min_range) * scale) - 128.0,
                        -128.0, 127.0)
        return q.to(torch.int8), min_range, max_range
    q = torch.clamp(torch.floor((data - min_range) * scale + 0.5), 0.0, 255.0)
    return q.to(torch.uint8), min_range, max_range


# ---------------------------------------------------------------------------
# IdentityAttachKLSparseReg
# ---------------------------------------------------------------------------

class _KLSparseRegFunction(torch.autograd.Function):
    """The identity, whose gradient adds the KL sparseness penalty's
    derivative against the moving average of each unit's activation."""

    @staticmethod
    def forward(ctx, data, moving, target, penalty):
        ctx.save_for_backward(moving)
        ctx.target, ctx.penalty = target, penalty
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        moving, = ctx.saved_tensors
        t = ctx.target
        reg = ctx.penalty * (-t / moving + (1 - t) / (1 - moving))
        gflat = g.reshape(g.shape[0], -1) + reg[None, :]
        return gflat.reshape(g.shape).to(g.dtype), None, None, None


@register('IdentityAttachKLSparseReg',
          input_names=['data', 'moving_avg'],
          param_defaults={'sparseness_target': 0.1, 'penalty': 0.001,
                          'momentum': 0.9},
          aux_inputs=('moving_avg',), mutate_inputs={1: 1},
          num_visible_outputs=1, num_outputs=2, train_aware=True)
def _identity_attach_kl_sparse_reg(attrs, data, moving_avg):
    """(data, the moving average): in training the average moves toward
    the batch's mean activation of each unit first."""
    t = float(attrs.get('sparseness_target', 0.1))
    penalty = float(attrs.get('penalty', 0.001))
    momentum = float(attrs.get('momentum', 0.9))
    if attrs.get('__is_train__', False):
        avg = data.reshape(data.shape[0], -1).mean(dim=0)
        new_moving = momentum * moving_avg + (1 - momentum) * avg
    else:
        new_moving = moving_avg
    out = _KLSparseRegFunction.apply(data, new_moving.detach(), t, penalty)
    return out, new_moving
