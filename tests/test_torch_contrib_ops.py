"""The port's contrib detection, vision and signal ops
(mxnet_tpu_torch.ops.contrib_ops) against the JAX package's, on the CPU.

Every op of ``mxnet_tpu/ops/contrib_ops.py`` but the CTC loss (which
``test_torch_ctc.py`` holds): its registration (inputs, defaults, outputs,
``differentiable``, ``aux_inputs``, ``mutate_inputs``, ``train_aware``),
its forward on seeded numpy inputs, and for the differentiable ones the
gradients of every float input for one cotangent against ``jax.vjp``
(the JAX side jitted). The cases include the behaviours the port copies
(ROADMAP.md §3): ROIPooling's gradient split among tied maxima,
Correlation's wrap-around that ignores ``kernel_size``, ``stride1`` and
``pad_size``, MultiBoxDetection's one-pass suppression and stable ranking
of equal scores, MultiBoxTarget's forced match decided by the last ground
truth, MultiProposal's greedy sweep and zero tail, quantize's two
roundings at exact halves, and ifft's scale by n.

Tolerances (|port - jax| <= atol + rtol * |jax|): exact for class ids,
indices and int8/uint8 codes; f32 values rtol 1e-5, atol 1e-5 x the
case's largest |jax| value; f32 gradients rtol 1e-4, atol 1e-4 x the
largest |jax| gradient (sums in another order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import registry as treg

CONTRIB = ['ROIPooling', 'BilinearSampler', 'GridGenerator',
           'SpatialTransformer', 'Correlation', '_contrib_fft',
           '_contrib_ifft', '_contrib_count_sketch', '_contrib_dequantize',
           '_contrib_MultiBoxPrior', '_contrib_MultiBoxTarget',
           '_contrib_MultiBoxDetection', '_contrib_box_iou',
           '_contrib_DeformableConvolution',
           '_contrib_DeformablePSROIPooling', '_contrib_MultiProposal',
           '_contrib_Proposal', '_contrib_quantize', '_contrib_PSROIPooling',
           'IdentityAttachKLSparseReg']


def _close(got, want, rtol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in 'iub':
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(scale,
                                                                        1e-30),
                               err_msg=what)


def _outs(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def run(name, attrs, inputs, grad_of=(), seed=0, rtol=1e-5, grtol=1e-4):
    """The op on both sides: outputs held, and the gradients of inputs
    ``grad_of`` for one seeded cotangent of the first output (the JAX
    outputs and vjp in one jitted program)."""
    jfn = jreg.get(name).fn
    tfn = treg.get(name).fn
    jin = [jnp.asarray(a) for a in inputs]

    def first(*diff):
        full = list(jin)
        for i, d in zip(grad_of, diff):
            full[i] = d
        return _outs(jfn(attrs, *full))[0]

    shape = jax.eval_shape(lambda *a: _outs(jfn(attrs, *a))[0], *jin).shape
    cot = np.random.RandomState(seed + 7).randn(*shape).astype(np.float32)

    def both(*a):
        outs = _outs(jfn(attrs, *a))
        if not grad_of:
            return outs, []
        _, vjp = jax.vjp(first, *[a[i] for i in grad_of])
        return outs, list(vjp(jnp.asarray(cot)))

    jout, jgrads = jax.jit(both)(*jin)
    targs = [torch.from_numpy(np.array(a)) for a in inputs]
    for i in grad_of:
        targs[i].requires_grad_(True)
    tout = _outs(tfn(attrs, *targs))
    for k, (t, j) in enumerate(zip(tout, jout)):
        _close(t.detach().numpy(), np.asarray(j), rtol, '%s out %d' % (name, k))
    if grad_of:
        tgrads = torch.autograd.grad(tout[0], [targs[i] for i in grad_of],
                                     torch.from_numpy(cot), allow_unused=True)
        for i, t, j in zip(grad_of, tgrads, jgrads):
            t = np.zeros_like(np.asarray(j)) if t is None else t.numpy()
            _close(t, np.asarray(j), grtol, '%s grad of input %d' % (name, i))
    return [t.detach().numpy() for t in tout]


def test_every_contrib_op_registered_as_in_jax():
    for name in CONTRIB:
        j, t = jreg.get(name), treg.get(name)
        assert t.input_names == j.input_names, name
        assert t.param_defaults == j.param_defaults, name
        assert t.differentiable == j.differentiable, name
        assert t.aux_inputs == j.aux_inputs, name
        assert t.mutate_inputs == j.mutate_inputs, name
        assert t.train_aware == j.train_aware, name
        for attrs in ({}, {'output_score': True}):
            assert t.n_outputs(attrs) == j.n_outputs(attrs), name
            assert t.n_visible_outputs(attrs) == j.n_visible_outputs(attrs)


def test_contrib_namespaces_list_the_same_names():
    from mxnet_tpu_torch.ndarray import contrib as tnc
    from mxnet_tpu_torch.symbol import contrib as tsc
    want = {n for n in dir(mx.nd.contrib) if not n.startswith('_')}
    assert want <= set(dir(tnc))
    assert {n for n in dir(mx.sym.contrib) if not n.startswith('_')} <= \
        set(dir(tsc))
    for short in ('MultiBoxPrior', 'MultiBoxTarget', 'MultiBoxDetection',
                  'MultiProposal', 'Proposal', 'PSROIPooling',
                  'DeformableConvolution', 'DeformablePSROIPooling', 'fft',
                  'ifft', 'quantize', 'dequantize', 'count_sketch',
                  'box_iou'):
        assert callable(getattr(tnc, short)), short
        assert callable(getattr(tsc, short)), short


# ---------------------------------------------------------------------------
# ROIPooling, PSROIPooling, DeformablePSROIPooling
# ---------------------------------------------------------------------------

ROIS = np.array([[0, 1, 1, 6, 5], [1, 0, 0, 15, 13], [1, 3.7, 2.2, 4.1, 2.6],
                 [0, -4, -3, 20, 30], [1, 9, 2, 12, 11]], np.float32)


@pytest.mark.parametrize('pooled,scale', [((2, 2), 0.5), ((3, 2), 1.0)])
def test_roi_pooling_with_ties(pooled, scale):
    # integers from a small range: most bins hold tied maxima, whose
    # gradient the max splits evenly
    rng = np.random.RandomState(0)
    data = rng.randint(0, 4, (2, 3, 8, 9)).astype(np.float32)
    run('ROIPooling', {'pooled_size': pooled, 'spatial_scale': scale},
        [data, ROIS], grad_of=(0,))


def test_psroi_pooling():
    rng = np.random.RandomState(1)
    out_dim, ps = 2, 3
    data = rng.randn(2, out_dim * ps * ps, 10, 11).astype(np.float32)
    run('_contrib_PSROIPooling', {'spatial_scale': 0.5, 'output_dim': out_dim,
                                  'pooled_size': ps},
        [data, ROIS], grad_of=(0,))


@pytest.mark.parametrize('no_trans', [False, True])
def test_deformable_psroi_pooling(no_trans):
    rng = np.random.RandomState(2)
    out_dim, gs, ps = 2, 2, 3
    data = rng.randn(2, out_dim * gs * gs, 10, 11).astype(np.float32)
    trans = rng.randn(len(ROIS), 2, 2, 2).astype(np.float32)
    attrs = {'spatial_scale': 0.5, 'output_dim': out_dim, 'group_size': gs,
             'pooled_size': ps, 'part_size': 2, 'sample_per_part': 2,
             'trans_std': 0.1, 'no_trans': no_trans}
    run('_contrib_DeformablePSROIPooling', attrs, [data, ROIS, trans],
        grad_of=(0,) if no_trans else (0, 2))


# ---------------------------------------------------------------------------
# the samplers
# ---------------------------------------------------------------------------

def test_bilinear_sampler():
    rng = np.random.RandomState(3)
    data = rng.randn(2, 3, 5, 6).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 2, 4, 7)).astype(np.float32)
    run('BilinearSampler', {}, [data, grid], grad_of=(0, 1))


@pytest.mark.parametrize('kind', ['affine', 'warp'])
def test_grid_generator(kind):
    rng = np.random.RandomState(4)
    if kind == 'affine':
        data = rng.randn(3, 6).astype(np.float32)
        attrs = {'transform_type': 'affine', 'target_shape': (4, 5)}
    else:
        data = rng.randn(2, 2, 4, 5).astype(np.float32)
        attrs = {'transform_type': 'warp', 'target_shape': (4, 5)}
    run('GridGenerator', attrs, [data], grad_of=(0,))


def test_spatial_transformer():
    rng = np.random.RandomState(5)
    data = rng.randn(2, 3, 6, 7).astype(np.float32)
    loc = (np.tile([[1, 0, 0, 0, 1, 0]], (2, 1)) +
           0.2 * rng.randn(2, 6)).astype(np.float32)
    run('SpatialTransformer', {'target_shape': (5, 4)}, [data, loc],
        grad_of=(0, 1))


@pytest.mark.parametrize('mult,d,s2', [(True, 2, 1), (False, 2, 2),
                                       (True, 3, 2)])
def test_correlation_wraps_around(mult, d, s2):
    # kernel_size, stride1 and pad_size are read by neither package
    rng = np.random.RandomState(6)
    a = rng.randn(2, 4, 6, 7).astype(np.float32)
    b = rng.randn(2, 4, 6, 7).astype(np.float32)
    attrs = {'max_displacement': d, 'stride2': s2, 'is_multiply': mult,
             'kernel_size': 3, 'stride1': 2, 'pad_size': 4}
    out = run('Correlation', attrs, [a, b], grad_of=(0, 1))[0]
    # the first shift (-d, -d) reads b rolled around the borders
    want = (a * np.roll(b, (-d, -d), axis=(2, 3))).mean(1) if mult else \
        np.abs(a - np.roll(b, (-d, -d), axis=(2, 3))).mean(1)
    np.testing.assert_allclose(out[:, 0], want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# fft, ifft, count_sketch, quantize, dequantize
# ---------------------------------------------------------------------------

def test_fft_and_ifft():
    rng = np.random.RandomState(7)
    x = rng.randn(3, 8).astype(np.float32)
    y = run('_contrib_fft', {}, [x], grad_of=(0,))[0]
    z = run('_contrib_ifft', {}, [y], grad_of=(0,))[0]
    # ifft scales by n: ifft(fft(x)) is n * x
    np.testing.assert_allclose(z, 8 * x, rtol=1e-5, atol=1e-5)


def test_count_sketch():
    rng = np.random.RandomState(8)
    data = rng.randn(4, 10).astype(np.float32)
    h = rng.randint(0, 6, (1, 10)).astype(np.float32)
    s = rng.choice([-1.0, 1.0], (1, 10)).astype(np.float32)
    run('_contrib_count_sketch', {'out_dim': 6}, [data, h, s],
        grad_of=(0, 2))


@pytest.mark.parametrize('out_type', ['uint8', 'int8'])
def test_quantize_roundings_and_dequantize(out_type):
    # x - lo is 0.5 / scale x an integer: exact halves before rounding,
    # which uint8 takes up (floor(x + 0.5)) and int8 to even
    lo, hi = np.float32(-1.0), np.float32(1.55)
    scale = 255.0 / (hi - lo)
    halves = (np.arange(-4, 500, 7) * 0.5 / scale + lo).astype(np.float32)
    rng = np.random.RandomState(9)
    data = np.concatenate([halves, rng.uniform(-1.5, 2.0, 64)]).astype(
        np.float32)
    rmin, rmax = np.array([lo], np.float32), np.array([hi], np.float32)
    q, _, _ = run('_contrib_quantize', {'out_type': out_type},
                  [data, rmin, rmax])
    assert q.dtype == (np.uint8 if out_type == 'uint8' else np.int8)
    run('_contrib_dequantize', {}, [q, rmin, rmax])


# ---------------------------------------------------------------------------
# the MultiBox family and box_iou
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('attrs', [
    {'sizes': (0.2, 0.35), 'ratios': (1.0, 2.0, 0.5), 'clip': True},
    {'sizes': (0.5,), 'ratios': (1.0, 3.0), 'steps': (0.25, 0.2),
     'offsets': (0.3, 0.6)},
])
def test_multibox_prior(attrs):
    run('_contrib_MultiBoxPrior', attrs,
        [np.zeros((2, 3, 5, 4), np.float32)])


def test_box_iou():
    rng = np.random.RandomState(10)
    a = rng.uniform(0, 1, (6, 4)).astype(np.float32)
    b = rng.uniform(0, 1, (2, 3, 4)).astype(np.float32)
    a[:, 2:] += a[:, :2]
    b[..., 2:] += b[..., :2]
    a[0] = [0.5, 0.5, 0.2, 0.2]          # a reversed box: zero area
    run('_contrib_box_iou', {}, [a, b])


def _ssd_inputs(seed, n=3, classes=4, side=(4, 5)):
    rng = np.random.RandomState(seed)
    anchor = np.asarray(mx.nd.contrib.MultiBoxPrior(
        mx.nd.zeros((1, 1) + side), sizes=(0.3, 0.5),
        ratios=(1.0, 2.0)).asnumpy())
    A = anchor.shape[1]
    label = -np.ones((n, 4, 5), np.float32)
    for i in range(n):
        for j in range(rng.randint(1, 4)):
            x0, y0 = rng.uniform(0, 0.6, 2)
            w, h = rng.uniform(0.1, 0.4, 2)
            label[i, j] = [rng.randint(classes - 1), x0, y0, x0 + w, y0 + h]
    cls_prob = rng.dirichlet(np.ones(classes), (n, A)).transpose(0, 2, 1)
    loc = 0.5 * rng.randn(n, A * 4)
    return anchor, label, cls_prob.astype(np.float32), loc.astype(np.float32)


def test_multibox_target():
    anchor, label, cls_prob, _ = _ssd_inputs(11)
    loc_t, loc_m, cls_t = run('_contrib_MultiBoxTarget',
                              {'overlap_threshold': 0.5},
                              [anchor, label, cls_prob])
    assert (cls_t > 0).any() and loc_m.sum() > 0


def test_multibox_target_forced_match_decided_by_the_last_ground_truth():
    # ground truth 0 is valid and its best anchor is anchor 0; ground
    # truth 1 is padding, whose IoU row is all -1, so its argmax is anchor
    # 0 too: the later (invalid) write decides, and anchor 0 stays
    # unmatched in both packages
    anchor = np.array([[[0.0, 0.0, 0.3, 0.3], [0.5, 0.5, 0.9, 0.9]]],
                      np.float32)
    label = np.array([[[1, 0.0, 0.0, 0.2, 0.2], [-1, -1, -1, -1, -1]]],
                     np.float32)
    cls_prob = np.zeros((1, 3, 2), np.float32)
    _, _, cls_t = run('_contrib_MultiBoxTarget', {'overlap_threshold': 0.5},
                      [anchor, label, cls_prob])
    np.testing.assert_array_equal(cls_t, [[0, 0]])


@pytest.mark.parametrize('force', [False, True])
def test_multibox_detection(force):
    anchor, _, cls_prob, loc = _ssd_inputs(12)
    out = run('_contrib_MultiBoxDetection',
              {'nms_threshold': 0.3, 'threshold': 0.2,
               'force_suppress': force}, [cls_prob, loc, anchor])[0]
    assert (out[..., 0] >= 0).any() and (out[..., 0] < 0).any()


def test_multibox_detection_suppresses_in_one_pass_and_keeps_tie_order():
    # box 1 overlaps box 0 and is dropped; box 2 overlaps box 1 only, and
    # is dropped too, though box 1 was itself suppressed (a greedy NMS
    # would keep it). Boxes 3 and 4 share one score: they stay in index
    # order
    anchor = np.array([[[0.0, 0.0, 0.4, 0.4], [0.1, 0.0, 0.5, 0.4],
                        [0.22, 0.0, 0.62, 0.4], [0.7, 0.7, 0.8, 0.8],
                        [0.85, 0.85, 0.95, 0.95]]], np.float32)
    probs = np.array([[[0.1, 0.2, 0.3, 0.4, 0.4],
                       [0.9, 0.8, 0.7, 0.6, 0.6]]], np.float32)
    loc = np.zeros((1, 20), np.float32)
    out = run('_contrib_MultiBoxDetection', {'nms_threshold': 0.4},
              [probs, loc, anchor])[0]
    np.testing.assert_array_equal(out[0, :, 0], [0, -1, -1, 0, 0])
    np.testing.assert_allclose(out[0, 3:, 2], [0.7, 0.85], rtol=1e-6)


# ---------------------------------------------------------------------------
# DeformableConvolution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('group,dgroup,no_bias', [(1, 1, False), (2, 2, True)])
def test_deformable_convolution(group, dgroup, no_bias):
    rng = np.random.RandomState(13)
    C, F = 4, 6
    attrs = {'kernel': (3, 3), 'stride': (2, 1), 'dilate': (1, 2),
             'pad': (1, 2), 'num_filter': F, 'num_group': group,
             'num_deformable_group': dgroup, 'no_bias': no_bias}
    data = rng.randn(2, C, 7, 8).astype(np.float32)
    OH, OW = (7 + 2 - 3) // 2 + 1, (8 + 4 - 4 - 1) // 1 + 1
    offset = (1.5 * rng.randn(2, dgroup * 2 * 9, OH, OW)).astype(np.float32)
    weight = rng.randn(F, C // group, 3, 3).astype(np.float32)
    inputs = [data, offset, weight]
    if not no_bias:
        inputs.append(rng.randn(F).astype(np.float32))
    run('_contrib_DeformableConvolution', attrs, inputs,
        grad_of=tuple(range(len(inputs))))


# ---------------------------------------------------------------------------
# MultiProposal / Proposal
# ---------------------------------------------------------------------------

def _rpn_inputs(seed, n=2, fh=5, fw=6, A=6):
    rng = np.random.RandomState(seed)
    logits = rng.randn(n, 2, A, fh, fw)
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    # a tie among the foreground scores: the ranking keeps index order
    prob[:, 1, 0, 0, :3] = 0.75
    cls_prob = prob.reshape(n, 2 * A, fh, fw).astype(np.float32)
    bbox = (0.3 * rng.randn(n, 4 * A, fh, fw)).astype(np.float32)
    im_info = np.array([[fh * 8, fw * 8, 1.0]] * n, np.float32)
    return cls_prob, bbox, im_info


@pytest.mark.parametrize('name,score', [('_contrib_MultiProposal', True),
                                        ('_contrib_Proposal', False)])
def test_multi_proposal(name, score):
    attrs = {'rpn_pre_nms_top_n': 120, 'rpn_post_nms_top_n': 60,
             'threshold': 0.3, 'rpn_min_size': 4, 'scales': (1.0, 2.0),
             'ratios': (0.5, 1.0, 2.0), 'feature_stride': 8,
             'output_score': score}
    outs = run(name, attrs, list(_rpn_inputs(14)))
    rois = outs[0]
    assert rois.shape == (120, 5)
    # a greedy sweep at 0.3 keeps fewer than 60 boxes of an image: the
    # tail is zero
    tail = rois[:60][(rois[:60, 1:] == 0).all(1)]
    assert len(tail) > 0


def test_multi_proposal_sweeps_greedily():
    # boxes ranked 0, 1, 2: 1 overlaps 0 and is dropped, 2 overlaps only 1
    # and is kept (a one-pass suppression would drop it)
    attrs = {'rpn_pre_nms_top_n': 3, 'rpn_post_nms_top_n': 3,
             'threshold': 0.3, 'rpn_min_size': 1, 'scales': (1.0,),
             'ratios': (1.0,), 'feature_stride': 16, 'output_score': True}
    cls_prob = np.zeros((1, 2, 1, 3), np.float32)
    cls_prob[0, 1, 0] = [0.9, 0.8, 0.7]
    bbox = np.zeros((1, 4, 1, 3), np.float32)
    # widen each anchor (16 wide, 16 apart) to 30: neighbours overlap by
    # about 0.4 of their union, boxes two apart not at all
    bbox[0, 2] = np.log(30 / 16)
    im_info = np.array([[16, 64, 1.0]], np.float32)
    rois, scores = run('_contrib_MultiProposal', attrs,
                       [cls_prob, bbox, im_info])
    np.testing.assert_allclose(scores[:, 0], [0.9, 0.7, 0.0], rtol=1e-6)


# ---------------------------------------------------------------------------
# IdentityAttachKLSparseReg
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('train', [True, False])
def test_kl_sparse_reg(train):
    rng = np.random.RandomState(15)
    data = rng.uniform(0.05, 0.95, (5, 3, 2)).astype(np.float32)
    moving = rng.uniform(0.1, 0.9, 6).astype(np.float32)
    attrs = {'sparseness_target': 0.2, 'penalty': 0.01, 'momentum': 0.8,
             '__is_train__': train}
    # the custom backward adds the penalty's derivative at the (moved)
    # average
    run('IdentityAttachKLSparseReg', attrs, [data, moving], grad_of=(0,))


def test_kl_sparse_reg_moves_its_aux_state_through_nd():
    rng = np.random.RandomState(16)
    data = rng.uniform(0.05, 0.95, (4, 6)).astype(np.float32)
    moving = np.full(6, 0.5, np.float32)
    got = []
    for lib, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        x = lib.nd.array(data, ctx=ctx)
        m = lib.nd.array(moving, ctx=ctx)
        x.attach_grad()
        with lib.autograd.record():
            y = lib.nd.IdentityAttachKLSparseReg(x, m, momentum=0.5)
        y.backward(lib.nd.ones((4, 6), ctx=ctx))
        got.append((y.asnumpy(), m.asnumpy(), x.grad.asnumpy()))
    for t, j in zip(got[1], got[0]):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1][1], 0.5 * 0.5 + 0.5 * data.mean(0),
                               rtol=1e-6)


def test_contrib_ops_through_nd_contrib():
    anchor, label, cls_prob, loc = _ssd_inputs(17)
    outs = []
    for lib, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        a = lib.nd.array(anchor, ctx=ctx)
        det = lib.nd.contrib.MultiBoxDetection(
            lib.nd.array(cls_prob, ctx=ctx), lib.nd.array(loc, ctx=ctx), a)
        tgt = lib.nd.contrib.MultiBoxTarget(
            a, lib.nd.array(label, ctx=ctx), lib.nd.array(cls_prob, ctx=ctx))
        outs.append([det.asnumpy()] + [t.asnumpy() for t in tgt])
    for t, j in zip(outs[1], outs[0]):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
