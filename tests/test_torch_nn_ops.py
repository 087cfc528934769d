"""The ResNet op set of the port (mxnet_tpu_torch.ops.nn: FullyConnected,
Convolution, Deconvolution, Pooling, Activation, LeakyReLU, BatchNorm,
Dropout, SoftmaxOutput) against the JAX package's registry ops on the same
numpy inputs, values and gradients, on the CPU.

Each case runs the JAX op's function and its ``jax.vjp`` for a cotangent
drawn with the inputs; all cases run in one jitted program (one XLA
compile). The port runs the op's function and torch autograd for the same
cotangent. Cases cover FullyConnected with and without flatten and bias,
1-D/2-D/3-D convolutions with stride, padding, dilation and groups, the
transposed convolution, every pooling type and convention on odd sizes
(full, valid, global, padded, 1-D and 3-D), the activations, BatchNorm in
both statistics forms (``MXTPU_BN_ONEPASS``), in training and prediction,
with ``fix_gamma`` and ``use_global_stats``, bf16 data over f32 statistics,
its new moving statistics, and SoftmaxOutput's own backward (grad_scale,
ignore_label/use_ignore, the three normalizations, multi_output,
smooth_alpha).

Tolerances (|port - jax| <= atol + rtol * |jax|, elementwise), with their
reasons:
- f32 values and gradients: rtol 1e-5, atol 1e-5 x the case's largest
  |jax| value: both compute in f32, the sums of a product or a reduction
  in another order (a few ulps of the largest term).
- bf16 values and gradients: rtol 2**-7 (one bf16 ulp: both round once to
  bf16, from f32 sums in another order, so a value near a rounding
  boundary may land on either side), atol 2**-7 x the case's largest
  |jax| value for values near zero from cancelling sums; BatchNorm in
  bf16 takes two bf16 ulps (rtol 2**-6), as its output rounds twice (the
  centred value, then the scale).
Dropout is held exactly where it is deterministic (p = 0, prediction) and
by rate in training (its mask comes from another stream).
"""
import math

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.config import flags as tflags
from mxnet_tpu_torch.ops import registry as treg

R = np.random.RandomState(0)


def _f(*shape):
    return R.randn(*shape).astype(np.float32)


def _case(cid, op, attrs, inputs, dtype='float32', diff=None, onepass=True,
          train=True, tol=None):
    """A case: op name, attrs, numpy inputs (floats in ``dtype`` unless
    given as integers), the inputs to differentiate (default: every float
    input but BatchNorm's statistics), the BN form and the train flag."""
    if diff is None:
        diff = [i for i, a in enumerate(inputs) if a.dtype.kind == 'f']
        if op == 'BatchNorm':
            diff = [i for i in diff if i < 3]
        if op == 'SoftmaxOutput':
            diff = [0]
    return dict(id=cid, op=op, attrs=attrs, inputs=inputs, dtype=dtype,
                diff=diff, onepass=onepass, train=train, tol=tol)


CASES = []
# -- FullyConnected -----------------------------------------------------
for dt in ('float32', 'bfloat16'):
    CASES += [
        _case('fc-flatten-' + dt, 'FullyConnected',
              {'num_hidden': 5}, [_f(3, 2, 4), _f(5, 8), _f(5)], dt),
        _case('fc-noflatten-' + dt, 'FullyConnected',
              {'num_hidden': 5, 'flatten': False}, [_f(3, 2, 4), _f(5, 4),
                                                    _f(5)], dt),
        _case('fc-nobias-' + dt, 'FullyConnected',
              {'num_hidden': 5, 'no_bias': True}, [_f(3, 8), _f(5, 8)], dt),
    ]
# -- Convolution ----------------------------------------------------------
CASES += [
    _case('conv1d', 'Convolution', {'kernel': (3,), 'num_filter': 4,
                                    'stride': (2,), 'pad': (1,)},
          [_f(2, 3, 11), _f(4, 3, 3), _f(4)]),
    _case('conv2d', 'Convolution', {'kernel': (3, 3), 'num_filter': 4,
                                    'stride': (2, 1), 'pad': (1, 2)},
          [_f(2, 3, 9, 7), _f(4, 3, 3, 3), _f(4)]),
    _case('conv2d-dilate-group', 'Convolution',
          {'kernel': (3, 2), 'num_filter': 6, 'dilate': (2, 1),
           'num_group': 2, 'no_bias': True},
          [_f(2, 4, 9, 8), _f(6, 2, 3, 2)]),
    _case('conv2d-stem-bf16', 'Convolution',
          {'kernel': (7, 7), 'num_filter': 8, 'stride': (2, 2),
           'pad': (3, 3), 'no_bias': True},
          [_f(2, 3, 17, 17), _f(8, 3, 7, 7)], 'bfloat16'),
    _case('conv2d-1x1-bf16', 'Convolution',
          {'kernel': (1, 1), 'num_filter': 16, 'stride': (2, 2)},
          [_f(2, 8, 9, 9), _f(16, 8, 1, 1), _f(16)], 'bfloat16'),
    _case('conv3d', 'Convolution', {'kernel': (2, 3, 3), 'num_filter': 3,
                                    'pad': (1, 1, 0), 'stride': (1, 2, 1)},
          [_f(1, 2, 5, 6, 5), _f(3, 2, 2, 3, 3), _f(3)]),
    _case('deconv2d', 'Deconvolution',
          {'kernel': (3, 3), 'num_filter': 4, 'stride': (2, 2),
           'pad': (1, 1), 'adj': (1, 0), 'no_bias': False},
          [_f(2, 3, 5, 4), _f(3, 4, 3, 3), _f(4)]),
    _case('deconv2d-group', 'Deconvolution',
          {'kernel': (2, 2), 'num_filter': 4, 'stride': (2, 2),
           'num_group': 2},
          [_f(1, 4, 3, 3), _f(4, 2, 2, 2)]),
]
# -- Pooling on odd sizes -------------------------------------------------
for ptype in ('max', 'avg', 'sum'):
    for conv in ('valid', 'full'):
        CASES.append(_case(
            'pool-%s-%s' % (ptype, conv), 'Pooling',
            {'kernel': (3, 3), 'stride': (2, 2), 'pool_type': ptype,
             'pooling_convention': conv}, [_f(2, 3, 10, 9)]))
    CASES.append(_case(
        'pool-%s-full-pad' % ptype, 'Pooling',
        {'kernel': (2, 2), 'stride': (3, 3), 'pad': (1, 1), 'pool_type': ptype,
         'pooling_convention': 'full'}, [_f(2, 2, 5, 7)]))
    CASES.append(_case(
        'pool-%s-global' % ptype, 'Pooling',
        {'kernel': (1, 1), 'global_pool': True, 'pool_type': ptype},
        [_f(2, 3, 7, 5)]))
CASES += [
    _case('pool-max-stem', 'Pooling',
          {'kernel': (3, 3), 'stride': (2, 2), 'pad': (1, 1)},
          [_f(2, 4, 9, 9)]),
    _case('pool-max-stem-bf16', 'Pooling',
          {'kernel': (3, 3), 'stride': (2, 2), 'pad': (1, 1)},
          [_f(2, 4, 9, 9)], 'bfloat16'),
    _case('pool-avg-global-bf16', 'Pooling',
          {'kernel': (1, 1), 'global_pool': True, 'pool_type': 'avg'},
          [_f(2, 8, 7, 7)], 'bfloat16'),
    _case('pool-avg-1d-full', 'Pooling',
          {'kernel': (3,), 'stride': (2,), 'pool_type': 'avg',
           'pooling_convention': 'full'}, [_f(2, 3, 8)]),
    _case('pool-max-3d', 'Pooling',
          {'kernel': (2, 2, 2), 'stride': (2, 1, 2), 'pad': (1, 0, 0)},
          [_f(1, 2, 5, 4, 5)]),
]
# -- Activations ----------------------------------------------------------
for act in ('relu', 'sigmoid', 'tanh', 'softrelu', 'softsign'):
    CASES.append(_case('act-' + act, 'Activation', {'act_type': act},
                       [_f(3, 5) * 3]))
CASES += [
    _case('act-relu-bf16', 'Activation', {'act_type': 'relu'},
          [_f(4, 6)], 'bfloat16'),
    _case('lrelu-leaky', 'LeakyReLU', {'act_type': 'leaky', 'slope': 0.1},
          [_f(3, 5)]),
    _case('lrelu-elu', 'LeakyReLU', {'act_type': 'elu', 'slope': 0.3},
          [_f(3, 5)]),
    _case('lrelu-prelu', 'LeakyReLU', {'act_type': 'prelu'},
          [_f(2, 3, 4), np.abs(_f(3)) * 0.2]),
    _case('lrelu-rrelu-predict', 'LeakyReLU', {'act_type': 'rrelu'},
          [_f(2, 3, 4)], train=False),
]
# -- BatchNorm --------------------------------------------------------------
_BN_IN = [_f(4, 3, 5, 5) * 2 + 3, 1 + 0.1 * _f(3), 0.1 * _f(3), 0.1 * _f(3),
          1 + np.abs(_f(3)) * 0.1]
for onepass in (True, False):
    for train in (True, False):
        for fix in (True, False):
            CASES.append(_case(
                'bn-%s-%s-%s' % ('onepass' if onepass else 'twopass',
                                 'train' if train else 'predict',
                                 'fixgamma' if fix else 'gamma'),
                'BatchNorm', {'fix_gamma': fix, 'eps': 1e-5, 'momentum': 0.9},
                _BN_IN, onepass=onepass, train=train))
CASES += [
    _case('bn-global-stats', 'BatchNorm',
          {'fix_gamma': False, 'use_global_stats': True}, _BN_IN),
    _case('bn-axis-last', 'BatchNorm', {'fix_gamma': False, 'axis': -1},
          [_f(6, 4) + 1, _f(4), _f(4), _f(4), np.abs(_f(4)) + 0.5]),
    _case('bn-2d-defaults', 'BatchNorm', {}, [_f(8, 3), _f(3), _f(3),
                                             _f(3), np.abs(_f(3)) + 0.5]),
]
for onepass in (True, False):
    CASES.append(_case(
        'bn-bf16-%s' % ('onepass' if onepass else 'twopass'), 'BatchNorm',
        {'fix_gamma': False, 'eps': 1e-5},
        _BN_IN[:1], onepass=onepass, tol=(2 ** -6, 2 ** -7)))
# -- SoftmaxOutput ----------------------------------------------------------
_LAB = np.array([0, 2, 1, 3, 2, 0], np.float32)
_LAB_IGN = np.array([0, -1, 1, 3, -1, 0], np.float32)
CASES += [
    _case('softmaxout', 'SoftmaxOutput', {}, [_f(6, 4), _LAB]),
    _case('softmaxout-scale-batch', 'SoftmaxOutput',
          {'grad_scale': 2.0, 'normalization': 'batch'}, [_f(6, 4), _LAB]),
    _case('softmaxout-ignore-valid', 'SoftmaxOutput',
          {'use_ignore': True, 'ignore_label': -1, 'normalization': 'valid'},
          [_f(6, 4), _LAB_IGN]),
    _case('softmaxout-valid', 'SoftmaxOutput', {'normalization': 'valid'},
          [_f(6, 4), _LAB]),
    _case('softmaxout-smooth', 'SoftmaxOutput', {'smooth_alpha': 0.1},
          [_f(6, 4), _LAB]),
    _case('softmaxout-multi', 'SoftmaxOutput',
          {'multi_output': True, 'use_ignore': True, 'ignore_label': 1},
          [_f(2, 3, 4), np.array([[0, 1, 2, 2], [1, 0, 0, 2]], np.float32)]),
]
# -- softmax_cross_entropy: the labels broadcast against the rows as
#    jnp.take_along_axis broadcasts them (a (1,) label serves every row) --
CASES += [
    _case('xent-one-label', 'softmax_cross_entropy', {},
          [_f(4, 5), np.array([3], np.float32)], diff=[0]),
    _case('xent-one-row', 'softmax_cross_entropy', {},
          [_f(1, 5), np.array([3, 1, 2, 0], np.float32)], diff=[0]),
    _case('xent-labels', 'softmax_cross_entropy', {},
          [_f(4, 5), np.array([3, 1, -1, 0], np.float32)], diff=[0]),
]
# -- the rest of the JAX module's names -------------------------------------
_SEQ_LEN = np.array([2, 4, 1], np.float32)
CASES += [
    _case('instancenorm', 'InstanceNorm', {'eps': 1e-3},
          [_f(2, 3, 4, 5), _f(3), _f(3)]),
    _case('instancenorm-1d', 'InstanceNorm', {}, [_f(2, 3, 7), _f(3), _f(3)]),
    _case('lrn', 'LRN', {}, [_f(2, 7, 3, 4)]),
    _case('lrn-wide', 'LRN', {'nsize': 3, 'alpha': 0.1, 'beta': 0.5,
                              'knorm': 1.0}, [_f(2, 4, 3)]),
    _case('softmaxact', 'SoftmaxActivation', {}, [_f(3, 4, 2)]),
    _case('softmaxact-channel', 'SoftmaxActivation', {'mode': 'channel'},
          [_f(3, 4, 2)]),
    _case('linreg', 'LinearRegressionOutput', {}, [_f(4, 3), _f(4, 3)],
          diff=[0]),
    _case('linreg-scale-reshaped', 'LinearRegressionOutput',
          {'grad_scale': 3.0}, [_f(6, 1), _f(6)], diff=[0]),
    _case('logreg', 'LogisticRegressionOutput', {'grad_scale': 0.5},
          [_f(5, 2), (_f(5, 2) > 0).astype(np.float32)], diff=[0]),
    _case('maereg', 'MAERegressionOutput', {}, [_f(4, 3), _f(4, 3)],
          diff=[0]),
    _case('svm', 'SVMOutput', {}, [_f(6, 4), _LAB], diff=[0]),
    _case('svm-linear', 'SVMOutput', {'use_linear': True, 'margin': 0.5,
                                      'regularization_coefficient': 2.0},
          [_f(6, 4), _LAB], diff=[0]),
    _case('seqlast', 'SequenceLast', {}, [_f(4, 3, 2)]),
    _case('seqlast-len', 'SequenceLast', {'use_sequence_length': True},
          [_f(4, 3, 2), _SEQ_LEN], diff=[0]),
    _case('seqmask', 'SequenceMask', {}, [_f(4, 3, 2)]),
    _case('seqmask-len', 'SequenceMask', {'use_sequence_length': True,
                                          'value': -2.0},
          [_f(4, 3, 2), _SEQ_LEN], diff=[0]),
    _case('seqreverse', 'SequenceReverse', {}, [_f(4, 3, 2)]),
    _case('seqreverse-len', 'SequenceReverse', {'use_sequence_length': True},
          [_f(4, 3), _SEQ_LEN], diff=[0]),
]
for _mode in ('instance', 'channel', 'spatial'):
    CASES.append(_case('l2norm-' + _mode, 'L2Normalization', {'mode': _mode},
                       [_f(2, 3, 4, 2)]))
for _dt in ('float32', 'bfloat16'):
    CASES.append(_case('linreg-' + _dt + '-batch', 'LinearRegressionOutput',
                       {'grad_scale': 2.0}, [_f(3, 5), _f(3, 5)], _dt,
                       diff=[0]))
IDS = [c['id'] for c in CASES]
assert len(set(IDS)) == len(IDS)


def _cast_in(case, i, a):
    """The case's input i as given to both sides (bf16 only for floats
    other than BatchNorm's gamma/beta/statistics, which stay f32)."""
    if case['dtype'] == 'bfloat16' and a.dtype.kind == 'f' and \
            not (case['op'] == 'BatchNorm' and i > 0):
        return a.astype(ml_dtypes.bfloat16)
    return a


def _bn_inputs(case):
    if case['op'] == 'BatchNorm' and len(case['inputs']) == 1:
        # bf16 data over f32 statistics
        c = case['inputs'][0].shape[1]
        case['inputs'] = case['inputs'] + [np.ones(c, np.float32) * 1.1,
                                           np.full(c, 0.2, np.float32),
                                           np.zeros(c, np.float32),
                                           np.ones(c, np.float32)]
        case['dtype'] = 'bfloat16'
    return case


for _c in CASES:
    _bn_inputs(_c)
    _c['inputs'] = [_cast_in(_c, i, a) for i, a in enumerate(_c['inputs'])]
    _c['cot_seed'] = IDS.index(_c['id'])


def _attrs(case):
    a = dict(case['attrs'])
    op = treg.get(case['op'])
    if op.train_aware:
        a['__is_train__'] = case['train']
    return a


def _jax_case(case):
    op = jreg.get(case['op'])
    attrs = _attrs(case)
    args = [jnp.asarray(a) for a in case['inputs']]
    if op.needs_rng:
        args.append(jax.random.PRNGKey(0))

    def f(*d):
        full = list(args)
        for i, x in zip(case['diff'], d):
            full[i] = x
        out = op.fn(attrs, *full)
        return out if isinstance(out, tuple) else (out,)

    outs, vjp = jax.vjp(f, *[args[i] for i in case['diff']])
    cot = [jnp.asarray(np.asarray(np.random.RandomState(case['cot_seed'])
                                  .randn(*o.shape), np.float32)).astype(o.dtype)
           if k == 0 else jnp.zeros_like(o) for k, o in enumerate(outs)]
    return outs, vjp(tuple(cot)), cot[0]


@pytest.fixture(scope='module')
def jax_results(request):
    """Every case's JAX values and gradients, from one jitted program per
    BatchNorm form (the form is read when the program is traced)."""
    out = {}
    for onepass in (True, False):
        cases = [c for c in CASES if c['onepass'] == onepass]
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv('MXTPU_BN_ONEPASS', '1' if onepass else '0')
            res = jax.jit(lambda: [_jax_case(c) for c in cases])()
        for c, r in zip(cases, res):
            out[c['id']] = jax.tree_util.tree_map(np.asarray, r)
    return out


def _to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t):
    t = t.detach()
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _tol(case, want):
    if case['tol'] is not None:
        rtol, arel = case['tol']
    elif want.dtype == ml_dtypes.bfloat16 or case['dtype'] == 'bfloat16':
        rtol, arel = 2 ** -7, 2 ** -7
    else:
        rtol, arel = 1e-5, 1e-5
    scale = float(np.abs(want.astype(np.float32)).max()) if want.size else 0
    return rtol, arel * max(scale, 1e-30)


@pytest.fixture
def bn_form(monkeypatch):
    """Sets the port's BatchNorm form; the port caches its flags, so the
    flag is reloaded here and again once the environment is restored."""
    def set_form(onepass):
        monkeypatch.setenv('MXTPU_BN_ONEPASS', '1' if onepass else '0')
        tflags.reload('MXTPU_BN_ONEPASS')
    yield set_form
    monkeypatch.undo()
    tflags.reload('MXTPU_BN_ONEPASS')


@pytest.mark.parametrize('case', CASES, ids=IDS)
def test_op_matches_jax(case, jax_results, bn_form):
    bn_form(case['onepass'])
    want_outs, want_grads, cot = jax_results[case['id']]
    op = treg.get(case['op'])
    args = [_to_torch(a) for a in case['inputs']]
    for i in case['diff']:
        args[i].requires_grad_()
    if op.needs_rng:
        args.append(torch.Generator().manual_seed(0))
    outs = op.fn(_attrs(case), *args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    assert len(outs) == len(want_outs)
    for k, (got, want) in enumerate(zip(outs, want_outs)):
        assert tuple(got.shape) == want.shape, (k, got.shape, want.shape)
        assert str(got.dtype).split('.')[-1] == str(want.dtype), \
            (k, got.dtype, want.dtype)
        rtol, atol = _tol(case, want)
        np.testing.assert_allclose(_np(got), want.astype(np.float32),
                                   rtol=rtol, atol=atol, err_msg='out%d' % k)
    grads = torch.autograd.grad(outs[0], [args[i] for i in case['diff']],
                                _to_torch(cot).to(outs[0].dtype),
                                allow_unused=True)
    for i, got, want in zip(case['diff'], grads, want_grads):
        if got is None:
            got = torch.zeros(want.shape)
        rtol, atol = _tol(case, want)
        np.testing.assert_allclose(_np(got), want.astype(np.float32),
                                   rtol=rtol, atol=atol,
                                   err_msg='grad of input %d' % i)


@pytest.mark.parametrize('label', [[3, 1, 2], [[3]]], ids=['rows', 'rank'])
def test_xent_labels_raise_where_jax_raises(label):
    """Labels that do not broadcast against the rows (3 of 4), or of
    another rank, raise ValueError in both packages, in both branches."""
    x, lab = _f(4, 5), np.array(label, np.float32)
    with pytest.raises(ValueError):
        jreg.get('softmax_cross_entropy').fn({}, jnp.asarray(x),
                                             jnp.asarray(lab))
    for force in ('0', '1'):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv('MXTPU_FORCE_PALLAS', force)
            with pytest.raises(ValueError):
                treg.get('softmax_cross_entropy').fn(
                    {}, torch.from_numpy(x), torch.from_numpy(lab))


def test_xent_kernel_branch_takes_one_label(monkeypatch):
    """With the kernel branch forced (its plain version on the CPU), a (1,)
    label reaches softmax_xent broadcast to every row: the JAX plain
    branch's value."""
    x, lab = _f(4, 5), np.array([3], np.float32)
    want = float(jreg.get('softmax_cross_entropy').fn(
        {}, jnp.asarray(x), jnp.asarray(lab)))
    monkeypatch.setenv('MXTPU_FORCE_PALLAS', '1')
    got = float(treg.get('softmax_cross_entropy').fn(
        {}, torch.from_numpy(x), torch.from_numpy(lab)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_bn_new_statistics_carry_no_gradient():
    x = torch.randn(4, 3, 2, 2, requires_grad=True)
    g, b = torch.ones(3, requires_grad=True), torch.zeros(3, requires_grad=True)
    _, mm, mv = treg.get('BatchNorm').fn({'__is_train__': True}, x, g, b,
                                         torch.zeros(3), torch.ones(3))
    assert not mm.requires_grad and not mv.requires_grad


@pytest.mark.parametrize('train', [True, False])
def test_dropout_exact_at_p0_and_in_prediction(train):
    x = nd.array(_f(5, 7), ctx=mt.cpu())
    with autograd.train_mode() if train else autograd.predict_mode():
        y0 = nd.Dropout(x, p=0.0)
        y = nd.Dropout(x, p=0.5)
    np.testing.assert_array_equal(y0.asnumpy(), x.asnumpy())
    if not train:
        np.testing.assert_array_equal(y.asnumpy(), x.asnumpy())
    assert np.array_equal(mx.nd.Dropout(mx.nd.array(x.asnumpy()),
                                        p=0.0).asnumpy(), x.asnumpy())


@pytest.mark.parametrize('p', [0.25, 0.5])
def test_dropout_rate_in_training(p):
    """In training a share p of the elements (within 5 standard errors,
    sqrt(p (1 - p) / n)) becomes 0 and the rest x / (1 - p), as in the JAX
    op; mode='always' drops in prediction too."""
    n = 40000
    x = nd.ones((n,), ctx=mt.cpu())
    with autograd.train_mode():
        y = nd.Dropout(x, p=p).asnumpy()
    with mx.autograd.train_mode():
        want = mx.nd.Dropout(mx.nd.ones((n,)), p=p).asnumpy()
    for out in (y, want):
        dropped = (out == 0).mean()
        assert abs(dropped - p) <= 5 * math.sqrt(p * (1 - p) / n)
        np.testing.assert_allclose(out[out != 0], 1 / (1 - p), rtol=1e-6)
    always = nd.Dropout(x, p=p, mode='always').asnumpy()
    assert abs((always == 0).mean() - p) <= 5 * math.sqrt(p * (1 - p) / n)


def test_rrelu_in_training_draws_slopes_in_bounds():
    x = -nd.ones((2, 64, 3), ctx=mt.cpu())
    with autograd.train_mode():
        y = nd.LeakyReLU(x, act_type='rrelu', lower_bound=0.1,
                         upper_bound=0.3).asnumpy()
    slopes = -y[0, :, 0]
    assert (slopes >= 0.1).all() and (slopes <= 0.3).all()
    assert np.array_equal(y[0], y[1]) and len(np.unique(slopes)) > 1


def test_aliases_and_registry_fields():
    for alias, name in (('BatchNorm_v1', 'BatchNorm'), ('Pooling_v1', 'Pooling'),
                        ('Softmax', 'SoftmaxOutput'),
                        ('CuDNNBatchNorm', 'BatchNorm')):
        assert treg.get(alias) is treg.get(name)
    bn = treg.get('BatchNorm')
    jbn = jreg.get('BatchNorm')
    assert bn.aux_inputs == jbn.aux_inputs and bn.mutate_inputs == \
        jbn.mutate_inputs and bn.param_defaults == jbn.param_defaults
    for name in ('FullyConnected', 'Convolution', 'Deconvolution', 'Pooling',
                 'Activation', 'LeakyReLU', 'Dropout', 'SoftmaxOutput',
                 'InstanceNorm', 'L2Normalization', 'LRN', 'SoftmaxActivation',
                 'LinearRegressionOutput', 'LogisticRegressionOutput',
                 'MAERegressionOutput', 'SVMOutput', 'SequenceLast',
                 'SequenceMask', 'SequenceReverse'):
        t, j = treg.get(name), jreg.get(name)
        assert t.input_names == j.input_names, name
        assert t.optional_inputs == j.optional_inputs, name
        assert t.param_defaults == j.param_defaults, name
        assert (t.needs_rng, t.train_aware) == (j.needs_rng, j.train_aware)
    fc = treg.get('FullyConnected')
    assert fc.arg_names({'no_bias': True}) == ['data', 'weight']
    assert fc.arg_names({}) == ['data', 'weight', 'bias']
    assert treg.get('Deconvolution').arg_names({}) == ['data', 'weight']


def test_conv_flags_change_nothing(monkeypatch):
    """MXTPU_CONV_STEM_S2D and MXTPU_CONV_BWD_PATCHES are declared and
    leave the port's Convolution as it is."""
    from mxnet_tpu_torch.config import flags
    x, w = torch.randn(2, 3, 17, 17), torch.randn(8, 3, 7, 7)
    attrs = {'kernel': (7, 7), 'num_filter': 8, 'stride': (2, 2),
             'pad': (3, 3), 'no_bias': True}
    base = treg.get('Convolution').fn(attrs, x, w)
    for flag in ('MXTPU_CONV_STEM_S2D', 'MXTPU_CONV_BWD_PATCHES'):
        monkeypatch.setenv(flag, '1')
        flags.reload(flag)
        assert flags.get(flag) is True
        assert torch.equal(treg.get('Convolution').fn(attrs, x, w), base)
    flags.reload()
