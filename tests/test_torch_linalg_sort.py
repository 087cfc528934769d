"""The port's linear algebra and ordering ops (mxnet_tpu_torch.ops.linalg_sort:
dot, batch_dot, khatri_rao, the linalg_* family with its aliases, sort,
argsort, topk) and the NDArray and Symbol forms over them, against the JAX
package's on the CPU.

Every name that ``mxnet_tpu/ops/linalg_sort.py`` registers, aliases
included, exists in the port's registry and in ``nd`` with the same input
names and parameter defaults, an alias naming the same op as in the JAX
registry. Each case runs the JAX op's function and its ``jax.vjp`` for a
cotangent drawn with the inputs (all cases in one jitted program), and the
port's op and torch autograd for the same cotangent: over dtypes (f32,
bf16, int32), axes (last, first, None), the transpose flags of the
products, and the side, transpose and triangle flags of trsm and trmm.

Tolerances (|port - jax| <= atol + rtol * |jax|, elementwise, atol = rtol
x the case's largest |jax| value), with their reasons:
- f32 products and their gradients: rtol 1e-5 (sums of products in
  another order);
- the factorizations (potrf, potri, trsm, gelqf, sumlogdiag) and their
  gradients: rtol 1e-4 (LAPACK's blocked algorithms against torch's calls
  into the same routines, through a different sequence of steps);
- bf16 dot and batch_dot: rtol 2**-7, one bf16 ulp (both accumulate in
  f32 and round once; a value near a rounding boundary may land on either
  side);
- integer products and every ordering: exact, bit for bit but NaN's
  (NaN where NaN; torch's CPU gather rewrites a bf16 NaN's bits), signed
  zeros included (ties, NaN of both signs, infinities and -0).
"""
import os
import re

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.ops import registry as treg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = re.findall(r"register(?:_alias)?\('(\w+)'", open(
    os.path.join(ROOT, 'mxnet_tpu', 'ops', 'linalg_sort.py')).read())
R = np.random.RandomState(0)
PRODUCT, FACTOR, BF16, EXACT = 1e-5, 1e-4, 2 ** -7, 0.0


def _f(*shape):
    return R.randn(*shape).astype(np.float32)


def _spd(b, n):
    m = _f(b, n, n)
    return (m @ m.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32))


def _lower(b, n):
    """Lower-triangular factors with a diagonal in [1, 2]; their upper
    triangles hold values that the ops must not read."""
    a = _f(b, n, n)
    idx = np.arange(n)
    a[:, idx, idx] = 1 + np.abs(a[:, idx, idx]) % 1
    return a


# ties, NaN of both signs, infinities and both zeros, in rows
_ORD = np.array([[3, 1, 3, np.nan, 2, 1, -np.inf, 0, -0.0, -np.nan],
                 [0, -0.0, np.inf, 2, 2, 2, -1, np.nan, 5, -2]], np.float32)
_ORD_INT = np.array([[3, 1, 3, -7, 2, 1], [0, 0, 9, 2, 2, -1]], np.int32)


def _case(cid, op, attrs, inputs, tol=PRODUCT, diff=None, dtype='float32'):
    if diff is None:
        diff = ([i for i, a in enumerate(inputs) if a.dtype.kind == 'f']
                if jreg.get(op).differentiable else [])
    if dtype == 'bfloat16':
        inputs = [a.astype(ml_dtypes.bfloat16) if a.dtype.kind == 'f' else a
                  for a in inputs]
    return dict(id=cid, op=op, attrs=attrs, inputs=inputs, tol=tol,
                diff=diff)


CASES = []
# -- dot: tensordot over lhs's last and rhs's first axis -------------------
for ta in (False, True):
    for tb in (False, True):
        CASES.append(_case('dot-2d-ta%d-tb%d' % (ta, tb), 'dot',
                           {'transpose_a': ta, 'transpose_b': tb},
                           [_f(*((5, 3) if ta else (3, 5))),
                            _f(*((4, 5) if tb else (5, 4)))]))
        CASES.append(_case('batch_dot-ta%d-tb%d' % (ta, tb), 'batch_dot',
                           {'transpose_a': ta, 'transpose_b': tb},
                           [_f(*((2, 5, 3) if ta else (2, 3, 5))),
                            _f(*((2, 4, 5) if tb else (2, 5, 4)))]))
CASES += [
    _case('dot-1d-1d', 'dot', {}, [_f(6), _f(6)]),
    _case('dot-1d-2d', 'dot', {}, [_f(3), _f(3, 4)]),
    _case('dot-2d-1d', 'dot', {}, [_f(3, 4), _f(4)]),
    _case('dot-3d-3d', 'dot', {}, [_f(2, 3, 4), _f(4, 3, 2)]),
    _case('dot-3d-ta-tb', 'dot', {'transpose_a': True, 'transpose_b': True},
          [_f(4, 3, 2), _f(2, 3, 4)]),
    _case('dot-bf16', 'dot', {}, [_f(6, 32), _f(32, 5)], BF16,
          dtype='bfloat16'),
    _case('dot-bf16-tb', 'dot', {'transpose_b': True}, [_f(6, 32), _f(5, 32)],
          BF16, dtype='bfloat16'),
    _case('batch_dot-bf16', 'batch_dot', {'transpose_b': True},
          [_f(3, 6, 16), _f(3, 5, 16)], BF16, dtype='bfloat16'),
    _case('dot-int32', 'dot', {}, [R.randint(-50, 50, (3, 7)).astype(np.int32),
                                   R.randint(-50, 50, (7, 2)).astype(np.int32)],
          EXACT),
    _case('dot-int32-saturates', 'dot', {},
          [np.full((2, 3), 2 ** 20, np.int32),
           np.full((3, 2), 2 ** 20 + 1, np.int32) * np.array([1, -1], np.int32)],
          EXACT),
    _case('batch_dot-int32', 'batch_dot', {'transpose_a': True},
          [R.randint(-9, 9, (2, 4, 3)).astype(np.int32),
           R.randint(-9, 9, (2, 4, 5)).astype(np.int32)], EXACT),
    _case('khatri_rao-2', 'khatri_rao', {'num_args': 2}, [_f(2, 3), _f(4, 3)]),
    _case('khatri_rao-3', 'khatri_rao', {'num_args': 3},
          [_f(2, 3), _f(1, 3), _f(3, 3)]),
]
# -- the linalg_* family ----------------------------------------------------
for ta in (False, True):
    for tb in (False, True):
        A = _f(2, 4, 3) if ta else _f(2, 3, 4)
        B = _f(2, 5, 4) if tb else _f(2, 4, 5)
        CASES.append(_case('gemm-ta%d-tb%d' % (ta, tb), '_linalg_gemm',
                           {'transpose_a': ta, 'transpose_b': tb,
                            'alpha': 0.7, 'beta': -1.5}, [A, B, _f(2, 3, 5)]))
        CASES.append(_case('gemm2-ta%d-tb%d' % (ta, tb), '_linalg_gemm2',
                           {'transpose_a': ta, 'transpose_b': tb,
                            'alpha': 1.3}, [A, B]))
for t in (False, True):
    for right in (False, True):
        for lower in (False, True):
            tag = 't%d-r%d-l%d' % (t, right, lower)
            A = _lower(2, 4)
            if not lower:
                A = A.transpose(0, 2, 1).copy()
            B = _f(2, 3, 4) if right else _f(2, 4, 3)
            CASES.append(_case('trsm-' + tag, '_linalg_trsm',
                               {'transpose': t, 'rightside': right,
                                'lower': lower, 'alpha': 0.5}, [A, B],
                               FACTOR))
            CASES.append(_case('trmm-' + tag, '_linalg_trmm',
                               {'transpose': t, 'rightside': right,
                                'lower': lower, 'alpha': -2.0}, [A, B]))
CASES += [
    _case('potrf', '_linalg_potrf', {}, [_spd(3, 4)], FACTOR),
    _case('potrf-2d', '_linalg_potrf', {}, [_spd(1, 5)[0]], FACTOR),
    _case('potri', '_linalg_potri', {}, [_lower(3, 4)], FACTOR),
    _case('syrk', '_linalg_syrk', {}, [_f(2, 3, 5)]),
    _case('syrk-t-alpha', '_linalg_syrk', {'transpose': True, 'alpha': 0.25},
          [_f(2, 3, 5)]),
    _case('sumlogdiag', '_linalg_sumlogdiag', {}, [_spd(3, 4)], FACTOR),
    _case('gelqf', '_linalg_gelqf', {}, [_f(2, 3, 5)], FACTOR),
    _case('gelqf-square', '_linalg_gelqf', {}, [_f(4, 4)], FACTOR),
]
# -- orderings --------------------------------------------------------------
for asc in (True, False):
    for ax, axname in ((-1, 'last'), (0, 'first'), (None, 'none')):
        tag = '%s-%s' % ('asc' if asc else 'desc', axname)
        attrs = {'axis': ax, 'is_ascend': asc}
        CASES += [_case('sort-' + tag, 'sort', attrs, [_ORD], EXACT),
                  _case('argsort-' + tag, 'argsort', attrs, [_ORD], EXACT),
                  _case('sort-int32-' + tag, 'sort', attrs, [_ORD_INT], EXACT),
                  _case('argsort-int32-' + tag, 'argsort', attrs, [_ORD_INT],
                        EXACT)]
        for ret in ('indices', 'value', 'mask', 'both'):
            k = 3 if ax is not None else 7
            if ax == 0:
                k = 2
            CASES.append(_case('topk-%s-%s' % (ret, tag), 'topk',
                               dict(attrs, k=k, ret_typ=ret), [_ORD], EXACT))
CASES += [
    _case('sort-bf16', 'sort', {'is_ascend': False}, [_ORD], EXACT,
          dtype='bfloat16'),
    _case('argsort-bf16', 'argsort', {}, [_ORD], EXACT, dtype='bfloat16'),
    _case('topk-bf16-both', 'topk', {'k': 10, 'ret_typ': 'both'}, [_ORD],
          EXACT, dtype='bfloat16'),
    _case('topk-int32-both-asc', 'topk', {'k': 4, 'ret_typ': 'both',
                                          'is_ascend': True}, [_ORD_INT],
          EXACT),
    _case('topk-k0', 'topk', {'k': 0, 'ret_typ': 'value'}, [_ORD], EXACT),
    _case('sort-grad', 'sort', {'is_ascend': False}, [_f(3, 6)], EXACT),
]
IDS = [c['id'] for c in CASES]
assert len(set(IDS)) == len(IDS)
for _i, _c in enumerate(CASES):
    _c['cot_seed'] = _i


def _jax_case(case):
    op = jreg.get(case['op'])
    args = [jnp.asarray(a) for a in case['inputs']]

    def f(*d):
        full = list(args)
        for i, x in zip(case['diff'], d):
            full[i] = x
        out = op.fn(dict(case['attrs']), *full)
        return out if isinstance(out, tuple) else (out,)

    if not case['diff']:
        return f(), (), None
    outs, vjp = jax.vjp(f, *[args[i] for i in case['diff']])
    cot = [jnp.asarray(np.asarray(np.random.RandomState(case['cot_seed'])
                                  .randn(*o.shape), np.float32)).astype(o.dtype)
           for o in outs]
    return outs, vjp(tuple(cot)), cot


@pytest.fixture(scope='module')
def jax_results():
    res = jax.jit(lambda: [_jax_case(c) for c in CASES])()
    return {c['id']: jax.tree_util.tree_map(np.asarray, r)
            for c, r in zip(CASES, res)}


def _to_torch(a):
    """The numpy array as a tensor, bit for bit (bf16 through its bits, so
    that NaN keeps its sign)."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _check(got, want, tol, what):
    got = got.detach()
    assert tuple(got.shape) == want.shape, (what, got.shape, want.shape)
    assert str(got.dtype).split('.')[-1] == str(want.dtype), \
        (what, got.dtype, want.dtype)
    if tol == EXACT:
        # bit for bit, NaN where NaN (torch's CPU gather of bf16 rewrites a
        # NaN's bits, a NaN still)
        g = (got.view(torch.int16).numpy() if got.dtype == torch.bfloat16
             else got.numpy())
        if want.dtype.kind == 'f' or want.dtype == ml_dtypes.bfloat16:
            nan = np.isnan(want.astype(np.float32))
            np.testing.assert_array_equal(np.isnan(got.float().numpy()), nan,
                                          err_msg=what)
            bits = {2: np.int16, 4: np.int32, 8: np.int64}[want.dtype.itemsize]
            g = np.where(nan, 0, g.view(bits))
            want = np.where(nan, 0, want.view(bits))
        np.testing.assert_array_equal(g, want, err_msg=what)
        return
    w = want.astype(np.float32)
    scale = float(np.abs(w).max()) if w.size else 0.0
    np.testing.assert_allclose(got.float().numpy(), w, rtol=tol,
                               atol=tol * max(scale, 1e-30), err_msg=what)


@pytest.mark.parametrize('case', CASES, ids=IDS)
def test_op_matches_jax(case, jax_results):
    want_outs, want_grads, cot = jax_results[case['id']]
    args = [_to_torch(a) for a in case['inputs']]
    for i in case['diff']:
        args[i].requires_grad_()
    outs = treg.get(case['op']).fn(dict(case['attrs']), *args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    assert len(outs) == len(want_outs)
    for k, (got, want) in enumerate(zip(outs, want_outs)):
        _check(got, want, case['tol'], 'out%d' % k)
    if not case['diff']:
        return
    grads = torch.autograd.grad(
        outs, [args[i] for i in case['diff']],
        [_to_torch(np.asarray(c)).to(o.dtype) for c, o in zip(cot, outs)],
        allow_unused=True)
    for i, got, want in zip(case['diff'], grads, want_grads):
        tol = case['tol'] if case['tol'] != EXACT else PRODUCT
        _check(got, want, tol, 'grad of input %d' % i)


def test_every_name_is_registered_and_in_nd():
    assert len(set(NAMES)) == 24
    for name in NAMES:
        t, j = treg.get(name), jreg.get(name)
        assert t.input_names == j.input_names, name
        assert t.param_defaults == j.param_defaults, name
        assert t.differentiable == j.differentiable, name
        assert (t.variadic, t.key_var_num_args) == \
            (j.variadic, j.key_var_num_args), name
        assert t.n_outputs({'ret_typ': 'both'}) == \
            j.n_outputs({'ret_typ': 'both'}), name
        assert callable(getattr(nd, name)), name
        for other in NAMES:
            assert (treg.get(other) is t) == (jreg.get(other) is j)
    assert treg.get('_sparse_dot') is treg.get('dot')


def test_topk_k_larger_than_the_axis_raises_as_in_jax():
    x = _ORD[:, :4]
    with pytest.raises(ValueError):
        jreg.get('topk').fn({'k': 5}, jnp.asarray(x))
    with pytest.raises(ValueError):
        treg.get('topk').fn({'k': 5}, torch.from_numpy(x))


def test_potrf_of_a_matrix_not_positive_definite_is_nan():
    """NaN in the lower triangle, zeros above, where torch's Cholesky
    would raise."""
    a = np.stack([-np.eye(3, dtype=np.float32), _spd(1, 3)[0]])
    want = np.asarray(jreg.get('_linalg_potrf').fn({}, jnp.asarray(a)))
    got = treg.get('_linalg_potrf').fn({}, torch.from_numpy(a)).numpy()
    assert np.isnan(want[0][np.tril_indices(3)]).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _surface(x, y, ndm):
    """The NDArray methods and nd functions of either package."""
    return [x.sort(), x.sort(axis=0, is_ascend=False), x.argsort(),
            x.argsort(axis=None, is_ascend=False), x.topk(k=2),
            x.topk(axis=0, k=2, ret_typ='mask'),
            *x.topk(k=3, ret_typ='both', is_ascend=True),
            x.dot(y), x.dot(x, transpose_b=True),
            ndm.dot(x, y, transpose_a=False), ndm.topk(x, k=1, ret_typ='value'),
            ndm.sort(x, axis=None), ndm.batch_dot(
                x.reshape((1, 4, 5)), y.reshape((1, 5, 3))),
            ndm.linalg_gemm2(x, y, alpha=2.0), ndm.linalg_syrk(x)]


def test_method_forms_match_mx_nd():
    x = np.round(_f(4, 5), 1)           # ties
    y = _f(5, 3)
    got = _surface(nd.array(x, ctx=mt.cpu()), nd.array(y, ctx=mt.cpu()), nd)
    want = _surface(mx.nd.array(x, ctx=mx.cpu()), mx.nd.array(y, ctx=mx.cpu()),
                    mx.nd)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, i
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=str(i))


def test_symbol_forms_match_jax():
    """sym.dot, sym.topk and the Symbol methods build graphs that infer the
    JAX package's shapes and run to its values."""
    x, y = _f(4, 5), _f(5, 3)
    outs = []
    for lib, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        a, b = lib.sym.var('a'), lib.sym.var('b')
        net = lib.sym.Group([lib.sym.dot(a, b), a.topk(k=2, ret_typ='value'),
                             a.sort(axis=0), a.argsort(is_ascend=False),
                             a.dot(b, transpose_a=False),
                             lib.sym.linalg_gemm2(a, b)])
        shapes = net.infer_shape(a=(4, 5), b=(5, 3))
        ex = net.bind(ctx, {'a': lib.nd.array(x, ctx=ctx),
                            'b': lib.nd.array(y, ctx=ctx)})
        outs.append((shapes, [o.asnumpy() for o in ex.forward()]))
    assert outs[1][0] == outs[0][0]
    for g, w in zip(outs[1][1], outs[0][1]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_gradients_under_record():
    """dot's and sort's gradients through autograd.record() on NDArrays,
    against the JAX package's."""
    x, y = _f(3, 4), _f(4, 2)
    res = []
    for lib, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        a, b = lib.nd.array(x, ctx=ctx), lib.nd.array(y, ctx=ctx)
        a.attach_grad()
        b.attach_grad()
        with lib.autograd.record():
            out = (lib.nd.dot(a, b) * lib.nd.dot(a, b)).sum() \
                + (a.sort(axis=-1) * lib.nd.array(np.arange(4.0), ctx=ctx)
                   ).sum()
        out.backward()
        res.append((a.grad.asnumpy(), b.grad.asnumpy()))
    for g, w in zip(res[1], res[0]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
