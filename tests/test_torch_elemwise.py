"""The port's elementwise and reduce ops (mxnet_tpu_torch.ops.elemwise,
ops.reduce_ops) and the NDArray surface over them (arithmetic, comparison
and in-place dunders, indexing, add_n, arange, waitall) against the JAX
package's, on the CPU.

Every name that ``mxnet_tpu/ops/elemwise.py`` and ``reduce_ops.py``
register, aliases included, must exist in the port's registry and in
``nd``, with an alias naming the same op as in the JAX registry. Each op is
then held to ``mxnet_tpu.ops.registry.get(name).fn`` on the same numpy
inputs, f32, bf16 and int32 where the JAX op takes them, in value and in
dtype.

Tolerances (|port - jax| <= atol + rtol * |jax|), with their reasons:
- f32: rtol 1e-6; the transcendental ops (exp, log, trigonometric and
  hyperbolic functions, erf, gamma, cbrt, power, hypot) 2e-6, since XLA's
  CPU code and torch's evaluate them with other approximations (a few
  ulps); atol 1e-6 for results near zero (sin(pi), expm1 of a tiny x) and
  1e-5 for the sums and norms of 60 terms of magnitude 1; gammaln atol
  4e-6, as near its roots at 1 and 2 its value is the difference of O(1)
  terms that the two approximations each get to a few f32 ulps;
- bf16: one bf16 ulp, rtol 2**-7, as both sides round an f32 value to bf16
  (a value a few f32 ulps apart may round either way); atol 1e-6;
- int32 results and comparisons: exact.
"""
import functools
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch import cpu, nd
from mxnet_tpu_torch.ops import registry as treg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRANSCENDENTAL = {'exp', 'log', 'log10', 'log2', 'log1p', 'expm1', 'sin',
                  'cos', 'tan', 'arcsin', 'arccos', 'arctan', 'sinh', 'cosh',
                  'tanh', 'arcsinh', 'arccosh', 'arctanh', 'erf', 'gamma',
                  'gammaln', 'cbrt', 'rcbrt', 'rsqrt', 'sigmoid', 'sqrt',
                  'broadcast_power', 'broadcast_hypot', '_power_scalar',
                  '_rpower_scalar', '_hypot_scalar', 'norm', 'softsign',
                  'degrees', 'radians', 'mean'}


def _registered(module):
    """The names ``mxnet_tpu/ops/<module>.py`` registers, aliases included,
    in order: its source run against a recording registry."""
    path = os.path.join(ROOT, 'mxnet_tpu', 'ops', module + '.py')
    src = open(path).read()
    names = []

    def register(name, **kwargs):
        names.append(name)
        return lambda fn: fn

    env = {'register': register,
           'register_alias': lambda alias, name: names.append(alias)}
    exec(compile(src.replace('from .registry import register, register_alias',
                             ''), path, 'exec'), env)
    return names


ELEMWISE = _registered('elemwise')
REDUCE = _registered('reduce_ops')
NAMES = ELEMWISE + REDUCE


def _canonical(names):
    """One name for each distinct JAX op among ``names``."""
    seen, out = set(), []
    for n in names:
        if id(jreg.get(n)) not in seen:
            seen.add(id(jreg.get(n)))
            out.append(n)
    return out


def test_every_name_is_registered_and_in_nd():
    assert len(ELEMWISE) == 116 and len(REDUCE) == 18
    for name in NAMES:
        assert treg.exists(name), name
        assert callable(getattr(nd, name)), name
        t, j = treg.get(name), jreg.get(name)
        assert t.input_names == j.input_names, name
        assert t.param_defaults == j.param_defaults, name
        assert t.variadic == j.variadic, name
    # an alias names the same op in both registries
    for a in NAMES:
        for b in NAMES:
            assert (treg.get(a) is treg.get(b)) == (jreg.get(a) is jreg.get(b)), (a, b)


# ---------------------------------------------------------------------------
# parity of every op with the JAX op
# ---------------------------------------------------------------------------

def _tol(name, dtype):
    if dtype == 'bfloat16':
        return dict(rtol=2 ** -7, atol=1e-6)
    if name == 'gammaln':
        return dict(rtol=2e-6, atol=4e-6)
    if name in ('sum', 'nansum', 'norm', 'mean', 'prod', 'nanprod'):
        return dict(rtol=2e-6, atol=1e-5)
    return dict(rtol=2e-6 if name in TRANSCENDENTAL else 1e-6, atol=1e-6)


def _to_jax(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype))


def _to_torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32 if dtype == 'bfloat16'
                                       else dtype)).to(getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.float().numpy().astype(ml_dtypes.bfloat16)
        return x.numpy()
    return np.asarray(x)


def _compare(name, got, want):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if want.dtype.kind in 'iub':
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    dtype = 'bfloat16' if want.dtype == ml_dtypes.bfloat16 else 'float32'
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32),
                               err_msg=name, **_tol(name, dtype))


# inputs: non-integer floats away from the poles and branch points the JAX
# and torch functions treat alike; ints with negatives and zero
_RNG = np.random.RandomState(0)
X_F = (_RNG.standard_normal((3, 4, 5)) * 1.5).astype(np.float32)
X_I = _RNG.randint(-4, 6, (3, 4, 5)).astype(np.float32)
DOMAIN = {'arcsin': np.tanh, 'arccos': np.tanh, 'arctanh': lambda x: np.tanh(x) * 0.9,
          'arccosh': lambda x: np.abs(x) + 1.0, 'log': np.abs, 'log10': np.abs,
          'log2': np.abs, 'sqrt': np.abs, 'rsqrt': lambda x: np.abs(x) + 0.1,
          'log1p': lambda x: np.abs(x) - 0.5, 'gamma': lambda x: np.abs(x) + 0.1,
          'gammaln': lambda x: np.abs(x) + 0.1, 'reciprocal': lambda x: x + 0.05}
# unary ops the JAX package does not take for an int32 input: both packages
# raise TypeError (test_op_raises_where_jax_raises)
NO_INT = {'rsqrt', 'sigmoid'}
# the int32 input of these avoids 0 (a pole) and negatives (a NaN in f32 that
# the JAX op gives and torch's gives too, but not at every integer)
INT_POSITIVE = {'log', 'log10', 'log2', 'sqrt', 'arccosh', 'gamma', 'gammaln',
                'reciprocal', 'rcbrt', 'log1p', 'arcsin', 'arccos', 'arctanh'}


def _unary_input(name, dtype):
    if dtype != 'int32':
        return DOMAIN.get(name, lambda v: v)(X_F)
    if name in ('arcsin', 'arccos'):
        return np.clip(X_I, 0, 1)
    if name == 'arctanh':
        return np.zeros_like(X_I)
    return np.abs(X_I) + 1 if name in INT_POSITIVE else X_I


def _binary_inputs(name, pair):
    """lhs [3, 4, 5] against rhs [1, 4, 1] (broadcast), with a tie for the
    comparisons; rhs is non-zero for div and mod, and an integer power has
    a non-negative exponent."""
    lhs = X_F if pair[0] != 'int32' else X_I
    rhs = (X_F if pair[1] != 'int32' else X_I)[:1, :, :1].copy()
    rhs[0, 0, 0] = lhs[0, 0, 0]
    if name in ('broadcast_div', 'broadcast_mod'):
        rhs = np.where(rhs == 0, 3, rhs).astype(np.float32)
    if name == 'broadcast_power':
        rhs = np.abs(rhs) if pair[1] == 'int32' else np.round(rhs)
        lhs = np.abs(lhs) if pair[0] != 'int32' else lhs
    return [(lhs, pair[0]), (rhs, pair[1])]


def _scalar_input(name, dtype, scalar):
    x = X_F if dtype != 'int32' else X_I
    if name in ('_rdiv_scalar', '_rmod_scalar'):
        x = np.where(x == 0, 2, x).astype(np.float32)
    if name == '_rpower_scalar' or (name == '_power_scalar' and dtype == 'int32'):
        x = np.abs(x)
    elif name == '_power_scalar':
        x = np.abs(x) + 0.5
    return x


# reductions: each attr set on f32, bf16 and int32 (NaNs for the nan ops)
REDUCE_ATTRS = [{}, {'axis': 1}, {'axis': (0, 2)}, {'axis': 1, 'keepdims': True},
                {'axis': 1, 'exclude': True}, {'axis': (0, 1, 2), 'exclude': True}]
NORM_ATTRS = [{}, {'axis': 1}, {'axis': (0, 2), 'keepdims': True}, {'ord': 1},
              {'ord': 1, 'axis': 2}]
ARG_ATTRS = [{}, {'keepdims': True}, {'axis': 1}, {'axis': -1, 'keepdims': True}]


def _reduce_input(name, dtype):
    x = X_F if dtype != 'int32' else X_I
    if name.startswith('nan') and dtype != 'int32':
        x = x.copy()
        x[0, 1, :3] = np.nan
    if name in ('prod', 'nanprod'):
        x = x / 2 if dtype != 'int32' else np.clip(x, -2, 2)
    return x


def _cases():
    """(id, op name, attrs, [(numpy array, dtype)]) of every parity case."""
    out = []
    dtypes = ('float32', 'bfloat16', 'int32')
    for name in _canonical(ELEMWISE):
        op = jreg.get(name)
        if op.variadic:
            out.append(('%s-float32' % name, name, {'num_args': 3},
                        [(X_F * (i + 1), 'float32') for i in range(3)]))
        elif name == 'Cast':
            for src in dtypes:
                for dst in ('float16',) + dtypes:
                    out.append(('Cast-%s-%s' % (src, dst), name, {'dtype': dst},
                                [(X_F if src != 'int32' else X_I, src)]))
        elif op.input_names == ['lhs', 'rhs']:
            # same dtypes, and the promotions int32 x f32, bf16 x f32
            for pair in (('float32',) * 2, ('bfloat16',) * 2, ('int32',) * 2,
                         ('int32', 'float32'), ('bfloat16', 'float32')):
                out.append(('%s-%s-%s' % ((name,) + pair), name, {},
                            _binary_inputs(name, pair)))
        elif 'scalar' in op.param_defaults:
            # an int32 x casts 2.5 to 2 and -1.5 to -1 (the comparisons do
            # not); int32 x to the power -1 raises TypeError in both
            # packages (test_op_raises_where_jax_raises), (-1) ** x does not
            for dtype in dtypes:
                for scalar in (2.5, -1.5):
                    if (dtype, scalar, name) == ('int32', -1.5, '_power_scalar'):
                        continue
                    out.append(('%s-%s-%g' % (name, dtype, scalar), name,
                                {'scalar': scalar},
                                [(_scalar_input(name, dtype, scalar), dtype)]))
        else:
            for dtype in dtypes:
                if dtype == 'int32' and name in NO_INT:
                    continue
                out.append(('%s-%s' % (name, dtype), name, {},
                            [(_unary_input(name, dtype), dtype)]))
    for name in ('sum', 'mean', 'prod', 'nansum', 'nanprod', 'max', 'min'):
        for i, attrs in enumerate(REDUCE_ATTRS):
            for dtype in dtypes:
                out.append(('%s-%d-%s' % (name, i, dtype), name, attrs,
                            [(_reduce_input(name, dtype), dtype)]))
    for i, attrs in enumerate(NORM_ATTRS):
        for dtype in dtypes:
            out.append(('norm-%d-%s' % (i, dtype), 'norm', attrs,
                        [(X_F if dtype != 'int32' else X_I, dtype)]))
    for name in ('argmax', 'argmin'):
        for i, attrs in enumerate(ARG_ATTRS):
            for dtype in ('float32', 'int32'):      # int32 has ties: the first wins
                out.append(('%s-%d-%s' % (name, i, dtype), name, attrs,
                            [(X_F if dtype != 'int32' else X_I, dtype)]))
    x1 = X_F[:, :1, :]
    out += [('argmax_channel', 'argmax_channel', {}, [(X_F, 'float32')]),
            ('broadcast_axis', 'broadcast_axis', {'axis': 1, 'size': 4},
             [(x1, 'bfloat16')]),
            ('broadcast_axes', 'broadcast_axes', {'axis': (1,), 'size': (6,)},
             [(x1, 'int32')]),
            ('broadcast_to-0', 'broadcast_to', {'shape': (0, 4, 5)}, [(x1, 'float32')]),
            ('broadcast_to-new-axis', 'broadcast_to', {'shape': (2, 3, 4, 5)},
             [(x1, 'float32')]),
            ('broadcast_like', 'broadcast_like', {}, [(x1, 'float32'), (X_F, 'float32')])]
    return out


CASES = _cases()


@functools.lru_cache(maxsize=None)
def _jax_results():
    """Every case's JAX result, from one jitted program: one XLA compile for
    all of them, where an eager call compiles each op on its own."""
    def run(inputs):
        return [jreg.get(name).fn(dict(attrs), *xs)
                for (_, name, attrs, _), xs in zip(CASES, inputs)]
    inputs = [[_to_jax(a, d) for a, d in arrays] for *_, arrays in CASES]
    return [np.asarray(r) for r in jax.jit(run)(inputs)]


@pytest.mark.parametrize('case', range(len(CASES)), ids=[c[0] for c in CASES])
def test_op_matches_jax(case):
    """The port's registry op against the JAX op on the same inputs: the
    dtypes jnp gives with 64-bit types off (int32 sums stay int32, an int32
    mean is f32, comparisons give the lhs dtype, argmax gives f32), full
    reductions of shape (1,), floor-mod, jnp's rounding steps in bf16."""
    _, name, attrs, arrays = CASES[case]
    got = treg.get(name).fn(dict(attrs), *(_to_torch(a, d) for a, d in arrays))
    _compare(name, got, _jax_results()[case])


# Inputs on which the port once differed from the JAX package, each held
# exactly: equal values, NaN and signed-zero positions equal.
_EDGE_F = np.array([np.nan, -0.0, 0.0, -2.0, 27.0, -np.inf], np.float32)
_MOD_L = np.array([5, -5, 0, 7], np.float32)
_MOD_R = np.array([0, 0, 0, 3], np.float32)
EXACT_CASES = [
    ('sign-float32', 'sign', {}, [(_EDGE_F, 'float32')]),
    ('sign-bfloat16', 'sign', {}, [(_EDGE_F, 'bfloat16')]),
    ('mod-int32-by-0', 'broadcast_mod', {}, [(_MOD_L, 'int32'), (_MOD_R, 'int32')]),
    ('mod-float32-by-0', 'broadcast_mod', {}, [(_MOD_L, 'float32'), (_MOD_R, 'float32')]),
    ('mod_scalar-int32-0', '_mod_scalar', {'scalar': 0.0}, [(_MOD_L, 'int32')]),
    ('rmod_scalar-int32-0', '_rmod_scalar', {'scalar': 7.0}, [(_MOD_R, 'int32')]),
    ('softmax-int32', 'softmax', {}, [(_MOD_L, 'int32')]),
    ('cbrt-float32', 'cbrt', {}, [(_EDGE_F, 'float32')]),
    ('cbrt-bfloat16', 'cbrt', {}, [(_EDGE_F, 'bfloat16')]),
    ('rcbrt-float32', 'rcbrt', {}, [(_EDGE_F, 'float32')]),
]


def _exact(got, want, what):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if want.dtype.kind == 'f' or want.dtype == ml_dtypes.bfloat16:
        got, want = got.astype(np.float32), want.astype(np.float32)
        num = ~np.isnan(want)          # a NaN's sign bit carries nothing
        np.testing.assert_array_equal(np.signbit(got[num]), np.signbit(want[num]),
                                      what)
    np.testing.assert_array_equal(got, want, what)   # NaN where NaN


@pytest.mark.parametrize('case', EXACT_CASES, ids=[c[0] for c in EXACT_CASES])
def test_edge_inputs_match_jax_exactly(monkeypatch, case):
    """sign of NaN and -0.0, integer mod by zero (0, as jnp.mod gives),
    softmax of int32 (f32), cbrt and rcbrt of -0.0 (-0.0 and -inf)."""
    monkeypatch.setenv('MXTPU_FORCE_PALLAS', '0')
    _, name, attrs, arrays = case
    got = treg.get(name).fn(dict(attrs), *(_to_torch(a, d) for a, d in arrays))
    want = jax.jit(lambda *xs: jreg.get(name).fn(dict(attrs), *xs))(
        *(_to_jax(a, d) for a, d in arrays))
    _exact(got, want, name)


RAISES = [('rsqrt-int32', 'rsqrt', {}), ('sigmoid-int32', 'sigmoid', {}),
          ('_power_scalar-int32--1.5', '_power_scalar', {'scalar': -1.5})]


@pytest.mark.parametrize('case', RAISES, ids=[c[0] for c in RAISES])
def test_op_raises_where_jax_raises(case):
    """rsqrt and sigmoid of int32, and int32 to a negative power (-1.5 cast
    to -1), raise TypeError in both packages."""
    _, name, attrs = case
    x = np.array([1, 2, 3, 4], np.float32)
    with pytest.raises(TypeError):
        jreg.get(name).fn(dict(attrs), _to_jax(x, 'int32'))
    with pytest.raises(TypeError):
        treg.get(name).fn(dict(attrs), _to_torch(x, 'int32'))


def test_mod_by_zero_through_the_dunders():
    """NDArray % and the reflected % on int32 with zero divisors."""
    def steps(lhs, rhs):
        return [lhs % rhs, lhs % 0, 7 % rhs]
    got = steps(nd.array(_MOD_L, ctx=cpu(), dtype='int32'),
                nd.array(_MOD_R, ctx=cpu(), dtype='int32'))
    want = _mx_jitted(lambda xs: steps(*xs[0]), [[
        mx.nd.array(_MOD_L, ctx=mx.cpu(), dtype='int32'),
        mx.nd.array(_MOD_R, ctx=mx.cpu(), dtype='int32')]])
    for g, w in zip(got, want):
        _exact(g.asnumpy(), w.asnumpy(), 'mod')


def test_traps():
    """cbrt keeps the sign (jnp.cbrt(-8) = -2, where a power 1/3 is NaN);
    gamma is exp(gammaln) and has no sign; int32 + 2.5 is int32 + 2 while
    int32 > 2.5 compares with 2.5; mod takes the divisor's sign."""
    x = np.array([-8.0, -1.0, 0.0, 27.0, 0.001], np.float32)
    got = treg.get('cbrt').fn({}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.cbrt(x), rtol=1e-6)
    g = treg.get('gamma').fn({}, torch.tensor([-2.5, -0.5, 0.5, 4.0]))
    np.testing.assert_allclose(g.numpy(), [0.9453087, 3.5449078, 1.7724539, 6.0],
                               rtol=2e-6)
    xi = torch.tensor([1, 2, 3, -7], dtype=torch.int32)
    got = treg.get('_plus_scalar').fn({'scalar': 2.5}, xi)
    assert got.dtype == torch.int32 and got.tolist() == [3, 4, 5, -5]
    got = treg.get('_greater_scalar').fn({'scalar': 2.5}, xi)
    assert got.dtype == torch.int32 and got.tolist() == [0, 0, 1, 0]
    for dtype in (torch.float32, torch.int32):
        got = treg.get('broadcast_mod').fn({}, torch.tensor([-7, 7, -7, 7], dtype=dtype),
                                           torch.tensor([3, -3, -3, 3], dtype=dtype))
        assert got.tolist() == [2, -2, -1, 1]
    s = treg.get('sum').fn({}, xi)
    m = treg.get('mean').fn({'axis': 0}, xi)
    assert s.dtype == torch.int32 and s.shape == (1,) and m.dtype == torch.float32


def test_add_n_through_nd():
    arrays = [X_F * (i + 1) for i in range(3)]
    _compare('add_n', nd.add_n(*(nd.array(a, ctx=cpu()) for a in arrays)).asnumpy(),
             mx.nd.add_n(*(mx.nd.array(a, ctx=mx.cpu()) for a in arrays)).asnumpy())


# ---------------------------------------------------------------------------
# the NDArray surface against mxnet_tpu.nd
# ---------------------------------------------------------------------------

def _both(a, dtype=None):
    return (nd.array(a, ctx=cpu(), dtype=dtype),
            mx.nd.array(a, ctx=mx.cpu(), dtype=dtype))


def _same(got, want, name='nd'):
    _compare(name, got.asnumpy(), want.asnumpy())
    assert got.shape == want.shape and got.dtype == want.dtype


# (label, f(x, y)): x [3, 4, 5], y [1, 4, 5] non-zero
DUNDERS = [
    ('x+y', lambda x, y: x + y), ('x-y', lambda x, y: x - y),
    ('x*y', lambda x, y: x * y), ('x/y', lambda x, y: x / y),
    ('x%y', lambda x, y: x % y), ('x+2.5', lambda x, y: x + 2.5),
    ('2.5+x', lambda x, y: 2.5 + x), ('x-1.5', lambda x, y: x - 1.5),
    ('3-x', lambda x, y: 3 - x), ('x*2', lambda x, y: x * 2),
    ('2*x', lambda x, y: 2 * x), ('x/4', lambda x, y: x / 4.0),
    ('6/y', lambda x, y: 6.0 / y), ('x%3', lambda x, y: x % 3),
    ('7%y', lambda x, y: 7 % y), ('y**2', lambda x, y: y ** 2),
    ('2**y', lambda x, y: 2 ** y), ('y**y', lambda x, y: y ** y),
    ('-x', lambda x, y: -x), ('abs', lambda x, y: abs(x)),
    ('x==y', lambda x, y: x == y), ('x!=0', lambda x, y: x != 0),
    ('x>y', lambda x, y: x > y), ('x>=1', lambda x, y: x >= 1),
    ('x<y', lambda x, y: x < y), ('x<=1.5', lambda x, y: x <= 1.5),
    ('sum', lambda x, y: x.sum()), ('mean', lambda x, y: x.mean(axis=1)),
    ('max', lambda x, y: x.max(axis=(0, 2))),
    ('argmax', lambda x, y: x.argmax(axis=2)), ('norm', lambda x, y: x.norm()),
    ('sqrt', lambda x, y: abs(x).sqrt()), ('square', lambda x, y: x.square()),
    ('broadcast_to', lambda x, y: x.broadcast_to((2, 3, 4, 5))),
    ('+=', lambda x, y: x.__iadd__(y)), ('-=', lambda x, y: x.__isub__(2)),
    ('*=', lambda x, y: x.__imul__(y)), ('/=', lambda x, y: x.__itruediv__(2.0)),
]
# int32 and bf16: the dunders whose dtype rules differ from f32's (the
# scalar cast to x's dtype, int division to f32, comparisons in x's dtype)
NARROW = ('x+y', 'x/y', 'x%y', 'x+2.5', '3-x', 'x/4', '6/y', '7%y', 'x>=1',
          'x<=1.5', 'sum', 'mean', '+=', '/=')


DUNDER_CASES = ([('float32', d[0]) for d in DUNDERS]
                + [(t, d) for t in ('int32', 'bfloat16') for d in NARROW])


def _dunder_inputs(dtype):
    a = X_F if dtype != 'int32' else X_I
    return a, (np.abs(X_F) + 1 if dtype != 'int32' else np.abs(X_I) + 1)[:1]


def _mx_jitted(run, inputs):
    """``run`` over NDArrays of ``inputs`` (lists of mx NDArrays), in one
    jitted program: each mx.nd op then traces into it, where an eager call
    compiles each op on its own. Returns the results as mx NDArrays."""
    def traced(datas):
        outs = run([[mx.nd.NDArray(d, mx.cpu()) for d in ds] for ds in datas])
        return [o._data for o in outs]
    datas = [[x._data for x in xs] for xs in inputs]
    return [mx.nd.NDArray(r, mx.cpu()) for r in jax.jit(traced)(datas)]


@functools.lru_cache(maxsize=None)
def _mx_dunder_results():
    """Every dunder case's mx.nd result."""
    def run(arrays):
        return [dict(DUNDERS)[label](x, y)
                for (_, label), (x, y) in zip(DUNDER_CASES, arrays)]
    return _mx_jitted(run, [[mx.nd.array(v, ctx=mx.cpu(), dtype=dtype)
                             for v in _dunder_inputs(dtype)]
                            for dtype, _ in DUNDER_CASES])


@pytest.mark.parametrize('dtype,label', DUNDER_CASES)
def test_dunders_match_mx_nd(dtype, label):
    ta, tb = (nd.array(v, ctx=cpu(), dtype=dtype) for v in _dunder_inputs(dtype))
    got = dict(DUNDERS)[label](ta, tb)
    if label.endswith('='):
        assert got is ta
    _same(got, _mx_dunder_results()[DUNDER_CASES.index((dtype, label))], label)


_BASE = np.arange(24, dtype=np.float32).reshape(4, 6)
_IDX = np.array([0, -1, 9, 2, -20], np.int32)
READS = [np.s_[1:3], np.s_[2], np.s_[:, 1::2], np.s_[-1, :3], np.s_[..., 4],
         (_IDX,), (slice(None), _IDX), (np.array([1, 3]), np.array([0, 5])),
         np.s_[None, 1]]
WRITES = [(np.s_[1:3], 7.0), (np.s_[2], np.arange(6, dtype=np.float32)),
          (np.s_[:, 0], -1), ((_IDX,), 5.0), ((slice(None), _IDX), 3.5),
          ((np.array([0, 5]), np.array([2, 1])), 9.0), (None, 2.0),
          (slice(None), np.arange(6, dtype=np.float32))]
# negative steps, on arange(60) [3, 4, 5]: reads, then writes of a scalar
# and of an array in the order the slice walks
_X60 = np.arange(60, dtype=np.float32).reshape(3, 4, 5)
STEP_READS = [np.s_[::-1], np.s_[1:, ::-2, ::2], np.s_[:, 10:0:-3],
              np.s_[5:-10:-1], np.s_[::-1, np.array([0, -1])],
              np.s_[..., ::-2], np.s_[2:2:-1]]
STEP_WRITES = [(np.s_[::-1], 7.0),
               (np.s_[::-2, 1], np.arange(10, dtype=np.float32).reshape(2, 5)),
               (np.s_[:, ::-1, np.array([4, 0])],
                np.arange(24, dtype=np.float32).reshape(3, 4, 2))]


def _index_steps(base, base_int, key_nd, value_nd):
    """The reads and writes of the indexing test on NDArrays of either
    package: base [4, 6] f32 and int32, an NDArray key and value."""
    out = [base[key] for key in READS] + [base[key_nd]]
    for key, value in WRITES:
        b = base.copy()
        b[key] = value
        out.append(b)
    base_int[0] = 2.7                            # cast to the int dtype first
    b = base.copy()
    b[1] = value_nd
    return out + [base_int, b]


def test_setitem_getitem_match_mx_nd():
    """Slices, ints, integer arrays (negative and out of range: clamped on
    a read, dropped on a write), a scalar and an NDArray value, and a
    broadcast fill, against mxnet_tpu.nd."""
    four = np.ones(6, np.float32) * 4
    got = _index_steps(nd.array(_BASE, ctx=cpu()),
                       nd.array(_BASE, ctx=cpu(), dtype='int32'),
                       nd.array(_IDX, ctx=cpu()), nd.array(four, ctx=cpu()))
    want = _mx_jitted(lambda xs: _index_steps(*xs[0]), [[
        mx.nd.array(_BASE, ctx=mx.cpu()),
        mx.nd.array(_BASE, ctx=mx.cpu(), dtype='int32'),
        mx.nd.array(_IDX, ctx=mx.cpu()), mx.nd.array(four, ctx=mx.cpu())]])
    labels = (['read %r' % (k,) for k in READS] + ['read NDArray key']
              + ['write %r' % (k,) for k, _ in WRITES] + ['int write', 'NDArray value'])
    assert len(got) == len(want) == len(labels)
    for g, w, label in zip(got, want, labels):
        _same(g, w, label)


def _step_indexing(x):
    out = [x[key] for key in STEP_READS]
    for key, value in STEP_WRITES:
        b = x.copy()
        b[key] = value
        out.append(b)
    return out


def test_negative_step_slices_match_mx_nd():
    """Negative-step slices read and write as in mxnet_tpu.nd, exactly."""
    got = _step_indexing(nd.array(_X60, ctx=cpu()))
    want = _mx_jitted(lambda xs: _step_indexing(xs[0][0]),
                      [[mx.nd.array(_X60, ctx=mx.cpu())]])
    labels = (['read %r' % (k,) for k in STEP_READS]
              + ['write %r' % (k,) for k, _ in STEP_WRITES])
    assert len(got) == len(want) == len(labels)
    for g, w, label in zip(got, want, labels):
        assert g.shape == w.shape, label
        _exact(g.asnumpy(), w.asnumpy(), label)


def test_writes_do_not_reach_other_ndarrays():
    """__setitem__ is a functional update: an NDArray that shares storage
    (a reshape, a slice read earlier) does not see the write."""
    a = nd.array(np.arange(6, dtype=np.float32), ctx=cpu())
    b = a.reshape((2, 3))
    s = a[1:4]
    b[0] = 100.0
    b[:] = b + 1
    a[2] = -1.0
    np.testing.assert_array_equal(a.asnumpy(), [0, 1, -1, 3, 4, 5])
    np.testing.assert_array_equal(s.asnumpy(), [1, 2, 3])
    np.testing.assert_array_equal(b.asnumpy(), [[101] * 3, [4, 5, 6]])
    s[0] = 42.0
    np.testing.assert_array_equal(a.asnumpy(), [0, 1, -1, 3, 4, 5])


def test_arange_moveaxis_waitall_match_mx_nd():
    for args in ((5,), (1, 7, 2), (0, 2, 0.5), (3,)):
        _same(nd.arange(*args, ctx=cpu()), mx.nd.arange(*args, ctx=mx.cpu()))
    _same(nd.arange(0, 4, repeat=2, ctx=cpu(), dtype='int32'),
          mx.nd.arange(0, 4, repeat=2, ctx=mx.cpu(), dtype='int32'))
    _same(nd.arange(0, 3, 0.5, ctx=cpu(), dtype='bfloat16'),
          mx.nd.arange(0, 3, 0.5, ctx=mx.cpu(), dtype='bfloat16'))
    t, j = _both(X_F)
    _same(nd.moveaxis(t, 0, 2), mx.nd.moveaxis(j, 0, 2))
    assert nd.waitall() is None and mx.nd.waitall() is None


def test_slice_op_and_method_forms():
    t, j = _both(X_F)
    key = (slice(0, 2), np.array([1, 3]))
    frozen = nd.ndarray._freeze_key(key)
    assert hash(frozen) is not None
    _same(nd.invoke('_slice_like_getitem', [t], {'key': frozen}),
          mx.nd.ndarray.invoke('_slice_like_getitem', [j],
                               {'key': mx.nd.ndarray._freeze_key(key)}))
    for name in ('exp', 'relu', 'sigmoid', 'softmax', 'zeros_like', 'floor'):
        _same(getattr(t, name)(), getattr(j, name)(), name)
    _same(t.sum(axis=(0, 2), keepdims=True), j.sum(axis=(0, 2), keepdims=True))
    _same(nd.broadcast_add(t, t[:1]), mx.nd.broadcast_add(j, j[:1]))
    _same(nd.smooth_l1(t, scalar=2.0), mx.nd.smooth_l1(j, scalar=2.0))
