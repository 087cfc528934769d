"""Linear algebra and ordering ops: the counterpart of
``mxnet_tpu/ops/linalg_sort.py``, registered under the same names, aliases,
input names and parameter defaults.

The JAX package leaves all of them to XLA (no Pallas kernel); here the
products are torch's matmul (cuBLAS on the card), the factorizations
``torch.linalg`` (cuSOLVER on the card) and the orderings a stable sort, with
the JAX ops' rules where torch's differ:

- ``dot`` contracts ``lhs``'s last axis with ``rhs``'s first (a tensordot,
  not matmul's batch rule), and ``transpose_a``/``transpose_b`` reverse all
  axes of an N-d operand. ``dot`` and ``batch_dot`` accumulate in f32 and
  cast to ``lhs``'s dtype: integers are multiplied in f32 (cuBLAS has no
  integer product) and cast back saturating, as XLA casts;
- ``sort`` and ``argsort`` follow ``jnp.sort``: stable, NaN last whatever
  its sign, -0 equal to 0; descending is the ascending order flipped (ties
  then come out in reverse index order). ``topk`` follows ``lax.top_k``:
  the total order of the bits (-NaN < -inf < -0 < 0 < inf < NaN), ties in
  index order. Both sort integer keys made from the bits
  (:func:`_order_key`), so that the order does not depend on the device's
  sort of floats; ``argsort`` and ``topk`` give f32 indices;
- ``_linalg_potrf`` gives NaN in the lower triangle for a matrix that is
  not positive definite, where torch's Cholesky raises.
"""
import torch

from .registry import register, register_alias

_INT_KEY = {torch.float16: torch.int16, torch.bfloat16: torch.int16,
            torch.float32: torch.int32, torch.float64: torch.int64}


def _cast(y, dtype):
    """``y`` as ``astype(dtype)`` gives it: a float cast to an integer type
    saturates, as XLA's does."""
    if dtype.is_floating_point or dtype == torch.bool \
            or not y.is_floating_point():
        return y.to(dtype)
    info = torch.iinfo(dtype)
    # the bounds compare in y's type, where info.max may round up to a
    # power of two that the integer type cannot hold
    out = y.clamp(info.min, info.max).to(dtype)
    out = torch.where(y >= info.max, torch.full_like(out, info.max), out)
    return torch.where(y <= info.min, torch.full_like(out, info.min), out)


def _f32_product(fn, a, b):
    """``fn(a, b)`` accumulated in f32 (at least) and cast to ``a``'s dtype,
    as ``preferred_element_type=float32`` then ``astype`` gives it. Two
    half-precision operands of one type go to the library's product in that
    type, which accumulates in f32; integers are multiplied in f32."""
    ct = torch.promote_types(a.dtype, b.dtype)
    if not ct.is_floating_point:
        ct = torch.float32
    return _cast(fn(a.to(ct), b.to(ct)), a.dtype)


def _reverse_axes(x):
    return x.permute(*reversed(range(x.dim())))


@register('dot', input_names=['lhs', 'rhs'],
          param_defaults={'transpose_a': False, 'transpose_b': False})
def _dot(attrs, lhs, rhs):
    a = _reverse_axes(lhs) if attrs.get('transpose_a', False) else lhs
    b = _reverse_axes(rhs) if attrs.get('transpose_b', False) else rhs
    return _f32_product(
        lambda x, y: torch.tensordot(x, y, dims=([x.dim() - 1], [0])), a, b)


@register('batch_dot', input_names=['lhs', 'rhs'],
          param_defaults={'transpose_a': False, 'transpose_b': False})
def _batch_dot(attrs, lhs, rhs):
    a = lhs.transpose(-1, -2) if attrs.get('transpose_a', False) else lhs
    b = rhs.transpose(-1, -2) if attrs.get('transpose_b', False) else rhs
    return _f32_product(torch.matmul, a, b)


@register('khatri_rao', variadic=True, key_var_num_args='num_args')
def _khatri_rao(attrs, *mats):
    """The column-wise Kronecker product."""
    out = mats[0]
    for m in mats[1:]:
        out = torch.einsum('ik,jk->ijk', out, m).reshape(-1, out.shape[1])
    return out


# ---------------------------------------------------------------------------
# the linalg_* family: batched over the leading axes of trailing matrices
# ---------------------------------------------------------------------------

def _t(x, flag):
    return x.transpose(-1, -2) if flag else x


@register('_linalg_gemm', input_names=['A', 'B', 'C'],
          param_defaults={'transpose_a': False, 'transpose_b': False,
                          'alpha': 1.0, 'beta': 1.0, 'axis': -2})
def _linalg_gemm(attrs, A, B, C):
    return (attrs.get('alpha', 1.0)
            * torch.matmul(_t(A, attrs.get('transpose_a', False)),
                           _t(B, attrs.get('transpose_b', False)))
            + attrs.get('beta', 1.0) * C)


@register('_linalg_gemm2', input_names=['A', 'B'],
          param_defaults={'transpose_a': False, 'transpose_b': False,
                          'alpha': 1.0})
def _linalg_gemm2(attrs, A, B):
    return attrs.get('alpha', 1.0) * torch.matmul(
        _t(A, attrs.get('transpose_a', False)),
        _t(B, attrs.get('transpose_b', False)))


@register('_linalg_potrf')
def _linalg_potrf(attrs, A):
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(L, float('nan')).tril(), L)


@register('_linalg_potri')
def _linalg_potri(attrs, A):
    """The inverse of ``L Lᵀ`` from its Cholesky factor ``L``."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(
        A.shape)
    Linv = torch.linalg.solve_triangular(A, eye, upper=False)
    return torch.matmul(Linv.transpose(-1, -2), Linv)


@register('_linalg_trsm', input_names=['A', 'B'],
          param_defaults={'transpose': False, 'rightside': False,
                          'alpha': 1.0, 'lower': True})
def _linalg_trsm(attrs, A, B):
    t = attrs.get('transpose', False)
    lower = attrs.get('lower', True)
    lo = (not lower) if t else lower
    sol = torch.linalg.solve_triangular(
        _t(A, t), B, upper=not lo, left=not attrs.get('rightside', False))
    return attrs.get('alpha', 1.0) * sol


@register('_linalg_trmm', input_names=['A', 'B'],
          param_defaults={'transpose': False, 'rightside': False,
                          'alpha': 1.0, 'lower': True})
def _linalg_trmm(attrs, A, B):
    t = attrs.get('transpose', False)
    a = _t(A, t)
    tri = torch.tril(a) if attrs.get('lower', True) != t else torch.triu(a)
    if attrs.get('rightside', False):
        return attrs.get('alpha', 1.0) * torch.matmul(B, tri)
    return attrs.get('alpha', 1.0) * torch.matmul(tri, B)


@register('_linalg_syrk', param_defaults={'transpose': False, 'alpha': 1.0})
def _linalg_syrk(attrs, A):
    a = _t(A, attrs.get('transpose', False))
    return attrs.get('alpha', 1.0) * torch.matmul(a, a.transpose(-1, -2))


@register('_linalg_sumlogdiag')
def _linalg_sumlogdiag(attrs, A):
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(-1)


@register('_linalg_gelqf', num_outputs=2)
def _linalg_gelqf(attrs, A):
    """The LQ factorization ``A = L Q``, Q with orthonormal rows, as
    ``[Q, L]``: the QR factorization of ``Aᵀ``, transposed."""
    q, r = torch.linalg.qr(A.transpose(-1, -2))
    return q.transpose(-1, -2), r.transpose(-1, -2)


for _name in ('gemm', 'gemm2', 'potrf', 'potri', 'trsm', 'trmm', 'syrk',
              'sumlogdiag', 'gelqf'):
    register_alias('linalg_' + _name, '_linalg_' + _name)
del _name


# ---------------------------------------------------------------------------
# orderings
# ---------------------------------------------------------------------------

def _order_key(x, total):
    """An integer tensor that orders as ``x``: with ``total``, the total
    order of the bits (lax.top_k's); else jnp.sort's, every NaN last and
    -0 equal to 0. Integer ``x`` is its own key."""
    kt = _INT_KEY.get(x.dtype)
    if kt is None:
        return x
    if not total:
        x = torch.where(torch.isnan(x), torch.full_like(x, float('nan')),
                        torch.where(x == 0, torch.zeros_like(x), x))
    bits = x.contiguous().view(kt)
    # a negative float orders backwards in its bits: flip all but the sign
    return torch.where(bits < 0, bits ^ torch.iinfo(kt).max, bits)


def _ordering_axis(attrs, x):
    ax = attrs.get('axis', -1)
    if ax is None:
        return x.reshape(-1), 0
    return x, int(ax) % max(x.dim(), 1)


def _argsort_along(x, ax, ascend):
    """jnp.argsort along ``ax`` (stable, NaN last), flipped if not
    ``ascend``."""
    idx = torch.sort(_order_key(x, False), dim=ax, stable=True)[1]
    return idx if ascend else idx.flip(ax)


@register('sort', param_defaults={'axis': -1, 'is_ascend': True})
def _sort(attrs, x):
    x, ax = _ordering_axis(attrs, x)
    return torch.gather(x, ax, _argsort_along(x, ax,
                                              attrs.get('is_ascend', True)))


@register('argsort', param_defaults={'axis': -1, 'is_ascend': True,
                                     'dtype': 'float32'},
          differentiable=False)
def _argsort(attrs, x):
    x, ax = _ordering_axis(attrs, x)
    return _argsort_along(x, ax, attrs.get('is_ascend', True)).float()


def _topk_num_outputs(attrs):
    return 2 if attrs.get('ret_typ', 'indices') == 'both' else 1


@register('topk', num_outputs=_topk_num_outputs, differentiable=False,
          param_defaults={'axis': -1, 'k': 1, 'ret_typ': 'indices',
                          'is_ascend': False, 'dtype': 'float32'})
def _topk(attrs, x):
    x, ax = _ordering_axis(attrs, x)
    k = int(attrs.get('k', 1))
    n = x.shape[ax]
    if k > n:
        raise ValueError('k argument to top_k must be no larger than size '
                         'along axis; got k=%d with shape=%s and axis=%d'
                         % (k, list(x.shape), ax))
    idx = torch.sort(_order_key(x, True), dim=ax, stable=True,
                     descending=not attrs.get('is_ascend', False))[1]
    idx = idx.narrow(ax, 0, k)
    ret = attrs.get('ret_typ', 'indices')
    if ret == 'value':
        return torch.gather(x, ax, idx)
    if ret == 'both':
        return torch.gather(x, ax, idx), idx.float()
    if ret == 'mask':
        return torch.zeros_like(x).scatter(ax, idx, 1)
    return idx.float()
