"""Elementwise unary, binary, scalar and comparison ops: the counterpart of
``mxnet_tpu/ops/elemwise.py``, registered under the same names and aliases.

The JAX package leaves these to XLA; here they are plain torch ops. Each
gives the dtype that the jnp op gives with 64-bit types off:

- a scalar op casts its scalar to x's dtype first (``int32 + 2.5`` is
  ``int32 + 2``); a scalar comparison does not (``int32 > 2.5`` compares
  with 2.5);
- comparisons and the logical ops return the lhs dtype, not bool;
- a float-valued op of an integer x gives float32 (``jnp.sqrt``), and so
  does a quotient of integers;
- mod is floor-mod (``jnp.mod``, ``torch.remainder``), and an integer mod
  by zero gives 0; cbrt keeps the sign of a negative x and of -0.0; sign
  of NaN is NaN; gamma is ``exp(gammaln(x))`` and has no sign;
- where jnp raises ``TypeError`` (``rsqrt`` and ``sigmoid`` of an integer
  x, an integer x to a negative power), so does the port.
"""
import torch

from ..base import dtype_of, torch_dtype
from .registry import register, register_alias


def _inexact(x):
    """x in its own float dtype, or float32 for an integer x (jnp's
    promotion of an integer input to a float-valued op)."""
    return x if x.is_floating_point() else x.to(torch.float32)


def _cbrt(x):
    x = _inexact(x)
    xf = x.float()
    # copysign keeps -0.0 (and so rcbrt's -inf), as jnp.cbrt does
    return torch.copysign(xf.abs().pow(1.0 / 3.0), xf).to(x.dtype)


def _sign(x):
    # torch.sign gives 0 for NaN and +0 for -0.0; jnp.sign gives x for both
    if not x.is_floating_point():
        return torch.sign(x)
    return torch.where(torch.isnan(x) | (x == 0), x, torch.sign(x))


def _float_only(name, f):
    """``f`` for a float x; TypeError for an integer x, as jnp raises."""
    def op(x):
        if not x.is_floating_point():
            raise TypeError('%s does not accept dtype %s'
                            % (name, dtype_of(x.dtype)))
        return f(x)
    return op


def _mod(a, b):
    """jnp.mod: floor-mod; an integer mod by zero gives 0, where
    torch.remainder raises (and faults on the card)."""
    if torch.promote_types(a.dtype, b.dtype).is_floating_point:
        return torch.remainder(a, b)
    zero = b == 0
    return torch.remainder(a, b.masked_fill(zero, 1)).masked_fill(zero, 0)


def _power_scalar(x, s):
    if not x.is_floating_point() and s < 0:
        raise TypeError('Integers cannot be raised to negative powers, got '
                        '%s to the power %d' % (dtype_of(x.dtype), int(s)))
    return torch.pow(x, s)


def _log2(x):
    # jnp.log2 is log(x) / log(2) in x's dtype (two roundings in bf16)
    x = _inexact(x)
    return torch.log(x) / torch.log(torch.tensor(2.0, dtype=x.dtype))


def _log10(x):
    # jnp.log10 is log(x) * (1 / log(10) rounded to x's dtype)
    x = _inexact(x)
    return torch.log(x) * torch.tensor(0.4342944819032518, dtype=x.dtype)


def _u(name, f, aliases=()):
    @register(name)
    def op(attrs, x, _f=f):
        return _f(x)
    for a in aliases:
        register_alias(a, name)
    return op


def _float_op(f):
    return lambda x: f(_inexact(x))


# unary math (reference elemwise_unary_op.cc registration list)
_u('abs', torch.abs)
_u('sign', _sign)
_u('round', torch.round)
_u('rint', _float_op(torch.round))
_u('ceil', torch.ceil)
_u('floor', torch.floor)
_u('trunc', torch.trunc)
_u('fix', torch.trunc)
_u('square', torch.square)
_u('sqrt', _float_op(torch.sqrt))
_u('rsqrt', _float_only('rsqrt', torch.rsqrt))
_u('cbrt', _cbrt)
_u('rcbrt', lambda x: 1.0 / _cbrt(x))
_u('exp', _float_op(torch.exp))
_u('log', _float_op(torch.log))
_u('log10', _log10)
_u('log2', _log2)
_u('log1p', _float_op(torch.log1p))
_u('expm1', _float_op(torch.expm1))
_u('sin', _float_op(torch.sin))
_u('cos', _float_op(torch.cos))
_u('tan', _float_op(torch.tan))
_u('arcsin', _float_op(torch.arcsin))
_u('arccos', _float_op(torch.arccos))
_u('arctan', _float_op(torch.arctan))
_u('sinh', _float_op(torch.sinh))
_u('cosh', _float_op(torch.cosh))
_u('tanh', _float_op(torch.tanh))
_u('arcsinh', _float_op(torch.arcsinh))
_u('arccosh', _float_op(torch.arccosh))
_u('arctanh', _float_op(torch.arctanh))
_u('degrees', _float_op(torch.rad2deg))
_u('radians', _float_op(torch.deg2rad))
_u('negative', torch.negative)
_u('reciprocal', lambda x: 1.0 / x)
_u('sigmoid', _float_only('sigmoid', torch.sigmoid))
_u('softsign', lambda x: x / (1.0 + torch.abs(x)))
_u('relu', torch.relu)
_u('erf', _float_op(torch.special.erf))
_u('gamma', _float_op(lambda x: torch.exp(torch.lgamma(x))))
_u('gammaln', _float_op(torch.lgamma))
_u('logical_not', lambda x: (x == 0).to(x.dtype))
_u('zeros_like', torch.zeros_like)
_u('ones_like', torch.ones_like)
_u('identity', lambda x: x, aliases=('_copy', 'stop_gradient_off'))
register_alias('_identity_with_attr_like_rhs', 'identity')


@register('BlockGrad')
def _block_grad(attrs, x):
    """Reference: elemwise_unary_op.cc BlockGrad / stop_gradient."""
    return x.detach()


register_alias('stop_gradient', 'BlockGrad')


@register('Cast')
def _cast(attrs, x):
    return x.to(torch_dtype(attrs['dtype']))


register_alias('cast', 'Cast')


# binary broadcast family (reference elemwise_binary_broadcast_op_basic.cc)
def _b(name, f, elem_alias=None):
    @register(name, input_names=['lhs', 'rhs'])
    def op(attrs, lhs, rhs, _f=f):
        return _f(lhs, rhs)
    if elem_alias:
        register_alias(elem_alias, name)
    return op


def _hypot(a, b):
    """jnp.hypot's formula, a * sqrt(1 + (b / a)**2) with a = max(|x|, |y|),
    step by step in the promoted float dtype (as jnp rounds it in bf16)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    dt = dt if dt.is_floating_point else torch.float32
    a, b = torch.abs(a.to(dt)), torch.abs(b.to(dt))
    inf = torch.isposinf(a) | torch.isposinf(b)
    a, b = torch.maximum(a, b), torch.minimum(a, b)
    zero = a == 0
    x = torch.where(zero, a, a * torch.sqrt(
        1 + torch.square(b / torch.where(zero, torch.ones_like(a), a))))
    return x.masked_fill(inf, float('inf'))


_b('broadcast_add', torch.add, elem_alias='elemwise_add')
register_alias('_plus', 'broadcast_add')
register_alias('_add', 'broadcast_add')
_b('broadcast_sub', torch.sub, elem_alias='elemwise_sub')
register_alias('_minus', 'broadcast_sub')
register_alias('_sub', 'broadcast_sub')
_b('broadcast_mul', torch.mul, elem_alias='elemwise_mul')
register_alias('_mul', 'broadcast_mul')
_b('broadcast_div', torch.true_divide, elem_alias='elemwise_div')
register_alias('_div', 'broadcast_div')
register_alias('_grad_add', 'broadcast_add')
_b('broadcast_mod', _mod)
register_alias('_mod', 'broadcast_mod')
_b('broadcast_power', torch.pow)
register_alias('_power', 'broadcast_power')
register_alias('pow', 'broadcast_power')
_b('broadcast_maximum', torch.maximum)
_b('broadcast_minimum', torch.minimum)
_b('broadcast_hypot', _hypot)
register_alias('_hypot', 'broadcast_hypot')
_b('_maximum', torch.maximum)
_b('_minimum', torch.minimum)


def _cmp(name, f):
    @register(name, input_names=['lhs', 'rhs'])
    def op(attrs, lhs, rhs, _f=f):
        return _f(lhs, rhs).to(lhs.dtype)
    return op


_cmp('broadcast_equal', torch.eq)
_cmp('broadcast_not_equal', torch.ne)
_cmp('broadcast_greater', torch.gt)
_cmp('broadcast_greater_equal', torch.ge)
_cmp('broadcast_lesser', torch.lt)
_cmp('broadcast_lesser_equal', torch.le)
# same-shape elemwise comparison registrations (reference
# elemwise_binary_op_logic.cc); broadcasting is a superset of them
for _elem in ('equal', 'not_equal', 'greater', 'greater_equal',
              'lesser', 'lesser_equal'):
    register_alias('_' + _elem, 'broadcast_' + _elem)
_cmp('broadcast_logical_and', lambda a, b: (a != 0) & (b != 0))
_cmp('broadcast_logical_or', lambda a, b: (a != 0) | (b != 0))
_cmp('broadcast_logical_xor', lambda a, b: (a != 0) ^ (b != 0))


# scalar family (reference elemwise_binary_scalar_op_basic.cc): the scalar
# is cast to x's dtype before the op, as jnp.asarray(scalar, x.dtype) does.
# It stays a 0-d host tensor, which torch takes beside a CUDA x without a
# copy to the card.
def _s(name, f):
    @register(name, param_defaults={'scalar': 0.0})
    def op(attrs, x, _f=f):
        return _f(x, torch.tensor(attrs['scalar'], dtype=x.dtype))
    return op


_s('_plus_scalar', torch.add)
_s('_minus_scalar', torch.sub)
_s('_rminus_scalar', lambda x, s: s - x)
_s('_mul_scalar', torch.mul)
_s('_div_scalar', torch.true_divide)
_s('_rdiv_scalar', lambda x, s: torch.true_divide(s, x))
_s('_mod_scalar', _mod)
_s('_rmod_scalar', lambda x, s: _mod(s, x))
_s('_power_scalar', _power_scalar)
_s('_rpower_scalar', lambda x, s: torch.pow(s, x))
_s('_maximum_scalar', torch.maximum)
_s('_minimum_scalar', torch.minimum)
_s('_hypot_scalar', _hypot)


def _scmp(name, f):
    @register(name, param_defaults={'scalar': 0.0})
    def op(attrs, x, _f=f):
        return _f(x, attrs['scalar']).to(x.dtype)
    return op


_scmp('_equal_scalar', torch.eq)
_scmp('_not_equal_scalar', torch.ne)
_scmp('_greater_scalar', torch.gt)
_scmp('_greater_equal_scalar', torch.ge)
_scmp('_lesser_scalar', torch.lt)
_scmp('_lesser_equal_scalar', torch.le)


@register('smooth_l1', param_defaults={'scalar': 1.0})
def _smooth_l1(attrs, x):
    """Reference: elemwise_binary_scalar_op_extended.cc smooth_l1."""
    sigma2 = attrs.get('scalar', 1.0) ** 2
    absx = torch.abs(x)
    return torch.where(absx < 1.0 / sigma2, 0.5 * sigma2 * x * x,
                       absx - 0.5 / sigma2)


@register('add_n', variadic=True, key_var_num_args='num_args')
def _add_n(attrs, *xs):
    """Reference: elemwise_sum.cc add_n/ElementWiseSum."""
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


register_alias('ElementWiseSum', 'add_n')
register_alias('_sum', 'add_n')
