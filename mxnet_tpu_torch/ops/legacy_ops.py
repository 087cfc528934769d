"""Legacy registration names: the counterpart of
``mxnet_tpu/ops/legacy_ops.py`` for the names whose targets the port has.

Each alias is the same OpDef as its modern target (the capitalized
NDArray-function forms, ``broadcast_plus``/``broadcast_minus``, the
``_sample_*`` and dense ``_sparse_*`` names, ``CuDNNBatchNorm``,
``_broadcast_backward``). ``Convolution_v1``, ``_CrossDeviceCopy`` and
``_NoGradient`` are ops of their own. Not here yet: ``_sparse_cast_storage``
and ``_contrib_ctc_loss`` (their targets ``cast_storage`` and ``ctc_loss``
come with sparse storage and the RNN stack), the image codecs ``_cv*``
(with ``image/``) and the Python-callback bridges ``_Native``, ``_NDArray``
and ``_CustomFunction`` (with ``operator.py``).
"""
from . import registry as _reg

_ALIASES = {
    # capitalized NDArray-function binary forms
    '_Plus': '_plus', '_Minus': '_minus', '_Mul': '_mul', '_Div': '_div',
    '_Mod': '_mod', '_Power': '_power', '_Maximum': '_maximum',
    '_Minimum': '_minimum', '_Hypot': '_hypot', '_Equal': '_equal',
    '_Not_Equal': '_not_equal', '_Greater': '_greater',
    '_Greater_Equal': '_greater_equal', '_Lesser': '_lesser',
    '_Lesser_Equal': '_lesser_equal',
    # ...and their scalar forms
    '_PlusScalar': '_plus_scalar', '_MinusScalar': '_minus_scalar',
    '_RMinusScalar': '_rminus_scalar', '_MulScalar': '_mul_scalar',
    '_DivScalar': '_div_scalar', '_RDivScalar': '_rdiv_scalar',
    '_ModScalar': '_mod_scalar', '_RModScalar': '_rmod_scalar',
    '_PowerScalar': '_power_scalar', '_RPowerScalar': '_rpower_scalar',
    '_MaximumScalar': '_maximum_scalar', '_MinimumScalar': '_minimum_scalar',
    '_HypotScalar': '_hypot_scalar', '_EqualScalar': '_equal_scalar',
    '_NotEqualScalar': '_not_equal_scalar', '_GreaterScalar': '_greater_scalar',
    '_GreaterEqualScalar': '_greater_equal_scalar',
    '_LesserScalar': '_lesser_scalar',
    '_LesserEqualScalar': '_lesser_equal_scalar',
    # broadcast arithmetic
    'broadcast_plus': 'broadcast_add', 'broadcast_minus': 'broadcast_sub',
    # the samplers' names
    '_sample_negbinomial': '_random_negative_binomial',
    '_sample_gennegbinomial': '_random_generalized_negative_binomial',
    # the sparse names over dense arrays, as in the JAX package
    '_sparse_ElementWiseSum': 'add_n', '_sparse_add_n': 'add_n',
    '_sparse_elemwise_add': 'elemwise_add', '_sparse_dot': 'dot',
    '_sparse_slice': 'slice', '_sparse_zeros_like': 'zeros_like',
    # the same BatchNorm: cuDNN is an implementation detail
    'CuDNNBatchNorm': 'BatchNorm',
    # the backward of broadcast_to: a sum over the broadcast axes
    '_broadcast_backward': 'sum',
}

for _alias, _target in _ALIASES.items():
    _reg.register_alias(_alias, _target)
del _alias, _target


@_reg.register('Convolution_v1', input_names=['data', 'weight', 'bias'],
               param_defaults={'kernel': None, 'stride': None, 'dilate': None,
                               'pad': None, 'num_filter': 0, 'num_group': 1,
                               'workspace': 1024, 'no_bias': False,
                               'cudnn_tune': None, 'cudnn_off': False,
                               'layout': None},
               arg_names_fn=_reg.get('Convolution').arg_names_fn)
def _convolution_v1(attrs, *tensors):
    """The legacy convolution: Convolution's function (v1 differed only in
    its GPU workspace)."""
    return _reg.apply_op('Convolution', attrs, *tensors)


@_reg.register('_CrossDeviceCopy')
def _cross_device_copy(attrs, x):
    """The identity: a graph runs on one device, where the copy is none."""
    return x


@_reg.register('_NoGradient', differentiable=False)
def _no_gradient(attrs, x):
    """The gradient blocker: ``x`` without a gradient."""
    return x.detach()
