"""Legacy registration names: the counterpart of
``mxnet_tpu/ops/legacy_ops.py`` for the names whose targets the port has.

Each alias is the same OpDef as its modern target (the capitalized
NDArray-function forms, ``broadcast_plus``/``broadcast_minus``, the
``_sample_*`` and dense ``_sparse_*`` names, ``CuDNNBatchNorm``,
``_broadcast_backward``). ``Convolution_v1``, ``_CrossDeviceCopy`` and
``_NoGradient`` are ops of their own, and so are the image codecs
``_cvimdecode``, ``_cvimread``, ``_cvimresize`` and ``_cvcopyMakeBorder``:
host ops in numpy (and PIL) on CPU arrays, through :mod:`..image`, and
so are the Python-callback bridges ``_Native`` (a NumpyOp: numpy buffers on
the host), ``_NDArray`` (an NDArrayOp: NDArrays on the node's context) and
``_CustomFunction`` (an ``autograd.Function``), each with its
``legacy_backward``. A graph runs them through ``registry.host_bridge``.
"""
import numpy as np
import torch

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
    '_sparse_cast_storage': 'cast_storage',
    '_sparse_ElementWiseSum': 'add_n', '_sparse_add_n': 'add_n',
    '_sparse_elemwise_add': 'elemwise_add', '_sparse_dot': 'dot',
    '_sparse_slice': 'slice', '_sparse_zeros_like': 'zeros_like',
    # the same BatchNorm: cuDNN is an implementation detail
    'CuDNNBatchNorm': 'BatchNorm',
    # the backward of broadcast_to: a sum over the broadcast axes
    '_broadcast_backward': 'sum',
    # the contrib CTC loss's other name (contrib/ctc_loss.cc)
    '_contrib_ctc_loss': 'ctc_loss',
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


# -- the image codecs (MXNet's src/io/image_io.cc): host ops -----------------

def _host(t):
    return t.detach().cpu().numpy()


@_reg.register('_cvimdecode', host=True, differentiable=False,
               param_defaults={'flag': 1, 'to_rgb': True})
def _cvimdecode(attrs, buf):
    """Decode JPEG or PNG bytes to a uint8 HWC image (PIL in place of
    OpenCV)."""
    from ..image.image import imdecode
    raw = _host(buf).astype(np.uint8).tobytes()
    img = imdecode(raw, to_rgb=bool(attrs.get('to_rgb', True)),
                   flag=int(attrs.get('flag', 1)))
    return torch.from_numpy(np.asarray(img, np.uint8).copy())


@_reg.register('_cvimread', host=True, differentiable=False, input_names=[],
               param_defaults={'filename': '', 'flag': 1, 'to_rgb': True})
def _cvimread(attrs, *_):
    """Read and decode an image file."""
    from ..image.image import imdecode
    with open(attrs.get('filename', ''), 'rb') as f:
        raw = f.read()
    img = imdecode(raw, to_rgb=bool(attrs.get('to_rgb', True)),
                   flag=int(attrs.get('flag', 1)))
    return torch.from_numpy(np.asarray(img, np.uint8).copy())


def _cvimresize_shape(attrs, in_shapes):
    s = in_shapes[0]
    return [(int(attrs['h']), int(attrs['w'])) + tuple(s[2:])], [None]


@_reg.register('_cvimresize', host=True, differentiable=False,
               shape_fn=_cvimresize_shape,
               param_defaults={'w': 0, 'h': 0, 'interp': 1})
def _cvimresize(attrs, src):
    """Resize an HWC image, bilinear in numpy; integer images are rounded
    and clipped back to their type."""
    from ..image.image import imresize
    img = _host(src)
    out = imresize(img.astype(np.float32), int(attrs['w']), int(attrs['h']),
                   interp=int(attrs.get('interp', 1)))
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        out = np.clip(np.rint(out), info.min, info.max)
    return torch.from_numpy(np.ascontiguousarray(out.astype(img.dtype)))


def _cvborder_shape(attrs, in_shapes):
    s = in_shapes[0]
    out = (s[0] + int(attrs.get('top', 0)) + int(attrs.get('bot', 0)),
           s[1] + int(attrs.get('left', 0)) + int(attrs.get('right', 0)))
    return [out + tuple(s[2:])], [None]


@_reg.register('_cvcopyMakeBorder', host=True, differentiable=False,
               shape_fn=_cvborder_shape,
               param_defaults={'top': 0, 'bot': 0, 'left': 0, 'right': 0,
                               'type': 0, 'value': 0.0})
def _cvcopy_make_border(attrs, src):
    """Pad an HWC image with a constant border (cv2.BORDER_CONSTANT, the
    only type MXNet's io path uses)."""
    img = _host(src)
    pad = ((int(attrs['top']), int(attrs['bot'])),
           (int(attrs['left']), int(attrs['right'])))
    if img.ndim == 3:
        pad = pad + ((0, 0),)
    out = np.pad(img, pad, mode='constant',
                 constant_values=float(attrs.get('value', 0.0)))
    return torch.from_numpy(out)


# -- the Python-callback bridges (MXNet's native_op.cc, ndarray_op.cc,
#    custom_function.cc): host ops ---------------------------------------------
# MXNet passes a C callback struct's pointer through the `info` attr; here
# `info` keys a process-local table of live Python objects (operator.py's
# PythonOp.get_symbol registers them).

_LEGACY_CALLBACKS = {}


def register_legacy_callback(obj):
    """Keep ``obj`` alive and return the ``info`` attr that names it."""
    key = str(id(obj))
    _LEGACY_CALLBACKS[key] = obj
    return key


def _lookup_info(attrs, opname):
    from ..base import MXNetError
    key = str(attrs.get('info', ''))
    obj = _LEGACY_CALLBACKS.get(key)
    if obj is None:
        raise MXNetError(
            '%s: no live python operator for info=%r: construct the symbol '
            'through mx.operator.PythonOp/NDArrayOp.get_symbol() in this '
            'process' % (opname, key))
    return obj


def _np32(t):
    return t.detach().float().cpu().numpy()


def _legacy_shape(attrs, in_shapes):
    """shape_fn: the instance's infer_shape."""
    inst = _lookup_info(attrs, 'legacy python op')
    _, out_shapes = inst.infer_shape([list(s) for s in in_shapes])
    return [tuple(s) for s in out_shapes], [np.float32] * len(out_shapes)


def _tensors(outs):
    return outs[0] if len(outs) == 1 else tuple(outs)


@_reg.register('_Native', host=True, variadic=True, shape_fn=_legacy_shape,
               train_aware=True, param_defaults={'info': ''})
def _native(attrs, *tensors):
    """A NumpyOp's forward on host float32 numpy buffers."""
    inst = _lookup_info(attrs, '_Native')
    np_in = [_np32(t) for t in tensors]
    _, out_shapes = inst.infer_shape([list(a.shape) for a in np_in])
    out = [np.zeros(tuple(s), np.float32) for s in out_shapes]
    inst.forward(in_data=np_in, out_data=out)
    return _tensors([torch.from_numpy(o) for o in out])


def _native_backward(attrs, gouts, ins, outs):
    """The NumpyOp's backward on host numpy buffers."""
    inst = _lookup_info(attrs, '_Native')
    np_in = [_np32(t) for t in ins]
    in_grad = [np.zeros_like(a) for a in np_in]
    inst.backward(out_grad=[_np32(g) for g in gouts], in_data=np_in,
                  out_data=[_np32(o) for o in outs], in_grad=in_grad)
    return [torch.from_numpy(g) for g in in_grad]


_reg.get('_Native').legacy_backward = _native_backward


@_reg.register('_NDArray', host=True, variadic=True, shape_fn=_legacy_shape,
               train_aware=True, param_defaults={'info': ''})
def _ndarray_op(attrs, *tensors):
    """An NDArrayOp's forward on NDArrays (its outputs made in the current
    context, the node's under the bridge)."""
    from ..ndarray.ndarray import NDArray, zeros
    inst = _lookup_info(attrs, '_NDArray')
    nd_in = [NDArray(t) for t in tensors]
    _, out_shapes = inst.infer_shape([list(a.shape) for a in nd_in])
    out = [zeros(tuple(s)) for s in out_shapes]
    inst.forward(in_data=nd_in, out_data=out)
    return _tensors([o._data for o in out])


def _ndarray_backward(attrs, gouts, ins, outs):
    from ..ndarray.ndarray import NDArray, zeros
    inst = _lookup_info(attrs, '_NDArray')
    in_grad = [zeros(tuple(t.shape)) for t in ins]
    inst.backward(out_grad=[NDArray(g) for g in gouts],
                  in_data=[NDArray(t) for t in ins],
                  out_data=[NDArray(o) for o in outs], in_grad=in_grad)
    return [g._data.float() for g in in_grad]


_reg.get('_NDArray').legacy_backward = _ndarray_backward


@_reg.register('_CustomFunction', host=True, differentiable=False,
               variadic=True, param_defaults={'info': ''})
def _custom_function(attrs, *tensors):
    """An autograd.Function's forward on NDArrays (the record of a
    Function call in a graph built by autograd.get_symbol)."""
    from ..ndarray.ndarray import NDArray
    inst = _lookup_info(attrs, '_CustomFunction')
    out = inst.forward(*[NDArray(t) for t in tensors])
    if isinstance(out, (tuple, list)):
        return tuple(o._data for o in out)
    return out._data
