"""The port's shape, indexing, init and control-flow ops
(mxnet_tpu_torch.ops.shape_ops) and the NDArray surface over them (the
method forms, ``nd.concatenate``, ``nd.stack``, the ops without inputs in
a context) against the JAX package's, on the CPU.

Every name that ``mxnet_tpu/ops/shape_ops.py`` registers, aliases included,
must exist in the port's registry and in ``nd`` with the same input names,
parameter defaults and variadic form, an alias naming the same op as in the
JAX registry. Each op is then held to ``mxnet_tpu.ops.registry.get(name).fn``
on the same numpy inputs, in value, dtype and shape, across the trouble
spots: Reshape's codes and ``reverse``, negative slice steps, take's
``clip`` and ``wrap`` modes and indices out of range, SliceChannel's
``squeeze_axis``, Pad's modes on 4-D and 5-D input, nearest UpSampling.

These ops move and pick values and compute nothing (clip and one_hot's
scale compare and multiply exact values), so every result is held
exactly, NaN where NaN.
"""
import functools
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
from mxnet_tpu_torch import cpu, nd
from mxnet_tpu_torch.ops import registry as treg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = re.findall(r"register(?:_alias)?\('(\w+)'", open(
    os.path.join(ROOT, 'mxnet_tpu', 'ops', 'shape_ops.py')).read())


def test_every_name_is_registered_and_in_nd():
    assert len(NAMES) == 46
    for name in NAMES:
        assert treg.exists(name), name
        assert callable(getattr(nd, name)), name
        t, j = treg.get(name), jreg.get(name)
        assert t.input_names == j.input_names, name
        assert t.param_defaults == j.param_defaults, name
        assert t.variadic == j.variadic, name
        assert t.key_var_num_args == j.key_var_num_args, name
    for a in NAMES:
        for b in NAMES:
            assert (treg.get(a) is treg.get(b)) == (jreg.get(a) is jreg.get(b)), (a, b)


_RNG = np.random.RandomState(0)
X = _RNG.standard_normal((2, 3, 4)).astype(np.float32)
X4 = _RNG.standard_normal((2, 3, 4, 5)).astype(np.float32)
X5 = _RNG.standard_normal((1, 2, 3, 4, 3)).astype(np.float32)
M = _RNG.standard_normal((4, 5)).astype(np.float32)
IDX = np.array([0, 5, -1, 2, -7, 1.7, -0.5], np.float32)


def _f(a, dtype='float32'):
    return (a, dtype)


# (id, op name, attrs, [(numpy array, dtype)])
CASES = [
    ('Reshape-4x6', 'Reshape', {'shape': (4, 6)}, [_f(X)]),
    ('Reshape-0-1', 'Reshape', {'shape': (0, -1)}, [_f(X)]),
    ('Reshape--2', 'Reshape', {'shape': (-2,)}, [_f(X)]),
    ('Reshape--3', 'Reshape', {'shape': (-3, 4)}, [_f(X)]),
    ('Reshape--4', 'Reshape', {'shape': (-4, 1, 2, -2)}, [_f(X)]),
    ('Reshape--4-infer', 'Reshape', {'shape': (0, 0, -4, 2, -1, -2)}, [_f(X4)]),
    ('Reshape-reverse', 'Reshape', {'shape': (-1, 0), 'reverse': True}, [_f(X)]),
    ('Reshape-target_shape', 'Reshape', {'target_shape': (0, 4)}, [_f(X)]),
    ('Reshape-keep_highest', 'Reshape',
     {'target_shape': (5, 0), 'keep_highest': True}, [_f(X, 'int32')]),
    ('reshape', 'reshape', {'shape': (3, -1)}, [_f(X, 'bfloat16')]),
    ('reshape_like', 'reshape_like', {}, [_f(X), _f(np.zeros((6, 4), np.float32))]),
    ('Flatten', 'Flatten', {}, [_f(X4)]),
    ('transpose', 'transpose', {}, [_f(X)]),
    ('transpose-axes', 'transpose', {'axes': (1, 0, 2)}, [_f(X, 'int32')]),
    ('expand_dims', 'expand_dims', {'axis': 1}, [_f(X)]),
    ('expand_dims--1', 'expand_dims', {'axis': -1}, [_f(X)]),
    ('squeeze', 'squeeze', {}, [_f(X.reshape(2, 1, 12, 1))]),
    ('squeeze-1', 'squeeze', {'axis': 1}, [_f(X.reshape(2, 1, 12, 1))]),
    ('squeeze-1-3', 'squeeze', {'axis': (1, 3)}, [_f(X.reshape(2, 1, 12, 1))]),
    ('SwapAxis', 'SwapAxis', {'dim1': 0, 'dim2': 2}, [_f(X)]),
    ('slice', 'slice', {'begin': (0, 1), 'end': (2, 3)}, [_f(X)]),
    ('slice-step', 'slice', {'begin': (None, None), 'end': (None, None),
                             'step': (1, -1)}, [_f(X)]),
    ('slice-negative', 'slice', {'begin': (1, 2, None), 'end': (None, 0, None),
                                 'step': (None, -2, -3)}, [_f(X, 'bfloat16')]),
    ('crop', 'crop', {'begin': (0, 0, 1), 'end': (1, 2, 3)}, [_f(X)]),
    ('_slice_assign', '_slice_assign', {'begin': (0, 1), 'end': (2, 3)},
     [_f(X), _f(np.ones((2, 2, 4), np.float32))]),
    ('_slice_assign-step', '_slice_assign',
     {'begin': (None, 2), 'end': (None, None), 'step': (None, -2)},
     [_f(X, 'int32'), _f(M[:2, :2].reshape(2, 2, 1) * 5)]),
    ('_crop_assign_scalar', '_crop_assign_scalar',
     {'scalar': 2.5, 'begin': (1,), 'end': (2,)}, [_f(X, 'int32')]),
    ('_slice_assign_scalar-step', '_slice_assign_scalar',
     {'scalar': -1.0, 'begin': (None, None, 3), 'end': (None, None, 0),
      'step': (None, None, -2)}, [_f(X)]),
    ('slice_axis', 'slice_axis', {'axis': 1, 'begin': 1, 'end': None}, [_f(X)]),
    ('slice_axis--1', 'slice_axis', {'axis': -1, 'begin': -3, 'end': -1}, [_f(X)]),
    ('slice_like', 'slice_like', {}, [_f(X), _f(X[:1, :2, :3])]),
    ('slice_like-axes', 'slice_like', {'axes': (1,)}, [_f(X), _f(X[:1, :2, :3])]),
    ('clip', 'clip', {'a_min': -0.5, 'a_max': 0.7}, [_f(X)]),
    ('clip-bf16', 'clip', {'a_min': -0.5, 'a_max': 0.7}, [_f(X, 'bfloat16')]),
    ('clip-int32', 'clip', {'a_min': 0.5, 'a_max': 2.5},
     [_f(np.arange(-2, 4, dtype=np.float32), 'int32')]),
    ('clip-nan', 'clip', {'a_min': -1.0, 'a_max': 1.0},
     [_f(np.array([np.nan, -3, 3, 0.5], np.float32))]),
    ('repeat', 'repeat', {'repeats': 2}, [_f(X)]),
    ('repeat-axis', 'repeat', {'repeats': 3, 'axis': 1}, [_f(X, 'int32')]),
    ('tile', 'tile', {'reps': (2,)}, [_f(X)]),
    ('tile-4', 'tile', {'reps': (2, 1, 1, 2)}, [_f(X)]),
    ('reverse', 'reverse', {'axis': 1}, [_f(X)]),
    ('flip-0-2', 'flip', {'axis': (0, 2)}, [_f(X, 'bfloat16')]),
    ('Concat', 'Concat', {'num_args': 3}, [_f(X), _f(X * 2), _f(X[:, :1])]),
    ('concat-0', 'concat', {'dim': 0, 'num_args': 2}, [_f(X), _f(X[:1])]),
    ('stack', 'stack', {'num_args': 2}, [_f(X), _f(X * 2)]),
    ('stack-2', 'stack', {'axis': 2, 'num_args': 3},
     [_f(X, 'int32'), _f(X * 3, 'int32'), _f(X, 'int32')]),
    ('SliceChannel', 'SliceChannel', {'num_outputs': 3}, [_f(X)]),
    ('SliceChannel-squeeze', 'SliceChannel',
     {'num_outputs': 3, 'squeeze_axis': True}, [_f(X)]),
    ('split-2', 'split', {'num_outputs': 2, 'axis': 2}, [_f(X, 'bfloat16')]),
    ('where', 'where', {}, [_f((M > 0).astype(np.float32)), _f(M), _f(M * 10)]),
    ('where-1d', 'where', {}, [_f(np.array([0, 2, 0, 1], np.float32)), _f(M),
                               _f(M * 10)]),
    ('take', 'take', {}, [_f(M), _f(IDX)]),
    ('take-axis1', 'take', {'axis': 1}, [_f(M), _f(IDX.reshape(7, 1))]),
    ('take-wrap', 'take', {'mode': 'wrap'}, [_f(M), _f(IDX)]),
    ('take-wrap-int', 'take', {'mode': 'wrap', 'axis': -1},
     [_f(M, 'int32'), _f(IDX[:4], 'int32')]),
    ('batch_take', 'batch_take', {}, [_f(M), _f(np.array([0, 7, -1, 3], np.float32))]),
    ('Embedding', 'Embedding', {'input_dim': 4, 'output_dim': 5},
     [_f(np.array([[0, 3, 9], [-1, 2, 1.5]], np.float32)), _f(M, 'bfloat16')]),
    ('one_hot', 'one_hot', {'depth': 4},
     [_f(np.array([0, 2, 5, -1, 3.7], np.float32))]),
    ('one_hot-values', 'one_hot', {'depth': 3, 'on_value': 3.0,
                                   'off_value': -1.0},
     [_f(np.array([[0, 1], [2, 4]], np.float32), 'int32')]),
    ('one_hot-int32', 'one_hot', {'depth': 3, 'dtype': 'int32'},
     [_f(np.array([0, 2, 1], np.float32))]),
    ('one_hot-bf16', 'one_hot', {'depth': 3, 'dtype': 'bfloat16',
                                 'on_value': 0.7},
     [_f(np.array([0, 2, 1], np.float32))]),
    ('pick', 'pick', {}, [_f(M), _f(np.array([0, 4, 9, -1], np.float32))]),
    ('pick-axis0-keepdims', 'pick', {'axis': 0, 'keepdims': True},
     [_f(M), _f(np.array([0, 3, -2, 1, 2], np.float32))]),
    ('pick-int32', 'pick', {}, [_f(M * 9, 'int32'),
                                _f(np.array([0, 5, -9, 2], np.float32))]),
    # the index broadcasts against the data as jnp.take_along_axis's does:
    # a (1,) index serves every row, a (1, 5) data row every index
    ('pick-one-index', 'pick', {}, [_f(M), _f(np.array([3], np.float32))]),
    ('pick-one-index-keepdims', 'pick', {'keepdims': True},
     [_f(M), _f(np.array([-1], np.float32))]),
    ('pick-one-index-axis0', 'pick', {'axis': 0},
     [_f(M), _f(np.array([3], np.float32))]),
    ('pick-one-row', 'pick', {}, [_f(M[:1]), _f(np.array([3, 1, 2, 0],
                                                        np.float32))]),
    ('gather_nd', 'gather_nd', {},
     [_f(X), _f(np.array([[0, 1, -1, 5], [1, 3, 0, -9]], np.float32))]),
    ('gather_nd-full', 'gather_nd', {},
     [_f(X), _f(np.array([[0, 1], [2, 0], [3, 1]], np.float32))]),
    ('scatter_nd', 'scatter_nd', {'shape': (3, 4)},
     [_f(np.array([1, 2, 3, 4, 5], np.float32)),
      _f(np.array([[0, 1, 1, 5, -1], [2, 0, 0, 1, 3]], np.float32))]),
    ('scatter_nd-rows', 'scatter_nd', {'shape': (3, 2)},
     [_f(np.array([[1, 2], [3, 4]], np.float32), 'int32'),
      _f(np.array([[2, 2]], np.float32))]),
    ('Pad-constant-4d', 'Pad', {'pad_width': (0, 0, 0, 0, 1, 2, 2, 1),
                                'constant_value': 1.5}, [_f(X4)]),
    ('Pad-edge-4d', 'Pad', {'mode': 'edge', 'pad_width': (0, 0, 0, 0, 2, 1, 0, 3)},
     [_f(X4)]),
    ('Pad-reflect-4d', 'Pad', {'mode': 'reflect',
                               'pad_width': (0, 0, 0, 0, 2, 3, 4, 1)},
     [_f(X4, 'bfloat16')]),
    ('Pad-edge-5d', 'Pad', {'mode': 'edge',
                            'pad_width': (0, 0, 0, 0, 1, 1, 2, 0, 0, 2)},
     [_f(X5)]),
    ('Pad-reflect-5d', 'Pad', {'mode': 'reflect',
                               'pad_width': (0, 0, 0, 0, 2, 1, 1, 3, 2, 2)},
     [_f(X5)]),
    ('pad-constant-int', 'pad', {'pad_width': (1, 0, 0, 2),
                                 'constant_value': 2.7}, [_f(M, 'int32')]),
    ('_zeros', '_zeros', {'shape': (2, 3)}, []),
    ('_zeros-int32', '_zeros', {'shape': (4,), 'dtype': 'int32'}, []),
    ('_ones-bf16', '_ones', {'shape': (2, 1), 'dtype': 'bfloat16'}, []),
    ('_arange', '_arange', {'start': 1, 'stop': 7, 'step': 1.5, 'repeat': 2}, []),
    ('_arange-int', '_arange', {'start': 5, 'dtype': 'int32'}, []),
    ('_arange-bf16', '_arange', {'start': 0, 'stop': 3, 'step': 0.5,
                                 'dtype': 'bfloat16'}, []),
    ('UpSampling', 'UpSampling', {'scale': 2}, [_f(X4)]),
    ('UpSampling-2', 'UpSampling', {'scale': 3, 'num_args': 2},
     [_f(X4[:, :2, :2]), _f(X4[:, :1, :2], 'float32')]),
    ('Crop', 'Crop', {'h_w': (2, 3), 'offset': (1, 1)}, [_f(X4)]),
    ('Crop-center', 'Crop', {'h_w': (2, 2), 'center_crop': True}, [_f(X4)]),
    ('Crop-like', 'Crop', {'num_args': 2}, [_f(X4), _f(X4[:, :, :2, :3])]),
    ('space_to_depth', 'space_to_depth', {'block_size': 2},
     [_f(np.arange(48, dtype=np.float32).reshape(1, 2, 4, 6))]),
    ('depth_to_space', 'depth_to_space', {'block_size': 2},
     [_f(np.arange(48, dtype=np.float32).reshape(1, 8, 2, 3))]),
    ('_state_zeros', '_state_zeros', {'shape': (0, 4)}, [_f(M)]),
    ('_state_zeros-axis1', '_state_zeros', {'shape': (3, 0), 'batch_axis': 1,
                                            'dtype': 'bfloat16'}, [_f(M)]),
]


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.float().numpy().astype(ml_dtypes.bfloat16)
        return x.numpy()
    return np.asarray(x)


def _same(got, want, what):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=str(what))


def _to_torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))


def test_every_op_has_cases():
    assert {jreg.get(c[1]).name for c in CASES} == {jreg.get(n).name for n in NAMES}


@functools.lru_cache(maxsize=None)
def _jax_results():
    """Every case's JAX result, from one jitted program."""
    def run(inputs):
        return [jreg.get(name).fn(dict(attrs), *xs)
                for (_, name, attrs, _), xs in zip(CASES, inputs)]
    inputs = [[jnp.asarray(a).astype(getattr(jnp, d)) for a, d in arrays]
              for *_, arrays in CASES]
    return jax.jit(run)(inputs)


@pytest.mark.parametrize('case', range(len(CASES)), ids=[c[0] for c in CASES])
def test_op_matches_jax(case):
    _, name, attrs, arrays = CASES[case]
    got = treg.get(name).fn(dict(attrs), *(_to_torch(a, d) for a, d in arrays))
    want = _jax_results()[case]
    if isinstance(want, (tuple, list)):
        assert isinstance(got, tuple) and len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, (name, i))
    else:
        _same(got, want, name)


@pytest.mark.parametrize('index', [[3, 1, 2], [[3]]], ids=['rows', 'rank'])
def test_pick_raises_where_jax_raises(index):
    """An index that does not broadcast against the data's rows (3 of 4),
    or of another rank, raises ValueError in both packages."""
    index = np.array(index, np.float32)
    with pytest.raises(ValueError):
        jreg.get('pick').fn({}, jnp.asarray(M), jnp.asarray(index))
    with pytest.raises(ValueError):
        treg.get('pick').fn({}, torch.from_numpy(M), torch.from_numpy(index))


def test_slice_channel_needs_equal_parts():
    with pytest.raises(ValueError):
        treg.get('SliceChannel').fn({'num_outputs': 3, 'axis': 2},
                                    torch.zeros(2, 3, 4))


# ---------------------------------------------------------------------------
# the NDArray surface
# ---------------------------------------------------------------------------

def _methods(x, idx, ndm):
    """The method forms and module functions of either package on x
    [2, 3, 4] and an index array."""
    return [x.reshape_like(ndm.zeros((4, 6), x.context)), x.transpose(),
            x.transpose(2, 0, 1), x.transpose((1, 0, 2)), x.T, x.flatten(),
            x.expand_dims(0), x.reshape((2, 1, 12)).squeeze(axis=1),
            x.swapaxes(0, 1), *x.split(3, axis=1),
            *x.split(2, axis=2, squeeze_axis=False),
            x.slice((0, 1), (2, 3)), x.slice((None, None), (None, None), (1, -1)),
            x.slice_axis(2, 1, 3), x.take(idx), x.take(idx, axis=2, mode='wrap'),
            x.clip(-0.5, 0.5), x.tile((2, 1, 1)), x.repeat(2, axis=0),
            x.flip(1), x.pad('constant', (0, 0, 1, 1, 2, 0), 0.5),
            x.reshape((6, 4)).pick(idx[:6], axis=-1),
            idx.one_hot(5, 2.0, -1.0),
            ndm.concatenate([x, x * 2], axis=1), ndm.concatenate([x, x]),
            ndm.stack(x, x * 3, axis=1), ndm.stack(x, x),
            ndm.Reshape(x, shape=(-1, 4)), ndm.SliceChannel(x, num_outputs=2,
                                                            axis=0)[1],
            ndm.maximum(x, 0.2), ndm.minimum(x, x * 0.5),
            ndm.clip(x, -0.1, 0.1)]


def test_method_forms_match_mx_nd():
    idx = np.array([0, 3, -1, 2, 9, 1], np.float32)
    got = _methods(nd.array(X, ctx=cpu()), nd.array(idx, ctx=cpu()), nd)
    want = _methods(mx.nd.array(X, ctx=mx.cpu()), mx.nd.array(idx, ctx=mx.cpu()),
                    mx.nd)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, i
        np.testing.assert_array_equal(g.asnumpy(), w.asnumpy(), err_msg=str(i))


def test_ops_without_inputs_take_their_context():
    """nd._zeros / nd._arange build in the context they are given; without
    one, in the current context (the card, which this machine may lack)."""
    z = nd._zeros(shape=(2, 3), dtype='int32', ctx=cpu())
    assert z.context == cpu() and z.handle.device.type == 'cpu'
    _same(z.handle, mx.nd._zeros(shape=(2, 3), dtype='int32',
                                 ctx=mx.cpu()).asnumpy(), '_zeros')
    a = nd._arange(start=2, stop=5, ctx=cpu())
    _same(a.handle, mx.nd._arange(start=2, stop=5, ctx=mx.cpu()).asnumpy(),
          '_arange')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            nd._ones(shape=(2,))


def test_truth_value_as_mx_nd():
    """A one-element NDArray has a truth value; a larger one raises
    ValueError, as in mxnet_tpu.nd (DCASGD's ``if mon:`` relies on it)."""
    for ndm, ctx in ((nd, cpu()), (mx.nd, mx.cpu())):
        assert bool(ndm.array([2.0], ctx=ctx)) and not ndm.array([[0]], ctx=ctx)
        with pytest.raises(ValueError, match='ambiguous'):
            bool(ndm.array([1.0, 2.0], ctx=ctx))
