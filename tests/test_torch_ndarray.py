"""The port's NDArray operator path (mxnet_tpu_torch: the op registry, the nd
namespace generated from it, and the registry ops LayerNorm, softmax and
softmax_cross_entropy) against the JAX package's, on the CPU.

Each op is held to the JAX op of the same name (``registry.get(name).fn``)
with ``MXTPU_FORCE_PALLAS`` at 0 (the plain branch) and at 1 (the kernel
branch: the Pallas kernels in interpret mode on the JAX side, the kernel
wrappers' plain versions on the port's), in value and in dtype; then the
same through ``mxnet_tpu_torch.nd`` and ``mxnet_tpu.nd`` with ``ctx=cpu()``;
then the slice as a whole: bench's training loss (``bench.py``'s
``mean(lse - gold)``) on bench's small forward and its labels, through both
packages' ``nd.softmax_cross_entropy``.

Tolerances (|port - jax| <= atol + rtol * |jax|), with their reasons:
- float32 results: 1e-5 / 1e-5; both sides compute in f32 with sums in
  another order. A summed loss (7 rows) keeps rtol 1e-5.
- results that pass through bfloat16: rtol 2**-7 and atol 2**-7 * max|jax|,
  one bf16 ulp at the magnitude of the row: the two frameworks round at
  different places (JAX's plain softmax and log_softmax compute in bf16,
  torch's in f32 and round once; a bf16 x with f32 gamma rounds y first).
- bench's loss: the small forward's f32 logits agree within 1e-4
  (test_torch_transformer.py), so the mean loss within 1e-4.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch import cpu, nd
from mxnet_tpu_torch.base import dtype_of
from mxnet_tpu_torch.config import flags
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.ops.cuda_kernels import flash_attention_ref
from mxnet_tpu_torch.ops.nn import use_fused
from mxnet_tpu_torch.transformer import (TransformerConfig, TransformerLM,
                                         bench_batch, params_from_jax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = ('LayerNorm', 'softmax', 'softmax_cross_entropy')
F32 = dict(rtol=1e-5, atol=1e-5)
BF16_RTOL = 2 ** -7


def _rand(shape, seed, scale=1.0, shift=0.0):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _labels(n, v, seed):
    return np.random.RandomState(seed).randint(0, v, n).astype(np.float32)


def _close(got, want):
    """``got``, ``want``: numpy results of the port and of JAX. Their
    dtypes must agree; bf16 on either side takes the bf16 tolerance."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape
    if got.dtype.name == 'bfloat16':
        got, want = got.astype(np.float32), want.astype(np.float32)
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL,
                                   atol=BF16_RTOL * float(np.abs(want).max()))
    else:
        np.testing.assert_allclose(got, want, **F32)


def _torch_np(t):
    """A torch result as numpy in its own dtype (bfloat16 as ml_dtypes')."""
    if t.dtype == torch.bfloat16:
        return t.float().numpy().astype(dtype_of(torch.bfloat16))
    return t.numpy()


# (op, [(array, dtype)], attrs). x is [7, 32] unless said; gamma and beta
# f32; labels are float, as MXNet passes them.
OP_CASES = [
    ('LayerNorm', [(_rand((7, 32), 0), 'float32'), (_rand(32, 1, 0.5, 1), 'float32'),
                   (_rand(32, 2, 0.1), 'float32')], {'eps': 1e-5}),
    # bf16 x with f32 gamma: f32 from the plain branch, bf16 from the kernel
    ('LayerNorm', [(_rand((7, 32), 3), 'bfloat16'), (_rand(32, 4, 0.5, 1), 'float32'),
                   (_rand(32, 5, 0.1), 'float32')], {}),
    # not the last axis: the plain branch in both settings
    ('LayerNorm', [(_rand((4, 6, 5), 6), 'float32'), (_rand(6, 7, 0.5, 1), 'float32'),
                   (_rand(6, 8, 0.1), 'float32')], {'axis': 1, 'eps': 1e-3}),
    ('softmax', [(_rand((7, 32), 9, 2.0), 'float32')], {}),
    ('softmax', [(_rand((7, 32), 10, 2.0), 'bfloat16')], {'temperature': 2.0}),
    ('softmax', [(_rand((7, 32), 11, 2.0), 'float32')], {'axis': 0}),
    ('softmax_cross_entropy', [(_rand((7, 50), 12, 2.0), 'float32'),
                               (_labels(7, 50, 13), 'float32')], {}),
    ('softmax_cross_entropy', [(_rand((7, 50), 14, 2.0), 'bfloat16'),
                               (_labels(7, 50, 15), 'float32')], {}),
]


@pytest.mark.parametrize('force', ['0', '1'])
@pytest.mark.parametrize('case', range(len(OP_CASES)))
def test_op_matches_jax_op(monkeypatch, case, force):
    name, arrays, attrs = OP_CASES[case]
    monkeypatch.setenv('MXTPU_FORCE_PALLAS', force)
    # jitted, as mx.nd runs an op; the flag is read while tracing
    want = jax.jit(lambda *a: jreg.get(name).fn(dict(attrs), *a))(*(
        jnp.asarray(a, getattr(jnp, d)) for a, d in arrays))
    got = treg.get(name).fn(dict(attrs), *(
        torch.from_numpy(a).to(getattr(torch, d)) for a, d in arrays))
    _close(_torch_np(got), np.asarray(want))


def test_xent_plain_branch_labels_outside_the_row(monkeypatch):
    """Plain branch: -1 counts from the end and V picks NaN, as
    jnp.take_along_axis does; the kernel branch gives -1 and V the row's
    logsumexp."""
    logits = _rand((4, 5), 16)
    for force in ('0', '1'):
        monkeypatch.setenv('MXTPU_FORCE_PALLAS', force)
        for lab in ([0, -1, 2, 3], [0, 5, 2, 3]):
            lab = np.asarray(lab, np.float32)
            want = np.asarray(jreg.get('softmax_cross_entropy').fn(
                {}, jnp.asarray(logits), jnp.asarray(lab)))
            got = treg.apply_op('softmax_cross_entropy', {},
                                torch.from_numpy(logits), torch.from_numpy(lab))
            np.testing.assert_allclose(got.numpy(), want, **F32)


def test_registry_matches_the_jax_registry():
    for name in OPS:
        t, j = treg.get(name), jreg.get(name)
        assert (t.input_names, t.param_defaults, t.num_outputs,
                t.mutate_inputs, t.needs_rng, t.train_aware) == \
            (j.input_names, j.param_defaults, j.num_outputs,
             j.mutate_inputs, j.needs_rng, j.train_aware)
        assert treg.exists(name) and name in treg.list_ops()
    with pytest.raises(KeyError, match='not registered'):
        treg.get('no_such_op')


def test_register_alias_and_generated_functions(monkeypatch):
    monkeypatch.setattr(treg, '_OPS', dict(treg._OPS))

    @treg.register('_test_scale', param_defaults={'k': 2.0})
    def _scale(attrs, x):
        """x * k"""
        return x * attrs.get('k', 2.0)

    treg.register_alias('_test_scale_alias', '_test_scale')
    assert treg.get('_test_scale_alias') is treg.get('_test_scale')
    x = nd.array([1.0, 2.0], ctx=cpu())
    try:
        # late binding through nd and nd.op; a positional scalar fills k
        np.testing.assert_array_equal(nd._test_scale(x, 3.0).asnumpy(),
                                      [3.0, 6.0])
        np.testing.assert_array_equal(nd.op._test_scale_alias(x).asnumpy(),
                                      [2.0, 4.0])
        assert nd.op._test_scale.__doc__ == 'x * k'
    finally:
        for module in (nd, nd.op):         # the late-bound functions
            for name in ('_test_scale', '_test_scale_alias'):
                vars(module).pop(name, None)
    with pytest.raises(AttributeError):
        nd.op.no_such_op

    seen = []

    @treg.register('_test_rng', needs_rng=True)
    def _rng(attrs, x, gen):
        seen.append(gen)
        return x

    # a needs_rng op gets its device's generator as its last argument
    nd.invoke('_test_rng', [x])
    assert isinstance(seen[0], torch.Generator)
    assert seen[0].device == torch.device('cpu')


def test_use_fused(monkeypatch):
    x = torch.zeros(2, 3)
    monkeypatch.delenv('MXTPU_FORCE_PALLAS', raising=False)
    assert not use_fused(x)
    monkeypatch.setenv('MXTPU_FORCE_PALLAS', '1')
    assert use_fused(x)
    monkeypatch.setenv('MXTPU_FORCE_PALLAS', 'maybe')
    flags.reload('MXTPU_FORCE_PALLAS')
    assert flags.get('MXTPU_FORCE_PALLAS') is True    # the JAX parse: not 0/false/no


@pytest.mark.parametrize('force', ['0', '1'])
def test_nd_namespace_matches_mx_nd(monkeypatch, force):
    monkeypatch.setenv('MXTPU_FORCE_PALLAS', force)
    # mx.nd caches one jitted program per op, attrs and shape, traced under
    # the flag of its first call: each setting gets its own row count
    n = 7 if force == '0' else 9
    x, g, b = _rand((n, 32), 20), _rand(32, 21, 0.5, 1), _rand(32, 22, 0.1)
    logits, lab = _rand((n, 50), 23, 2.0), _labels(n, 50, 24)
    mine = {k: nd.array(v, ctx=cpu()) for k, v in
            dict(x=x, g=g, b=b, logits=logits, lab=lab).items()}
    theirs = {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in
              dict(x=x, g=g, b=b, logits=logits, lab=lab).items()}
    for ns, a in ((nd, mine), (mx.nd, theirs)):
        a['out'] = (ns.LayerNorm(a['x'], a['g'], a['b'], eps=1e-4),
                    ns.LayerNorm(data=a['x'], gamma=a['g'], beta=a['b']),
                    ns.softmax(a['x'], temperature=3.0),
                    ns.softmax(a['x'], 0),                 # axis, positionally
                    ns.softmax_cross_entropy(a['logits'], a['lab']))
    for got, want in zip(mine['out'], theirs['out']):
        assert got.shape == want.shape and got.dtype == want.dtype
        assert got.context == cpu()
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **F32)


def test_ndarray_core_matches_mx_nd():
    # dtype rules of nd.array: lists are f32, numpy keeps its dtype with
    # 64-bit narrowed, an explicit dtype wins
    for src, dtype in (([1, 2], None), (np.arange(3), None),
                       (np.ones(2, np.float64), None), (np.ones(2, np.float16), None),
                       (np.ones(2, bool), None), ([1.5, 2.5], 'bfloat16'),
                       (np.arange(4.0), 'int32')):
        got = nd.array(src, ctx=cpu(), dtype=dtype)
        want = mx.nd.array(src, ctx=mx.cpu(), dtype=dtype)
        assert got.dtype == want.dtype and got.shape == want.shape, src
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    for make in ('zeros', 'ones', 'empty'):
        got = getattr(nd, make)((2, 3), ctx=cpu(), dtype='float16')
        want = getattr(mx.nd, make)((2, 3), ctx=mx.cpu(), dtype='float16')
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    got, want = nd.full(4, 2.5, ctx=cpu()), mx.nd.full(4, 2.5, ctx=mx.cpu())
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    # reshape with MXNet's special codes
    a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    for target in ((-1,), (0, -1), (-2,), (-3, 0), (2, -4, 1, 3, 0), (4, 0, -1)):
        got = nd.array(a, ctx=cpu()).reshape(target)
        want = mx.nd.array(a, ctx=mx.cpu()).reshape(target)
        assert got.shape == want.shape, target
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    x = nd.array(a, ctx=cpu())
    assert (x.size, x.ndim, len(x)) == (24, 3, 2)
    assert x.reshape(shape=(4, 6)).shape == (4, 6)
    assert x.astype('bfloat16').dtype == mx.nd.array(a).astype('bfloat16').dtype
    assert x.astype('float32', copy=False) is x
    assert nd.array([7.0], ctx=cpu()).asscalar() == 7.0
    with pytest.raises(ValueError, match='not a scalar'):
        x.asscalar()


_KEYS_REFUSED = {'list': lambda ndm, ctx: [2, 0],
                 'nested list': lambda ndm, ctx: [[2, 0]],
                 'float NDArray': lambda ndm, ctx: ndm.array([2, 0], ctx=ctx),
                 'float numpy': lambda ndm, ctx: np.array([2.0, 0.0]),
                 'float in a tuple': lambda ndm, ctx: (1.0, 2),
                 'float numpy in a tuple':
                     lambda ndm, ctx: (np.array([2.0, 0.0]), 1)}
_KEYS_TAKEN = {'int32 NDArray':
                   lambda ndm, ctx: ndm.array([2, 0], ctx=ctx, dtype='int32'),
               'int numpy': lambda ndm, ctx: np.array([2, 0]),
               'tuple': lambda ndm, ctx: (2, 1),
               'list in a tuple': lambda ndm, ctx: ([2, 0], 1)}


@pytest.mark.parametrize('key', sorted(_KEYS_REFUSED))
def test_indexing_raises_where_jax_raises(key):
    """A list as the whole key and a float index (an NDArray, a numpy
    array, a number) raise TypeError on read and write, as jnp refuses them
    in the JAX package."""
    make = _KEYS_REFUSED[key]
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    for ndm, ctx in ((nd, cpu()), (mx.nd, mx.cpu())):
        x = ndm.array(a, ctx=ctx)
        with pytest.raises(TypeError):
            x[make(ndm, ctx)]
        if ndm is nd:       # the JAX package raises on write too, but not
            with pytest.raises(TypeError):      # always a TypeError
                x[make(ndm, ctx)] = 5.0


@pytest.mark.parametrize('key', sorted(_KEYS_TAKEN))
def test_integer_keys_index_as_in_jax(key):
    make = _KEYS_TAKEN[key]
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    got = nd.array(a, ctx=cpu())[make(nd, cpu())]
    want = mx.nd.array(a, ctx=mx.cpu())[make(mx.nd, mx.cpu())]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def test_ndarray_copies_contexts_and_out():
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    x = nd.from_torch(t)
    assert x.context == cpu() and x.handle is t
    host = x.asnumpy()
    host[0, 0] = 100                     # the caller owns its copy
    assert t[0, 0] == 0
    y = x.copy()
    assert y.handle.data_ptr() != t.data_ptr()
    np.testing.assert_array_equal(y.asnumpy(), t.numpy())
    z = nd.zeros((2, 3), ctx=cpu())
    assert x.copyto(z) is z
    np.testing.assert_array_equal(z.asnumpy(), t.numpy())
    assert x.as_in_context(cpu()) is x
    assert x.copyto(cpu()).context == cpu()
    x.wait_to_read()
    # out=: the result lands in the given array; its shape must match
    out = nd.zeros((2, 3), ctx=cpu())
    assert nd.softmax(x, out=out) is out
    np.testing.assert_allclose(out.asnumpy(), torch.softmax(t, -1).numpy(),
                               **F32)
    with pytest.raises(ValueError, match='out has shape'):
        nd.softmax(x, out=nd.zeros((3, 2), ctx=cpu()))


def test_constructors_default_to_the_card():
    """No quiet CPU fallback: without CUDA the default context raises."""
    if torch.cuda.is_available():
        pytest.skip('this machine has a card; the default context is valid')
    for make in (lambda: nd.array([1.0]), lambda: nd.zeros((2,)),
                 lambda: nd.full((2,), 1.0)):
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            make()


# bench's transformer at the small width of test_torch_transformer.py
SMALL = {'MXTPU_BENCH_DMODEL': '256', 'MXTPU_BENCH_LAYERS': '2',
         'MXTPU_BENCH_SEQ': '128', 'MXTPU_BENCH_VOCAB': '512',
         'MXTPU_BENCH_BATCH': '1'}
CFG = TransformerConfig(vocab=512, d_model=256, n_layers=2, seq_len=128)


@pytest.fixture(scope='module')
def bench_step():
    """(fwd, masters, tokens, labels) of bench's transformer step at SMALL."""
    spec = importlib.util.spec_from_file_location(
        '_bench_under_test', os.path.join(ROOT, 'bench.py'))
    bench = importlib.util.module_from_spec(spec)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in SMALL.items():
            mp.setenv(k, v)
        spec.loader.exec_module(bench)
        step, masters, _aux, _vel, tokens, labels, _key = \
            bench.build_transformer_step()
    cells = dict(zip(step.__code__.co_freevars,
                     (c.cell_contents for c in step.__closure__)))
    return cells['fwd'], masters, np.array(tokens), np.array(labels)


def test_bench_batch_draws_bench_tokens_and_labels(bench_step):
    _fwd, _masters, tokens, labels = bench_step
    mine = bench_batch(CFG, 1)
    np.testing.assert_array_equal(mine[0], tokens)
    np.testing.assert_array_equal(mine[1], labels)
    assert mine[0].dtype == mine[1].dtype == np.int32


def test_bench_loss_through_both_nd_namespaces(monkeypatch, bench_step):
    """The slice as a whole: bench's loss mean(lse - gold) on its small
    forward's f32 logits and its labels, as nd.softmax_cross_entropy / N in
    both packages, with the kernel branch on."""
    monkeypatch.setenv('MXTPU_FORCE_PALLAS', '1')
    fwd, masters, tokens, labels = bench_step
    V, N = CFG.vocab, labels.size
    logits = jax.jit(fwd)(masters, jnp.asarray(tokens)).astype(jnp.float32)
    lse = jax.nn.logsumexp(logits, -1)
    gold = jnp.take_along_axis(logits, jnp.asarray(labels)[..., None], -1)[..., 0]
    bench_loss = float(jnp.mean(lse - gold))

    want = mx.nd.softmax_cross_entropy(
        mx.nd.array(np.asarray(logits).reshape(-1, V), ctx=mx.cpu()),
        mx.nd.array(labels.reshape(-1), ctx=mx.cpu())).asscalar() / N

    model = TransformerLM(CFG, dtype=torch.float32, device='cpu',
                          attention=flash_attention_ref)
    model.load_state_dict(params_from_jax(masters))
    with torch.inference_mode():
        port_logits = model(torch.from_numpy(tokens)).float()
    got = nd.softmax_cross_entropy(
        nd.from_torch(port_logits.reshape(-1, V)),
        nd.array(labels.reshape(-1), ctx=cpu())).asscalar() / N

    assert np.isfinite(got)
    np.testing.assert_allclose(want, bench_loss, rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
