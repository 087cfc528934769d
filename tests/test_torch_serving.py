"""The port's serving engine over a torch forward
(mxnet_tpu_torch.serving.ServingEngine.from_forward) against the batching
contract of the JAX package's (mxnet_tpu.serving.engine): the same bucket
ladder, zero-row padding up to the smallest covering bucket, pad rows
stripped on axis 0, chunking past the largest bucket, and the same
ValueErrors. Forwards here are exact (integer-valued arithmetic) so that
pad and strip are checked bit for bit; the model-level parity with bench's
forward is in test_torch_transformer.py.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

from mxnet_tpu.serving.engine import bucket_ladder as jax_bucket_ladder
from mxnet_tpu_torch.serving import ServingEngine, bucket_ladder


def _row_sums(x):
    """Per-example forward: row sums and a doubled copy (exact in f32)."""
    x = x.float()
    return x.sum(-1, keepdim=True), x * 2


def _engine(max_batch=4, descs=(('x', (3,), np.float32),), fwd=_row_sums,
            **kw):
    return ServingEngine.from_forward(fwd, list(descs),
                                      output_names=['sum', 'double'],
                                      max_batch=max_batch, device='cpu', **kw)


def test_bucket_ladder_matches_jax():
    for n in range(1, 41):
        assert bucket_ladder(n) == jax_bucket_ladder(n), n
    for bad in (0, -3):
        with pytest.raises(ValueError):
            bucket_ladder(bad)
        with pytest.raises(ValueError):
            jax_bucket_ladder(bad)


@pytest.mark.parametrize('rows,buckets', [
    (1, [1]), (3, [4]), (4, [4]),
    (11, [4, 4, 4]),        # chunked: 4 + 4 + 3, the last padded to 4
    (9, [4, 4, 1]),
])
def test_pad_strip_and_chunking_are_exact(rows, buckets):
    eng = _engine(max_batch=4)
    x = np.arange(rows * 3, dtype=np.float32).reshape(rows, 3)
    chunks = eng.dispatch_rows([x])
    assert [b for _, _, b in chunks] == buckets
    assert sum(r for _, r, _ in chunks) == rows
    for outs, r, b in chunks:
        assert all(o.shape[0] == b for o in outs)     # padded on the device
    sums, doubled = eng.fetch_chunks(chunks)
    np.testing.assert_array_equal(sums, x.sum(-1, keepdims=True))
    np.testing.assert_array_equal(doubled, x * 2)
    timings = {}
    again = eng.fetch_chunks(eng.dispatch_rows(x, timings=timings),
                             timings=timings)
    np.testing.assert_array_equal(again[1], x * 2)
    assert set(timings) == {'pad_ms', 'dispatch_ms', 'fetch_ms'}


def test_pad_rows_are_zeros():
    seen = []

    def fwd(x):
        seen.append(x.clone())
        return x

    eng = _engine(max_batch=8, fwd=fwd)
    out = eng.infer(np.ones((5, 3), np.float32))[0]
    assert out.shape == (5, 3) and (out == 1).all()
    assert seen[0].shape == (8, 3)
    assert (seen[0][5:] == 0).all() and (seen[0][:5] == 1).all()


def test_bucket_for():
    eng = _engine(max_batch=6)
    assert eng.buckets == [1, 2, 4, 6]
    assert [eng.bucket_for(r) for r in (1, 2, 3, 5, 6)] == [1, 2, 4, 6, 6]
    with pytest.raises(ValueError, match='exceeds the largest bucket'):
        eng.bucket_for(7)


def test_bad_requests_raise():
    two = _engine(descs=(('a', (3,), np.float32), ('b', (2,), np.int32)),
                  fwd=lambda a, b: (a.sum(-1), b.float().sum(-1)))
    with pytest.raises(ValueError, match='expected 2 input arrays'):
        two.infer([np.zeros((2, 3))])
    with pytest.raises(ValueError, match='per-example shape'):
        two.infer([np.zeros((2, 4)), np.zeros((2, 2))])
    with pytest.raises(ValueError, match='empty request'):
        two.infer([np.zeros((0, 3)), np.zeros((0, 2))])
    with pytest.raises(ValueError, match='disagree on the row count'):
        two.infer([np.zeros((2, 3)), np.zeros((3, 2))])
    a, b = two.infer([np.ones((3, 3)), np.ones((3, 2))])
    np.testing.assert_array_equal(a, [3, 3, 3])
    np.testing.assert_array_equal(b, [2, 2, 2])


def test_inputs_cast_and_bf16_outputs_widen():
    eng = _engine(descs=(('tokens', (4,), np.int32),),
                  fwd=lambda t: (t.dtype == torch.int32) * t.to(torch.bfloat16) / 3)
    out = eng.infer([np.array([[1.0, 2.0, 3.0, 4.0]])])[0]
    # bf16 leaves the engine as bf16, bit for bit, as the JAX engine's does
    want = torch.tensor([[1, 2, 3, 4]]).to(torch.bfloat16) / 3
    assert out.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(out.view(np.int16),
                                  want.view(torch.int16).numpy())


def test_warmup_and_describe():
    eng = _engine(max_batch=5, descs=(('x', (3,), np.float32),))
    assert not eng.describe()['warmed']
    assert eng.warmup() == 4
    assert eng.describe() == {
        'name': 'model', 'buckets': [1, 2, 4, 5], 'max_batch': 5,
        'inputs': [{'name': 'x', 'shape': [3], 'dtype': 'float32'}],
        'outputs': ['sum', 'double'], 'warmed': True}


def test_max_batch_flag(monkeypatch):
    monkeypatch.delenv('MXTPU_SERVE_MAX_BATCH', raising=False)
    assert _engine(max_batch=None).max_batch == 32
    monkeypatch.setenv('MXTPU_SERVE_MAX_BATCH', '6')
    assert _engine(max_batch=None).buckets == [1, 2, 4, 6]
    for bad in ('0', 'x', '70000'):
        monkeypatch.setenv('MXTPU_SERVE_MAX_BATCH', bad)
        with pytest.raises(ValueError, match='MXTPU_SERVE_MAX_BATCH'):
            _engine(max_batch=None)


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('this machine has a card; the default device is valid')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        ServingEngine.from_forward(_row_sums, [('x', (3,), np.float32)],
                                   max_batch=2)
