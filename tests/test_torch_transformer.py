"""The port's bench transformer (mxnet_tpu_torch.transformer) against bench.py's
own forward, read-only: ``fwd`` is taken from the closure of the train step
that ``bench.build_transformer_step()`` returns, at a small width
(D=256, 2 layers, S=128, V=512, batch 1) set through bench's environment
variables. bench's attention is the Pallas flash kernel in interpret mode;
the port's is its plain version here on the CPU.

Tolerances: f32 logits within 1e-4 (f32 sums in another order over two
layers; logits are O(1)). bf16 logits within a relative RMS error of 2e-2:
bf16 resolves 2**-8, and the two frameworks round at different places
(attention in f32 vs bf16 inputs, GELU, matmul accumulation order).
"""
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu_torch.ops.cuda_kernels import flash_attention_ref
from mxnet_tpu_torch.serving import ServingEngine
from mxnet_tpu_torch.transformer import (TransformerConfig, TransformerLM,
                                         init_params, params_from_jax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {'MXTPU_BENCH_DMODEL': '256', 'MXTPU_BENCH_LAYERS': '2',
         'MXTPU_BENCH_SEQ': '128', 'MXTPU_BENCH_VOCAB': '512',
         'MXTPU_BENCH_BATCH': '1'}
CFG = TransformerConfig(vocab=512, d_model=256, n_layers=2, seq_len=128)


@pytest.fixture(scope='module')
def bench_model():
    """(fwd, masters, tokens) of bench's transformer step at SMALL."""
    spec = importlib.util.spec_from_file_location(
        '_bench_under_test', os.path.join(ROOT, 'bench.py'))
    bench = importlib.util.module_from_spec(spec)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in SMALL.items():
            mp.setenv(k, v)
        spec.loader.exec_module(bench)
        step, masters, _aux, _vel, tokens, _labels, _key = \
            bench.build_transformer_step()
    cells = dict(zip(step.__code__.co_freevars,
                     (c.cell_contents for c in step.__closure__)))
    return cells['fwd'], masters, np.array(tokens)


def _port(masters, dtype, attention=flash_attention_ref):
    model = TransformerLM(CFG, dtype=dtype, device='cpu', attention=attention)
    model.load_state_dict(params_from_jax(masters))
    return model


def test_init_params_draws_bench_weights(bench_model):
    _fwd, masters, _tokens = bench_model
    mine = init_params(CFG, seed=0)
    assert len(mine) == len(masters) == 3 + 6 * CFG.n_layers
    for a, b in zip(mine, masters):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_forward_matches_bench(bench_model, dtype):
    fwd, masters, tokens = bench_model
    want = np.asarray(fwd(tuple(m.astype(getattr(jnp, dtype)) for m in masters),
                          jnp.asarray(tokens))).astype(np.float32)
    with torch.inference_mode():
        got = _port(masters, getattr(torch, dtype))(torch.from_numpy(tokens))
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == want.shape == (1, CFG.seq_len, CFG.vocab)
    got = got.float().numpy()
    if dtype == 'float32':
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        rel = np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2))
        assert rel <= 2e-2, rel


def test_served_logits_match_bench(bench_model):
    """The slice as a whole: the serving engine over the port's model answers
    a 3-row request (chunked 2 + 1 at max_batch=2, the last chunk padded)
    with bench's forward's logits for each row."""
    fwd, masters, _tokens = bench_model
    model = _port(masters, torch.float32)
    engine = ServingEngine.from_forward(
        model, [('tokens', (CFG.seq_len,), np.int32)], max_batch=2,
        device='cpu')
    rows = np.random.RandomState(7).randint(0, CFG.vocab, (3, CFG.seq_len))
    got = engine.infer(rows)[0]
    assert got.shape == (3, CFG.seq_len, CFG.vocab)
    for i in range(3):
        want = np.asarray(fwd(masters, jnp.asarray(rows[i:i + 1], jnp.int32)))
        np.testing.assert_allclose(got[i:i + 1], want, rtol=1e-4, atol=1e-4)


def test_params_from_jax_checks_its_input(bench_model):
    _fwd, masters, _tokens = bench_model
    state = params_from_jax(masters)
    want = TransformerLM(CFG, device='cpu').state_dict()
    assert {n: t.shape for n, t in state.items()} == \
        {n: t.shape for n, t in want.items()}
    with pytest.raises(ValueError, match='3 \\+ 6\\*L'):
        params_from_jax(masters[:-1])
    bad = list(masters)
    bad[2] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match='layers.0.wqkv'):
        params_from_jax(bad)


def test_model_defaults_to_the_card():
    """No quiet CPU fallback: without CUDA the default device raises."""
    if torch.cuda.is_available():
        pytest.skip('this machine has a card; the default device is valid')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        TransformerLM(CFG)


def test_import_leaves_jax_and_the_jax_package_out():
    """The port and chip_smoke.py import neither JAX nor the JAX package,
    and importing them loads no CUDA library."""
    code = ('import sys, mxnet_tpu_torch, mxnet_tpu_torch.transformer, '
            'mxnet_tpu_torch.serving, mxnet_tpu_torch.ops.cuda_kernels, '
            'mxnet_tpu_torch.ops.nn, mxnet_tpu_torch.ops.elemwise, '
            'mxnet_tpu_torch.ops.reduce_ops, mxnet_tpu_torch.ops.nvrtc, '
            'mxnet_tpu_torch.ops.shape_ops, mxnet_tpu_torch.ops.optimizer_ops, '
            'mxnet_tpu_torch.optimizer, mxnet_tpu_torch.lr_scheduler, '
            'mxnet_tpu_torch.rtc, mxnet_tpu_torch.ndarray, chip_smoke, '
            'mxnet_tpu_torch.telemetry, mxnet_tpu_torch.telemetry.export, '
            'mxnet_tpu_torch.serving.batcher, mxnet_tpu_torch.serving.http, '
            'mxnet_tpu_torch.serving.serve_model, mxnet_tpu_torch.recordio, '
            'mxnet_tpu_torch._native, mxnet_tpu_torch.io.image_record, '
            'mxnet_tpu_torch.image, mxnet_tpu_torch.image.detection, '
            'mxnet_tpu_torch.gluon.data, mxnet_tpu_torch.gluon.data.vision, '
            'mxnet_tpu_torch.gluon.utils, mxnet_tpu_torch.module.fused_fit, '
            'mxnet_tpu_torch.ops.rnn_ops, mxnet_tpu_torch.ops.contrib_ops, '
            'mxnet_tpu_torch.rnn, mxnet_tpu_torch.rnn.rnn_cell, '
            'mxnet_tpu_torch.rnn.rnn, mxnet_tpu_torch.rnn.io, '
            'mxnet_tpu_torch.module.bucketing_module, '
            'mxnet_tpu_torch.module.sequential_module, '
            'mxnet_tpu_torch.module.python_module, '
            'mxnet_tpu_torch.gluon.rnn, mxnet_tpu_torch.gluon.rnn.rnn_cell, '
            'mxnet_tpu_torch.gluon.rnn.rnn_layer, '
            'mxnet_tpu_torch.gluon.rnn.basic_init, '
            'mxnet_tpu_torch.ndarray.contrib, mxnet_tpu_torch.symbol.contrib, '
            'mxnet_tpu_torch.serving.step_cache, '
            'mxnet_tpu_torch.ndarray.sparse, mxnet_tpu_torch.ops.sparse_ops, '
            'mxnet_tpu_torch.symbol.sparse, mxnet_tpu_torch.faults, '
            'mxnet_tpu_torch.telemetry.health, '
            'mxnet_tpu_torch.telemetry.dynamics, '
            'mxnet_tpu_torch.parallel, mxnet_tpu_torch.parallel.checkpoint, '
            'mxnet_tpu_torch.module.checkpointing, '
            'mxnet_tpu_torch.module.resilient_fit, '
            'mxnet_tpu_torch.train_supervisor\n'
            'from mxnet_tpu_torch.io import (ImageRecordIter, MNISTIter, '
            'CSVIter, ImageDetRecordIter, MXDataIter)\n'
            'from mxnet_tpu_torch.gluon.data import DataLoader, ArrayDataset\n'
            'from mxnet_tpu_torch.telemetry import (registry, export, flight, '
            'trace, slo, watchdog, serve, cluster)\n'
            'from mxnet_tpu_torch.serving import (ServingEngine, '
            'DynamicBatcher, bucket_ladder, StepCache, DecodeEngine)\n'
            'from mxnet_tpu_torch.module import (BucketingModule, '
            'SequentialModule, PythonModule, PythonLossModule)\n'
            'from mxnet_tpu_torch import nd\n'
            'from mxnet_tpu_torch.rtc import Rtc\n'
            'nd.LayerNorm, nd.softmax, nd.softmax_cross_entropy, nd.add_n, '
            'nd.broadcast_add, nd.sum, nd.arange, nd.waitall, nd.Reshape, '
            'nd.take, nd.concatenate, nd.stack, nd.mp_sgd_mom_update, '
            'nd.RNN, nd.ctc_loss, nd.contrib.CTCLoss\n'
            'from mxnet_tpu_torch.transformer import make_train_step\n'
            '# NVRTC and the driver are loaded at the first compile, not here\n'
            'assert not mxnet_tpu_torch.ops.nvrtc._libs\n'
            'bad = sorted(m for m in sys.modules if m == "jax" '
            'or m.startswith("jax.") or m == "mxnet_tpu" '
            'or m.startswith("mxnet_tpu."))\n'
            'print(bad)\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'
