"""The port's mx.rtc (mxnet_tpu_torch.rtc.Rtc) against the JAX package's
(mxnet_tpu.rtc.Rtc), on the CPU: tests/unittest/test_rtc.py case by case.

The JAX package's 'jnp' mode is the port's 'torch' mode, with the same
bodies where the source is shared (torch.sqrt for jnp.sqrt); its 'pallas'
mode is the port's 'cuda' mode, kernel K7, which runs on the card only.
Here the cuda mode's decorated source is checked exactly, its refusals
(CPU tensors, geometries the card does not take) are checked before any
launch, and, where g++ is on PATH, the decorated sources of chip_smoke.py's
user kernels k7a-k7d are parsed as C++ under a small header that stands in
for CUDA's (a C++ error only nvcc or NVRTC would see otherwise shows on the
card). chip_smoke.py phase (i) compiles and runs them there.

Tolerances: results of the same f32 arithmetic in both packages agree
within rtol 1e-6 (sqrt within 2 ulps); x * 3 and 2 * x + 1 are exact.
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu_torch import MXNetError, cpu, nd
from mxnet_tpu_torch.ops import nvrtc
from mxnet_tpu_torch.rtc import Rtc, launch_geometry
from mxnet_tpu_torch.transformer import TransformerConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the user kernels k7a-k7d)


def _pair(values, dtype='float32'):
    return nd.array(values, ctx=cpu(), dtype=dtype), mx.nd.array(values, dtype=dtype)


def test_rtc_torch_elementwise():
    x, jx = _pair(np.arange(10, dtype=np.float32))
    y, jy = nd.zeros((10,), ctx=cpu()), mx.nd.zeros((10,))
    Rtc('saxpy', [('x', x)], [('y', y)], 'y = 2.0 * x + 1.0').push([x], [y])
    mx.rtc.Rtc('saxpy', [('x', jx)], [('y', jy)], 'y = 2.0 * x + 1.0').push([jx], [jy])
    np.testing.assert_array_equal(y.asnumpy(), jy.asnumpy())
    np.testing.assert_array_equal(y.asnumpy(), 2 * np.arange(10) + 1)


def test_rtc_torch_two_inputs_two_outputs():
    (a, ja), (b, jb) = _pair([1.0, 2.0, 3.0]), _pair([10.0, 20.0, 30.0])
    s, d = nd.zeros((3,), ctx=cpu()), nd.zeros((3,), ctx=cpu())
    js, jd = mx.nd.zeros((3,)), mx.nd.zeros((3,))
    body = 's = a + b\nd = b - a'
    Rtc('sumdiff', [('a', a), ('b', b)], [('s', s), ('d', d)], body).push([a, b], [s, d])
    mx.rtc.Rtc('sumdiff', [('a', ja), ('b', jb)], [('s', js), ('d', jd)],
               body).push([ja, jb], [js, jd])
    np.testing.assert_array_equal(s.asnumpy(), js.asnumpy())
    np.testing.assert_array_equal(d.asnumpy(), [9, 18, 27])


def test_rtc_torch_uses_torch_functions():
    x, jx = _pair([0.0, 1.0, 4.0])
    y, jy = nd.zeros((3,), ctx=cpu()), mx.nd.zeros((3,))
    Rtc('k', [('x', x)], [('y', y)],
        'y = torch.sqrt(x) + torch.sin(x) * 0.0').push([x], [y])
    mx.rtc.Rtc('k', [('x', jx)], [('y', jy)],
               'y = jnp.sqrt(x) + jnp.sin(x) * 0.0').push([jx], [jy])
    np.testing.assert_allclose(y.asnumpy(), jy.asnumpy(), rtol=1e-6)


def test_rtc_outputs_take_the_pushed_ndarrays_dtype_and_shape():
    """As in the JAX package, each result is cast and reshaped to the
    NDArray it is pushed into."""
    x, jx = _pair(np.arange(6, dtype=np.float32))
    y, jy = nd.zeros((2, 3), ctx=cpu(), dtype='int32'), mx.nd.zeros((2, 3), dtype='int32')
    Rtc('half', [('x', x)], [('y', y)], 'y = x / 2').push([x], [y])
    mx.rtc.Rtc('half', [('x', jx)], [('y', jy)], 'y = x / 2').push([jx], [jy])
    assert y.dtype == jy.dtype and y.shape == jy.shape == (2, 3)
    np.testing.assert_array_equal(y.asnumpy(), jy.asnumpy())


def test_rtc_pallas_triple_and_its_cuda_counterpart():
    """The JAX test's pallas kernel 'triple' against the same function in
    torch mode here; the cuda body of chip_smoke.py (k7b) decorates into a
    kernel over x and y, and refuses CPU tensors without launching."""
    x, jx = _pair(np.arange(8, dtype=np.float32))
    jy = mx.nd.zeros((8,))
    src = '''
def kernel(x_ref, y_ref):
    y_ref[...] = x_ref[...] * 3.0
'''
    mx.rtc.Rtc('triple', [('x', jx)], [('y', jy)], src, mode='pallas').push([jx], [jy])
    y = nd.zeros((8,), ctx=cpu())
    Rtc('triple', [('x', x)], [('y', y)], 'y = x * 3.0').push([x], [y])
    np.testing.assert_array_equal(y.asnumpy(), jy.asnumpy())
    k = Rtc('triple', [('x', x)], [('y', y)], chip_smoke.K7B_TRIPLE, mode='cuda')
    src = k.cuda_source([(8,)], [torch.float32])
    assert src.startswith('extern "C" __global__ void triple(const float* '
                          '__restrict__ x, float* y) {')
    before = (nvrtc.launch.launches, k.launches)
    with pytest.raises(ValueError, match='CUDA tensors'):
        k.push([x], [y])
    assert (nvrtc.launch.launches, k.launches) == before


def test_rtc_arg_validation():
    x, jx = nd.zeros((2,), ctx=cpu()), mx.nd.zeros((2,))
    y, jy = nd.zeros((2,), ctx=cpu()), mx.nd.zeros((2,))
    rtc, jrtc = Rtc('id', [('x', x)], [('y', y)], 'y = x'), \
        mx.rtc.Rtc('id', [('x', jx)], [('y', jy)], 'y = x')
    for r, args in ((rtc, ([x, x], [y])), (jrtc, ([jx, jx], [jy])),
                    (rtc, ([x], [y, y])), (jrtc, ([jx], [jy, jy]))):
        with pytest.raises(ValueError, match='expected'):
            r.push(*args)
    with pytest.raises(ValueError):
        mx.rtc.Rtc('bad', [('x', jx)], [('y', jy)], 'y = x', mode='cuda')
    with pytest.raises(ValueError, match="'torch' or 'cuda'"):
        Rtc('bad', [('x', x)], [('y', y)], 'y = x', mode='bogus')
    for mode, counterpart in (('jnp', 'torch'), ('pallas', 'cuda')):
        with pytest.raises(ValueError, match="counterpart is '%s'" % counterpart):
            Rtc('bad', [('x', x)], [('y', y)], 'y = x', mode=mode)
    with pytest.raises(ValueError):
        mx.rtc.Rtc('nokern', [('x', jx)], [('y', jy)], 'z = 1', mode='pallas')
    with pytest.raises(ValueError, match='empty'):
        Rtc('nokern', [('x', x)], [('y', y)], '  \n', mode='cuda')
    for name, ins in (('2fast', [('x', x)]), ('ok', [('x-1', x)]), ('ok', [('', x)])):
        with pytest.raises(ValueError, match='C identifier'):
            Rtc(name, ins, [('y', y)], 'y[0] = 1;', mode='cuda')


def test_cuda_source_is_exact():
    """A 2-in/1-out kernel over a bf16 and an int32 input: the half headers,
    the signature, and each argument's rank and dims as constants."""
    a = nd.zeros((2, 3), ctx=cpu(), dtype='bfloat16')
    b = nd.zeros((3,), ctx=cpu(), dtype='int32')
    o = nd.zeros((2, 3), ctx=cpu())
    body = '''
    const int i = threadIdx.x;
    if (i < o_dims[1]) o[i] = __bfloat162float(a[i]) + b[i];
    '''
    k = Rtc('mix', [('a', a), ('b', b)], [('o', o)], body, mode='cuda')
    assert k.cuda_source([(2, 3), (3,)], [torch.bfloat16, torch.int32]) == (
        '#include <cuda_fp16.h>\n'
        '#include <cuda_bf16.h>\n'
        'extern "C" __global__ void mix(const __nv_bfloat16* __restrict__ a, '
        'const int* __restrict__ b, float* o) {\n'
        'const int a_ndim = 2;\n'
        'const int a_dims[] = {2, 3};\n'
        'const int b_ndim = 1;\n'
        'const int b_dims[] = {3};\n'
        'const int o_ndim = 2;\n'
        'const int o_dims[] = {2, 3};\n'
        '\n'
        'const int i = threadIdx.x;\n'
        'if (i < o_dims[1]) o[i] = __bfloat162float(a[i]) + b[i];\n'
        '}\n')
    f = k.cuda_source([(5,), ()], [torch.float32, torch.int64])
    assert 'const float* __restrict__ a, const long long* __restrict__ b' in f
    assert 'const int b_ndim = 0;\nconst int b_dims[] = {1};' in f
    assert '#include' not in f
    with pytest.raises(TypeError, match='cuda-mode Rtc takes'):
        k.cuda_source([(2, 3), (3,)], [torch.complex64, torch.int32])


@pytest.mark.parametrize('grid,block,n,want', [
    (None, None, 1000, ((4, 1, 1), (256, 1, 1))),       # one thread an element
    (None, None, 0, ((1, 1, 1), (256, 1, 1))),
    ((8192,), (256,), 0, ((8192, 1, 1), (256, 1, 1))),
    ((2, 3, 4), (8, 8, 16), 0, ((2, 3, 4), (8, 8, 16))),
    ((1,), (2048,), 0, 'at most 1024 threads'),
    ((1,), (32, 32, 2), 0, 'at most 1024 threads'),
    ((1, 65536), (32,), 0, 'exceed the limits'),
    ((1,), (1, 1, 65), 0, 'exceed the limits'),
    ((1, 1, 1, 1), (32,), 0, '1 to 3 positive ints'),
    ((0,), (32,), 0, '1 to 3 positive ints'),
    ((4,), None, 0, 'both'),
])
def test_launch_geometry(grid, block, n, want):
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            launch_geometry(grid, block, n)
    else:
        assert launch_geometry(grid, block, n) == want


def test_refusals_come_before_any_launch():
    """A geometry the card does not take raises ValueError before the
    device is looked at; CPU tensors raise; the compiler refuses CPU."""
    x, y = nd.zeros((4,), ctx=cpu()), nd.zeros((4,), ctx=cpu())
    k = Rtc('k', [('x', x)], [('y', y)], 'y[0] = x[0];', mode='cuda')
    before = nvrtc.launch.launches
    with pytest.raises(ValueError, match='1024 threads'):
        k.push([x], [y], grid_dims=(1,), block_dims=(2048,))
    with pytest.raises(ValueError, match='CUDA tensors'):
        k.push([x], [y], grid_dims=(1,), block_dims=(4,))
    with pytest.raises(ValueError, match='CUDA devices'):
        nvrtc.compile_kernel('extern "C" __global__ void k() {}', 'k', 'cpu')
    assert nvrtc.launch.launches == before and k.launches == 0


def test_nvrtc_without_the_toolkit_raises(monkeypatch):
    """NVRTC is the toolkit's: without a toolkit it raises MXNetError, and
    no other libnvrtc is looked for."""
    monkeypatch.setattr(nvrtc, '_toolkit', lambda: None)
    monkeypatch.setattr(nvrtc, '_libs', {})
    with pytest.raises(MXNetError, match='no CUDA toolkit'):
        nvrtc.info()


# A stand-in for the CUDA headers and built-ins the user kernels use, enough
# for g++ to parse the decorated sources as C++.
_SHIM = '''
#pragma once
#include <cmath>
#define __global__
#define __shared__ static
struct __mxtt_dim3 { unsigned x, y, z; };
extern __mxtt_dim3 threadIdx, blockIdx, blockDim, gridDim;
inline void __syncthreads() {}
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
struct __half { unsigned short bits; };
struct __nv_bfloat16 { unsigned short bits; };
float __bfloat162float(__nv_bfloat16);
__nv_bfloat16 __float2bfloat16_rn(float);
__nv_bfloat16 __float2bfloat16(float);
float __half2float(__half);
__half __float2half_rn(float);
'''


def test_user_kernel_sources_parse_as_cpp(tmp_path):
    """k7a-k7d as chip_smoke.py decorates them, at a small width, through
    g++ -fsyntax-only under the shim header."""
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('g++ is not on PATH')
    (tmp_path / 'shim.h').write_text(_SHIM)
    for name in ('cuda_fp16.h', 'cuda_bf16.h'):
        (tmp_path / name).write_text('#pragma once\n')
    cfg = TransformerConfig(vocab=64, d_model=128, n_layers=1, seq_len=16)
    for name, spec in chip_smoke.rtc_kernels(cfg, batch=2).items():
        k = chip_smoke.make_rtc(name, spec, cpu())
        src = k.cuda_source([s for _, s, _ in spec[1]],
                            [getattr(torch, d) for _, _, d in spec[1]])
        path = tmp_path / (name + '.cpp')
        path.write_text(src)
        res = subprocess.run([gxx, '-std=c++17', '-fsyntax-only', '-Werror=return-type',
                              '-include', str(tmp_path / 'shim.h'), '-I', str(tmp_path),
                              str(path)], capture_output=True, text=True, timeout=60)
        assert res.returncode == 0, '%s:\n%s\n%s' % (name, src, res.stderr)
