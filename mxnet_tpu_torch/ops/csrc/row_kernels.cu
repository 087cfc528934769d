// Row kernels for Hopper (sm_90a), bound through a plain C interface
// (mxnet_tpu_torch/ops/cuda_kernels.py loads it with ctypes). Four kernels,
// each over N rows of a row-major [N, D] array:
//
//   * layernorm_kernel replaces mxnet_tpu/ops/pallas_kernels.py::
//     _layernorm_kernel (fused_layernorm, via _norm_call): f32 mean, then the
//     two-pass variance mean((x - mean)^2) (not E[x^2] - mean^2, which loses
//     the variance of rows with a large mean), y = (x - mean) * rsqrt(var +
//     eps) * gamma + beta in f32, stored in x's type;
//   * rmsnorm_kernel replaces _rmsnorm_kernel (fused_rmsnorm):
//     y = x * rsqrt(mean(x^2) + eps) * gamma, f32 inside, stored in x's type;
//   * softmax_kernel replaces _softmax_kernel (fused_softmax): the row max,
//     the sum of exp(x - max), then exp(x - max) / sum, f32 inside, stored in
//     x's type;
//   * xent_kernel replaces _xent_kernel (softmax_xent): per row
//     log(sum(exp(x - max))) + max - x[label] as f32. A label outside
//     [0, V) matches no column, as the TPU kernel's one-hot compare does:
//     its gold logit is 0 and its loss the row's logsumexp. Such a label is
//     never used as an address.
//
// gamma and beta are read as f32 from f32, bf16 or f16 arrays whatever x's
// type is. Statistics are f32.
//
// What the TPU version did that this one does not: it padded N to a
// Mosaic-legal block (_pad_and_block) and walked blocks of rows in order.
// Here one thread block takes one row (rows on gridDim.x, which reaches
// 2^31 - 1 where y and z stop at 65535), nothing is padded, and the row's
// ragged head and tail are handled in the kernel: each row is read with
// 16-byte vector loads from its first 16-byte boundary on, with scalar
// loads before it and after the last whole vector, so any row width and any
// row alignment work. Offsets are 64-bit.
//
// What bounds them on an H100: bytes. Each reads its input once from device
// memory and writes its output once; the FLOPs (a handful per element, one
// exp for the softmax and xent) are far below the f32 rate. This first
// version makes two or three passes over a row (statistics, then output),
// the later passes hitting L1/L2, and reduces with warp shuffles and one
// shared-memory exchange between warps. PERF.md keeps its measured times.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr long long kMaxRows = 2147483647LL;  // gridDim.x

// --- element types -------------------------------------------------------

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

// dtype codes shared with the wrapper: 0 = float32, 1 = bfloat16, 2 = float16
__device__ __forceinline__ float load_param(const void* p, int code, long long i) {
  if (code == 0) return static_cast<const float*>(p)[i];
  if (code == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return __half2float(static_cast<const __half*>(p)[i]);
}

template <typename T>
struct Vec {
  static constexpr int n = 16 / int(sizeof(T));
};

// --- walking a row -------------------------------------------------------

// Elements of `row` before its first 16-byte boundary (at most D).
template <typename T>
__device__ __forceinline__ long long head_len(const T* row, long long D) {
  const int mis = int(reinterpret_cast<uintptr_t>(row) & 15);
  const long long h = mis ? (16 - mis) / int(sizeof(T)) : 0;
  return h < D ? h : D;
}

// Calls f(i, x[i] as float) for the elements of the row that this thread
// owns: a scalar head, 16-byte vectors, a scalar tail.
template <typename T, typename F>
__device__ __forceinline__ void for_row(const T* row, long long D, F&& f) {
  constexpr int V = Vec<T>::n;
  const long long head = head_len(row, D);
  const long long nvec = (D - head) / V;
  for (long long i = threadIdx.x; i < head; i += blockDim.x) f(i, to_float(row[i]));
  const uint4* body = reinterpret_cast<const uint4*>(row + head);
  for (long long k = threadIdx.x; k < nvec; k += blockDim.x) {
    const uint4 raw = body[k];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) f(head + k * V + j, to_float(e[j]));
  }
  for (long long i = head + nvec * V + threadIdx.x; i < D; i += blockDim.x)
    f(i, to_float(row[i]));
}

// out[i] = f(i, in[i] as float) rounded to T, over the row. Vector stores
// where `in` and `out` share their offset from a 16-byte boundary (the
// wrapper's freshly allocated output and a contiguous input always do,
// unless the input is a view at an odd offset); scalar otherwise.
template <typename T, typename F>
__device__ __forceinline__ void map_row(const T* in, T* out, long long D, F&& f) {
  constexpr int V = Vec<T>::n;
  if ((reinterpret_cast<uintptr_t>(in) & 15) != (reinterpret_cast<uintptr_t>(out) & 15)) {
    for (long long i = threadIdx.x; i < D; i += blockDim.x)
      out[i] = from_float<T>(f(i, to_float(in[i])));
    return;
  }
  const long long head = head_len(in, D);
  const long long nvec = (D - head) / V;
  for (long long i = threadIdx.x; i < head; i += blockDim.x)
    out[i] = from_float<T>(f(i, to_float(in[i])));
  const uint4* src = reinterpret_cast<const uint4*>(in + head);
  uint4* dst = reinterpret_cast<uint4*>(out + head);
  for (long long k = threadIdx.x; k < nvec; k += blockDim.x) {
    const uint4 raw = src[k];
    const T* e = reinterpret_cast<const T*>(&raw);
    uint4 res;
    T* r = reinterpret_cast<T*>(&res);
#pragma unroll
    for (int j = 0; j < V; ++j) r[j] = from_float<T>(f(head + k * V + j, to_float(e[j])));
    dst[k] = res;
  }
  for (long long i = head + nvec * V + threadIdx.x; i < D; i += blockDim.x)
    out[i] = from_float<T>(f(i, to_float(in[i])));
}

// --- reductions ------------------------------------------------------------

struct SumOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return a + b; }
};

// max that keeps a NaN, as the TPU kernel's jnp max does
struct MaxOp {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return (a != a || a > b) ? a : b;
  }
};

template <typename Op>
__device__ __forceinline__ float warp_reduce(float v, Op op) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The reduction of v over the block (blockDim.x a multiple of 32), returned
// to every thread. `red` is 32 floats of shared memory.
template <typename Op>
__device__ __forceinline__ float block_reduce(float v, Op op, float identity, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_reduce(v, op);
  __syncthreads();  // red may still be read from the previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_reduce(lane < nwarps ? red[lane] : identity, op);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// --- the kernels -------------------------------------------------------------

template <typename T>
__global__ void layernorm_kernel(const T* __restrict__ x, const void* gamma, int g_code,
                                 const void* beta, int b_code, T* __restrict__ y,
                                 long long D, float eps) {
  __shared__ float red[32];
  const long long row = blockIdx.x;
  const T* xr = x + row * D;
  float s = 0.f;
  for_row(xr, D, [&](long long, float v) { s += v; });
  const float mean = block_reduce(s, SumOp(), 0.f, red) / float(D);
  float q = 0.f;
  for_row(xr, D, [&](long long, float v) {
    const float d = v - mean;
    q += d * d;
  });
  const float var = block_reduce(q, SumOp(), 0.f, red) / float(D);
  const float rstd = rsqrtf(var + eps);
  map_row(xr, y + row * D, D, [&](long long i, float v) {
    return (v - mean) * rstd * load_param(gamma, g_code, i) + load_param(beta, b_code, i);
  });
}

template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const void* gamma, int g_code,
                               T* __restrict__ y, long long D, float eps) {
  __shared__ float red[32];
  const long long row = blockIdx.x;
  const T* xr = x + row * D;
  float q = 0.f;
  for_row(xr, D, [&](long long, float v) { q += v * v; });
  const float inv = rsqrtf(block_reduce(q, SumOp(), 0.f, red) / float(D) + eps);
  map_row(xr, y + row * D, D, [&](long long i, float v) {
    return v * inv * load_param(gamma, g_code, i);
  });
}

template <typename T>
__global__ void softmax_kernel(const T* __restrict__ x, T* __restrict__ y, long long D) {
  __shared__ float red[32];
  const long long row = blockIdx.x;
  const T* xr = x + row * D;
  float m = -INFINITY;
  for_row(xr, D, [&](long long, float v) { m = MaxOp()(m, v); });
  m = block_reduce(m, MaxOp(), -INFINITY, red);
  float s = 0.f;
  for_row(xr, D, [&](long long, float v) { s += expf(v - m); });
  s = block_reduce(s, SumOp(), 0.f, red);
  map_row(xr, y + row * D, D, [&](long long, float v) { return expf(v - m) / s; });
}

template <typename T, typename L>
__global__ void xent_kernel(const T* __restrict__ logits, const L* __restrict__ labels,
                            float* __restrict__ loss, long long V) {
  __shared__ float red[32];
  const long long row = blockIdx.x;
  const T* xr = logits + row * V;
  float m = -INFINITY;
  for_row(xr, V, [&](long long, float v) { m = MaxOp()(m, v); });
  m = block_reduce(m, MaxOp(), -INFINITY, red);
  float s = 0.f;
  for_row(xr, V, [&](long long, float v) { s += expf(v - m); });
  s = block_reduce(s, SumOp(), 0.f, red);
  if (threadIdx.x == 0) {
    const long long label = static_cast<long long>(labels[row]);
    const float gold = (label >= 0 && label < V) ? to_float(xr[label]) : 0.f;
    loss[row] = (logf(s) + m) - gold;
  }
}

// --- launching ---------------------------------------------------------------

// One thread for each 16-byte vector of a row, in whole warps, at most
// kMaxThreads.
template <typename T>
int threads_for(long long D) {
  const long long vecs = (D + Vec<T>::n - 1) / Vec<T>::n;
  long long t = (vecs + 31) / 32 * 32;
  if (t < 32) t = 32;
  if (t > kMaxThreads) t = kMaxThreads;
  return int(t);
}

bool bad_shape(long long N, long long D) { return N <= 0 || N > kMaxRows || D <= 0; }
bool bad_code(int code) { return code < 0 || code > 2; }

template <typename T>
cudaError_t launch_layernorm(const void* x, const void* g, int gc, const void* b, int bc,
                             void* y, long long N, long long D, float eps, cudaStream_t s) {
  const int threads = threads_for<T>(D);
  layernorm_kernel<T><<<dim3(unsigned(N)), threads, 0, s>>>(
      static_cast<const T*>(x), g, gc, b, bc, static_cast<T*>(y), D, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rmsnorm(const void* x, const void* g, int gc, void* y, long long N,
                           long long D, float eps, cudaStream_t s) {
  const int threads = threads_for<T>(D);
  rmsnorm_kernel<T><<<dim3(unsigned(N)), threads, 0, s>>>(
      static_cast<const T*>(x), g, gc, static_cast<T*>(y), D, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_softmax(const void* x, void* y, long long N, long long D, cudaStream_t s) {
  const int threads = threads_for<T>(D);
  softmax_kernel<T><<<dim3(unsigned(N)), threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_xent(const void* x, const void* labels, int labels_64, float* loss,
                        long long N, long long V, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(N));
  const int threads = threads_for<T>(V);
  if (labels_64)
    xent_kernel<T, long long><<<grid, threads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const long long*>(labels), loss, V);
  else
    xent_kernel<T, int><<<grid, threads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const int*>(labels), loss, V);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16, for x and for each
// of gamma and beta. x and y are contiguous [N, D]; gamma and beta are
// contiguous [D]. Each entry returns the launch's cudaError_t (0 on
// success), or cudaErrorInvalidValue for a shape or code it does not take
// (N in 1..2^31-1, D >= 1); the launch is asynchronous on `stream`.

int mxtt_layernorm(int dtype, const void* x, const void* gamma, int gamma_dtype,
                   const void* beta, int beta_dtype, void* y, long long N, long long D,
                   float eps, void* stream) {
  if (bad_shape(N, D) || bad_code(gamma_dtype) || bad_code(beta_dtype))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return int(launch_layernorm<float>(x, gamma, gamma_dtype, beta, beta_dtype, y, N, D, eps, s));
    case 1: return int(launch_layernorm<__nv_bfloat16>(x, gamma, gamma_dtype, beta, beta_dtype, y, N, D, eps, s));
    case 2: return int(launch_layernorm<__half>(x, gamma, gamma_dtype, beta, beta_dtype, y, N, D, eps, s));
    default: return int(cudaErrorInvalidValue);
  }
}

int mxtt_rmsnorm(int dtype, const void* x, const void* gamma, int gamma_dtype, void* y,
                 long long N, long long D, float eps, void* stream) {
  if (bad_shape(N, D) || bad_code(gamma_dtype)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return int(launch_rmsnorm<float>(x, gamma, gamma_dtype, y, N, D, eps, s));
    case 1: return int(launch_rmsnorm<__nv_bfloat16>(x, gamma, gamma_dtype, y, N, D, eps, s));
    case 2: return int(launch_rmsnorm<__half>(x, gamma, gamma_dtype, y, N, D, eps, s));
    default: return int(cudaErrorInvalidValue);
  }
}

int mxtt_softmax(int dtype, const void* x, void* y, long long N, long long D, void* stream) {
  if (bad_shape(N, D)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return int(launch_softmax<float>(x, y, N, D, s));
    case 1: return int(launch_softmax<__nv_bfloat16>(x, y, N, D, s));
    case 2: return int(launch_softmax<__half>(x, y, N, D, s));
    default: return int(cudaErrorInvalidValue);
  }
}

// logits [N, V] contiguous; labels [N] contiguous int32 (labels_64 = 0) or
// int64 (labels_64 = 1); loss [N] float32.
int mxtt_softmax_xent(int dtype, const void* logits, const void* labels, int labels_64,
                      void* loss, long long N, long long V, void* stream) {
  if (bad_shape(N, V)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(loss);
  switch (dtype) {
    case 0: return int(launch_xent<float>(logits, labels, labels_64, out, N, V, s));
    case 1: return int(launch_xent<__nv_bfloat16>(logits, labels, labels_64, out, N, V, s));
    case 2: return int(launch_xent<__half>(logits, labels, labels_64, out, N, V, s));
    default: return int(cudaErrorInvalidValue);
  }
}

const char* mxtt_row_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
