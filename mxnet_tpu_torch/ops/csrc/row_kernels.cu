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
// exp for the softmax and xent) are far below the f32 rate. The block-per-row
// bodies make two or three passes over a row (statistics, then output), the
// later passes hitting L1/L2, and reduce with warp shuffles and one
// shared-memory exchange between warps. LayerNorm has a second body for rows
// of at most 4 KB that start 16-byte aligned, layernorm_rows_kernel: one warp
// a row, eight rows a block, the row read once into registers (RegRow) and
// reduced twice from there by shuffles alone, with no shared memory and no
// barrier. PERF.md keeps the measured times.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

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

// --- a row held in registers by one warp ------------------------------------

// A row of nvec 16-byte vectors held by the 32 lanes of a warp: lane l holds
// vectors l, l + 32, ..., l + 32 * (VPL - 1), read once with 16-byte loads
// (vectors at or past nvec are not read). The row must start 16-byte aligned.
// Rows of up to 32 * VPL * 16 bytes: 4 KB at VPL = 8.
template <typename T, int VPL>
struct RegRow {
  static constexpr int E = Vec<T>::n;  // elements a vector
  uint4 v[VPL];
  int lane, nvec;

  __device__ __forceinline__ RegRow(const T* row, int nvec_) : lane(threadIdx.x & 31), nvec(nvec_) {
    const uint4* src = reinterpret_cast<const uint4*>(row);
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int k = lane + 32 * i;
      v[i] = k < nvec ? src[k] : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __device__ __forceinline__ bool held(int i) const { return lane + 32 * i < nvec; }
  __device__ __forceinline__ float at(int i, int j) const {
    return to_float(reinterpret_cast<const T*>(&v[i])[j]);
  }
  // The reduction by `op` of f(x) over the row, returned to every lane.
  template <typename Op, typename F>
  __device__ __forceinline__ float reduce(Op op, float identity, F&& f) const {
    float acc = identity;
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      if (held(i)) {
#pragma unroll
        for (int j = 0; j < E; ++j) acc = op(acc, f(at(i, j)));
      }
    return warp_reduce(acc, op);
  }
  // For each vector i this lane holds, f(c0, i, y) fills y[0..E) with the
  // outputs of the row's elements c0 .. c0 + E - 1 (c0 = (lane + 32 i) E;
  // at(i, j) is x[c0 + j]), which go to `out` rounded to T with one 16-byte
  // store; `out` must start 16-byte aligned.
  template <typename F>
  __device__ __forceinline__ void store(T* out, F&& f) const {
    uint4* dst = reinterpret_cast<uint4*>(out);
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      if (held(i)) {
        const int k = lane + 32 * i;
        float y[E];
        f(k * E, i, y);
        uint4 res;
        T* r = reinterpret_cast<T*>(&res);
#pragma unroll
        for (int j = 0; j < E; ++j) r[j] = from_float<T>(y[j]);
        dst[k] = res;
      }
  }
};

// E parameters from index c0 on as f32 (from f32, bf16 or f16), with one or
// two 16-byte loads (8 bytes for four 2-byte values) where `vec` says the
// array starts 16-byte aligned, else one element at a time.
template <int E>
__device__ __forceinline__ void load_params(const void* p, int code, bool vec, long long c0,
                                            float (&out)[E]) {
  if (!vec) {
#pragma unroll
    for (int j = 0; j < E; ++j) out[j] = load_param(p, code, c0 + j);
    return;
  }
  if (code == 0) {
    const float4* src = reinterpret_cast<const float4*>(static_cast<const float*>(p) + c0);
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const float4 f = src[q];
      out[4 * q] = f.x; out[4 * q + 1] = f.y; out[4 * q + 2] = f.z; out[4 * q + 3] = f.w;
    }
    return;
  }
  const uint16_t* half_src = static_cast<const uint16_t*>(p) + c0;
  uint16_t raw[E];
  if constexpr (E == 8) {
    const uint4 w = *reinterpret_cast<const uint4*>(half_src);
    memcpy(raw, &w, sizeof w);
  } else {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const uint2 w = reinterpret_cast<const uint2*>(half_src)[q];
      memcpy(raw + 4 * q, &w, sizeof w);
    }
  }
#pragma unroll
  for (int j = 0; j < E; ++j) {
    if (code == 1) {
      __nv_bfloat16 b;
      *reinterpret_cast<uint16_t*>(&b) = raw[j];
      out[j] = __bfloat162float(b);
    } else {
      __half hv;
      *reinterpret_cast<uint16_t*>(&hv) = raw[j];
      out[j] = __half2float(hv);
    }
  }
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

// LayerNorm with one warp a row and the row in registers: the same
// arithmetic as layernorm_kernel (f32 mean, then the centred variance, then
// (x - mean) * rstd * gamma + beta), read once from device memory.
constexpr int kRowsPerBlock = 8;

template <typename T, int VPL>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
    layernorm_rows_kernel(const T* __restrict__ x, const void* gamma, int g_code,
                          const void* beta, int b_code, T* __restrict__ y, long long N,
                          int D, float eps) {
  const long long row = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= N) return;
  constexpr int E = Vec<T>::n;
  const RegRow<T, VPL> r(x + row * D, D / E);
  const float mean = r.reduce(SumOp(), 0.f, [](float v) { return v; }) / float(D);
  const float var = r.reduce(SumOp(), 0.f, [&](float v) {
    const float d = v - mean;
    return d * d;
  }) / float(D);
  const float rstd = rsqrtf(var + eps);
  const bool g_vec = (reinterpret_cast<uintptr_t>(gamma) & 15) == 0;
  const bool b_vec = (reinterpret_cast<uintptr_t>(beta) & 15) == 0;
  r.store(y + row * D, [&](long long c0, int i, float (&out)[E]) {
    float g[E], b[E];
    load_params<E>(gamma, g_code, g_vec, c0, g);
    load_params<E>(beta, b_code, b_vec, c0, b);
#pragma unroll
    for (int j = 0; j < E; ++j) out[j] = (r.at(i, j) - mean) * rstd * g[j] + b[j];
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

// The register-row LayerNorm: x's rows start 16-byte aligned and hold a
// whole number of 16-byte vectors, at most 4 KB (checked by the entry).
template <typename T>
cudaError_t launch_layernorm_rows(const void* x, const void* g, int gc, const void* b, int bc,
                                  void* y, long long N, long long D, float eps,
                                  cudaStream_t s) {
  const long long nvec = D / Vec<T>::n;
  const dim3 grid(unsigned((N + kRowsPerBlock - 1) / kRowsPerBlock));
  const int threads = 32 * kRowsPerBlock;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (nvec <= 32)
    layernorm_rows_kernel<T, 1><<<grid, threads, 0, s>>>(xt, g, gc, b, bc, yt, N, int(D), eps);
  else if (nvec <= 64)
    layernorm_rows_kernel<T, 2><<<grid, threads, 0, s>>>(xt, g, gc, b, bc, yt, N, int(D), eps);
  else if (nvec <= 128)
    layernorm_rows_kernel<T, 4><<<grid, threads, 0, s>>>(xt, g, gc, b, bc, yt, N, int(D), eps);
  else
    layernorm_rows_kernel<T, 8><<<grid, threads, 0, s>>>(xt, g, gc, b, bc, yt, N, int(D), eps);
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

// body: 0 = one block a row (any row), 1 = one warp a row with the row in
// registers (x 16-byte aligned, rows of a whole number of 16-byte vectors up
// to 4 KB; cudaErrorInvalidValue otherwise).
int mxtt_layernorm(int body, int dtype, const void* x, const void* gamma, int gamma_dtype,
                   const void* beta, int beta_dtype, void* y, long long N, long long D,
                   float eps, void* stream) {
  if (bad_shape(N, D) || bad_code(gamma_dtype) || bad_code(beta_dtype) || bad_code(dtype) ||
      (body != 0 && body != 1))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    const long long row_bytes = D * (dtype == 0 ? 4 : 2);
    if (row_bytes % 16 || row_bytes > 4096 || reinterpret_cast<uintptr_t>(x) % 16 ||
        reinterpret_cast<uintptr_t>(y) % 16)
      return int(cudaErrorInvalidValue);
    switch (dtype) {
      case 0: return int(launch_layernorm_rows<float>(x, gamma, gamma_dtype, beta, beta_dtype, y, N, D, eps, s));
      case 1: return int(launch_layernorm_rows<__nv_bfloat16>(x, gamma, gamma_dtype, beta, beta_dtype, y, N, D, eps, s));
      default: return int(launch_layernorm_rows<__half>(x, gamma, gamma_dtype, beta, beta_dtype, y, N, D, eps, s));
    }
  }
  switch (dtype) {
    case 0: return int(launch_layernorm<float>(x, gamma, gamma_dtype, beta, beta_dtype, y, N, D, eps, s));
    case 1: return int(launch_layernorm<__nv_bfloat16>(x, gamma, gamma_dtype, beta, beta_dtype, y, N, D, eps, s));
    default: return int(launch_layernorm<__half>(x, gamma, gamma_dtype, beta, beta_dtype, y, N, D, eps, s));
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
