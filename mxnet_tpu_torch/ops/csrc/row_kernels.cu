// Row kernels for Hopper (sm_90a), bound through a plain C interface
// (mxnet_tpu_torch/ops/cuda_kernels.py loads it with ctypes). Four kernels,
// each over N rows of a row-major [N, D] array:
//
//   * layernorm replaces mxnet_tpu/ops/pallas_kernels.py::_layernorm_kernel
//     (fused_layernorm, via _norm_call): f32 mean, then the two-pass
//     variance mean((x - mean)^2) (not E[x^2] - mean^2, which loses the
//     variance of rows with a large mean), y = (x - mean) * rsqrt(var + eps)
//     * gamma + beta in f32, stored in x's type;
//   * rmsnorm replaces _rmsnorm_kernel (fused_rmsnorm):
//     y = x * rsqrt(mean(x^2) + eps) * gamma, f32 inside, stored in x's type;
//   * softmax replaces _softmax_kernel (fused_softmax): the row max, the sum
//     of exp(x - max), then exp(x - max) / sum, f32 inside, stored in x's
//     type;
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
// Here nothing is padded and every kernel takes any row count up to
// 2^31 - 1 with 64-bit offsets.
//
// What bounds them on an H100: bytes. Each reads its input once from device
// memory and writes its output once; the FLOPs (a handful per element, one
// exp for the softmax and xent) are far below the f32 rate.
//
// Each kernel has a block-per-row body that takes any row: one block a row
// (rows on gridDim.x), the row's ragged head and tail handled in the kernel
// (16-byte vector loads from its first 16-byte boundary on, scalar loads
// before it and after the last whole vector), two or three passes over the
// row (statistics, then output; the later passes hit L1/L2), reduced with
// warp shuffles and one shared-memory exchange between warps. Rows of at
// most 4 KB that start 16-byte aligned and hold a whole number of 16-byte
// vectors take a second body that reads the row once into registers
// (RegRow) and reduces it by shuffles alone, with no barrier:
//
//   * LayerNorm: layernorm_rows_kernel, one warp a row, eight rows a block;
//   * softmax and RMSNorm: row_stream_kernel, a persistent kernel (two
//     blocks an SM) that streams groups of eight rows through a ring of
//     stages in shared memory, each stage filled by one bulk async copy
//     (TMA's 1-D form) on an mbarrier, one consumer warp a row. The loads of
//     later groups are in flight while earlier rows reduce and store, and
//     the softmax takes one exp an element, kept in registers.
//
// The wrapper picks the body; PERF.md keeps the measured times.
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

// --- the row-streaming body (softmax, RMSNorm) -----------------------------

// One row held in registers (RegRow) turned into its output. Each op reduces
// the row by warp shuffles, calls release() once every lane's values have
// been consumed by the first reduction (so the row's loads have completed),
// then writes the row to `out` with 16-byte stores.

// softmax: the row max (NaN kept, as MaxOp does), e = 2^((x - max) log2 e)
// once an element, kept in registers, their sum, and e times one
// reciprocal of the sum. A -inf element gives exactly 0; a row that is all
// -inf or holds a NaN gives NaN, as the plain version does.
struct SoftmaxRowOp {
  template <typename T, int VPL, typename R>
  __device__ __forceinline__ void operator()(const RegRow<T, VPL>& r, T* out,
                                             R&& release) const {
    constexpr int E = Vec<T>::n;
    constexpr float kLog2e = 1.4426950408889634f;
    const float m = r.reduce(MaxOp(), -INFINITY, [](float v) { return v; });
    release();
    float e[VPL][E];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      if (r.held(i)) {
#pragma unroll
        for (int j = 0; j < E; ++j) {
          e[i][j] = exp2f((r.at(i, j) - m) * kLog2e);
          s += e[i][j];
        }
      }
    const float inv = 1.f / warp_reduce(s, SumOp());
    r.store(out, [&](long long, int i, float (&y)[E]) {
#pragma unroll
      for (int j = 0; j < E; ++j) y[j] = e[i][j] * inv;
    });
  }
};

// RMSNorm: x * rsqrt(mean(x^2) + eps) * gamma, the arithmetic of
// rmsnorm_kernel, gamma read as f32 from f32, bf16 or f16.
struct RmsNormRowOp {
  const void* gamma;
  int g_code;
  bool g_vec;  // gamma starts 16-byte aligned
  int D;
  float eps;

  template <typename T, int VPL, typename R>
  __device__ __forceinline__ void operator()(const RegRow<T, VPL>& r, T* out,
                                             R&& release) const {
    constexpr int E = Vec<T>::n;
    const float q = r.reduce(SumOp(), 0.f, [](float v) { return v * v; });
    release();
    const float inv = rsqrtf(q / float(D) + eps);
    r.store(out, [&](long long c0, int i, float (&y)[E]) {
      float g[E];
      load_params<E>(gamma, g_code, g_vec, c0, g);
#pragma unroll
      for (int j = 0; j < E; ++j) y[j] = r.at(i, j) * inv * g[j];
    });
  }
};

// mbarriers and the bulk copy (TMA's 1-D form: no tensor map, 16-byte
// aligned addresses, a size that is a multiple of 16).
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
  }
}
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar) : "memory");
}

// The row-streaming kernel: softmax (K5) and RMSNorm (K6) on rows that
// start 16-byte aligned, hold a whole number of 16-byte vectors and are at
// most 4 KB. Bytes bound it, as they bound every row kernel: each element
// is read once and written once, with one exp (softmax) or two multiplies
// (RMSNorm) beside it.
//
// A persistent grid (two blocks an SM) walks groups of kStreamWarps
// contiguous rows, a block taking every gridDim.x-th group. Each block keeps
// a ring of `stages` groups in dynamic shared memory. One producer thread
// fills a stage with a single bulk async copy of the group's rows (the last
// group copies only the rows that exist), posting the byte count on the
// stage's "full" mbarrier; each consumer warp waits on it, reads its row
// into registers with 16-byte shared loads, arrives on the stage's "empty"
// mbarrier once its first reduction has consumed them, finishes the row by
// shuffles alone and stores it with 16-byte stores. The producer refills a
// stage when all consumer warps have arrived on its empty barrier, so the
// next stages' loads are in flight while a group reduces and stores.
//
// What this does about the block-per-row bodies' costs: one read of the row
// from device memory instead of two or three passes, no __syncthreads and
// no shared-memory exchange for the reductions, one exp an element (the
// block softmax took two expf and an IEEE divide), and loads that overlap
// the stores of earlier rows (a one-wave warp-per-row kernel loads, then
// stores).
constexpr int kStreamWarps = 8;                 // consumer warps: rows a stage
constexpr int kStreamThreads = 32 * (kStreamWarps + 1);
constexpr int kStreamBlocksPerSm = 2;
constexpr int kStreamRingBytes = 96 * 1024;     // the ring, at most, a block
constexpr int kStreamMaxStages = 8;
constexpr int kStreamBarBytes = 16 * kStreamMaxStages;  // full and empty barriers

template <typename T, int VPL, typename Op>
__global__ void __launch_bounds__(kStreamThreads, kStreamBlocksPerSm)
    row_stream_kernel(const T* __restrict__ x, T* __restrict__ y, long long N, int D,
                      int stages, Op op) {
  extern __shared__ __align__(16) unsigned char stream_smem[];
  const uint32_t bars = smem_u32(stream_smem);  // full[s] at 8 s, empty[s] after them
  const unsigned char* ring = stream_smem + kStreamBarBytes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t row_bytes = uint32_t(D) * uint32_t(sizeof(T));
  const uint32_t stage_bytes = kStreamWarps * row_bytes;
  const long long groups = (N + kStreamWarps - 1) / kStreamWarps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStreamMaxStages + s), kStreamWarps);  // lane 0 of each
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kStreamWarps) {
    // ---- producer: one thread ----
    if (lane == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
        mbar_wait(bars + 8 * (kStreamMaxStages + s), phase ^ 1);
        const long long row0 = g * kStreamWarps;
        const long long rows = N - row0 < kStreamWarps ? N - row0 : kStreamWarps;
        const uint32_t bytes = uint32_t(rows) * row_bytes;
        mbar_expect_tx(bars + 8 * s, bytes);
        bulk_load(smem_u32(ring + size_t(s) * stage_bytes), x + row0 * D, bytes, bars + 8 * s);
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: one row a warp ----
  constexpr int E = Vec<T>::n;
  int s = 0;
  uint32_t phase = 0;
  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const uint32_t empty = bars + 8 * (kStreamMaxStages + s);
    mbar_wait(bars + 8 * s, phase);
    const long long row = g * kStreamWarps + warp;
    if (row < N) {
      const T* src = reinterpret_cast<const T*>(ring + size_t(s) * stage_bytes +
                                                size_t(warp) * row_bytes);
      const RegRow<T, VPL> r(src, D / E);
      op(r, y + row * D, [&] {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty);
      });
    } else if (lane == 0) {
      mbar_arrive(empty);
    }
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }
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
bool bad_body(int body) { return body != 0 && body != 1; }

// Rows that a register-row body takes: x and y 16-byte aligned, rows of a
// whole number of 16-byte vectors, at most 4 KB.
bool fits_register_row(int dtype, const void* x, const void* y, long long D) {
  const long long row_bytes = D * (dtype == 0 ? 4 : 2);
  return row_bytes % 16 == 0 && row_bytes <= 4096 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(y) % 16 == 0;
}

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

// The row-streaming kernel at one register-row size: two blocks an SM
// (the SM count read once a card, when the kernel's shared-memory limit is
// set), as many ring stages of kStreamWarps rows as kStreamRingBytes holds.
template <typename T, int VPL, typename Op>
cudaError_t launch_stream_vpl(const T* x, T* y, long long N, int D, Op op, cudaStream_t s) {
  static int sms_of[64] = {};
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64) sms = sms_of[device];
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(row_stream_kernel<T, VPL, Op>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kStreamBarBytes + kStreamRingBytes);
    if (err != cudaSuccess) return err;
    if (device < 64) sms_of[device] = sms;
  }
  const int stage_bytes = kStreamWarps * D * int(sizeof(T));
  int stages = kStreamRingBytes / stage_bytes;
  if (stages > kStreamMaxStages) stages = kStreamMaxStages;
  const long long groups = (N + kStreamWarps - 1) / kStreamWarps;
  const long long blocks = groups < (long long)kStreamBlocksPerSm * sms
                               ? groups : (long long)kStreamBlocksPerSm * sms;
  const size_t smem = kStreamBarBytes + size_t(stages) * stage_bytes;
  row_stream_kernel<T, VPL, Op><<<dim3(unsigned(blocks)), kStreamThreads, smem, s>>>(
      x, y, N, D, stages, op);
  return cudaGetLastError();
}

// The row-streaming kernel on rows of whole 16-byte vectors up to 4 KB
// (checked by the entry), with the register row sized to the width.
template <typename T, typename Op>
cudaError_t launch_stream(const void* xv, void* yv, long long N, long long D, Op op,
                          cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  const long long nvec = D / Vec<T>::n;
  const int d = int(D);
  if (nvec <= 32) return launch_stream_vpl<T, 1>(x, y, N, d, op, s);
  if (nvec <= 64) return launch_stream_vpl<T, 2>(x, y, N, d, op, s);
  if (nvec <= 128) return launch_stream_vpl<T, 4>(x, y, N, d, op, s);
  return launch_stream_vpl<T, 8>(x, y, N, d, op, s);
}

template <typename T>
cudaError_t launch_rmsnorm(int body, const void* x, const void* g, int gc, void* y, long long N,
                           long long D, float eps, cudaStream_t s) {
  if (body == 1) {
    const RmsNormRowOp op{g, gc, (reinterpret_cast<uintptr_t>(g) & 15) == 0, int(D), eps};
    return launch_stream<T>(x, y, N, D, op, s);
  }
  const int threads = threads_for<T>(D);
  rmsnorm_kernel<T><<<dim3(unsigned(N)), threads, 0, s>>>(
      static_cast<const T*>(x), g, gc, static_cast<T*>(y), D, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_softmax(int body, const void* x, void* y, long long N, long long D,
                           cudaStream_t s) {
  if (body == 1) return launch_stream<T>(x, y, N, D, SoftmaxRowOp(), s);
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
      bad_body(body))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    if (!fits_register_row(dtype, x, y, D)) return int(cudaErrorInvalidValue);
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

// body: 0 = one block a row (any row), 1 = the row-streaming kernel (x and
// y 16-byte aligned, rows of a whole number of 16-byte vectors up to 4 KB;
// cudaErrorInvalidValue otherwise).
int mxtt_rmsnorm(int body, int dtype, const void* x, const void* gamma, int gamma_dtype,
                 void* y, long long N, long long D, float eps, void* stream) {
  if (bad_shape(N, D) || bad_code(gamma_dtype) || bad_code(dtype) || bad_body(body) ||
      (body == 1 && !fits_register_row(dtype, x, y, D)))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return int(launch_rmsnorm<float>(body, x, gamma, gamma_dtype, y, N, D, eps, s));
    case 1: return int(launch_rmsnorm<__nv_bfloat16>(body, x, gamma, gamma_dtype, y, N, D, eps, s));
    default: return int(launch_rmsnorm<__half>(body, x, gamma, gamma_dtype, y, N, D, eps, s));
  }
}

// body as for mxtt_rmsnorm.
int mxtt_softmax(int body, int dtype, const void* x, void* y, long long N, long long D,
                 void* stream) {
  if (bad_shape(N, D) || bad_code(dtype) || bad_body(body) ||
      (body == 1 && !fits_register_row(dtype, x, y, D)))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return int(launch_softmax<float>(body, x, y, N, D, s));
    case 1: return int(launch_softmax<__nv_bfloat16>(body, x, y, N, D, s));
    default: return int(launch_softmax<__half>(body, x, y, N, D, s));
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
