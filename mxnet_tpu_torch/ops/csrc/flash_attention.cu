// Flash-attention forward for Hopper (sm_90a), bound through a plain C
// interface (mxnet_tpu_torch/ops/cuda_kernels.py loads it with ctypes).
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_kernels.py::_flash_kernel
// (driven by _flash_fwd_impl), which serves both flash_attention and
// flash_attention_lse. Semantics kept from it:
//   * softmax(q k^T * scale) v by an online softmax over K/V tiles staged in
//     shared memory; no [Tq, Tk] score matrix ever reaches device memory;
//   * f32 statistics and accumulation, output in the input type, and the row
//     log-sum-exp (natural log, of the scaled scores) as a [B*H, Tq] f32 array;
//   * the causal mask aligned bottom-right: query i sees keys <= i + Tk - Tq;
//     K tiles past a q tile's causal frontier are never loaded;
//   * masked scores are -1e30 (held in f32 only), and l is clamped at 1e-30.
// Differences of layout, not of result: q/k/v/o are read and written as
// strided [B, T, H, D] (last stride 1) with no transpose copies, the ragged
// q/k edges are masked here instead of padded, and blocks run in parallel
// over (B*H, q tiles) with nothing carried between them.
//
// Two bodies, one contract (the wrapper picks one per call):
//   * flash_fwd_mma<D>: bf16, D in {16, 32, 64, 128}, 16-byte aligned rows.
//     4 warps x 16 query rows; q k^T and p v on mma.sync m16n8k16 (bf16 in,
//     f32 accumulate). The scores are scaled in f32 after the product, which
//     equals the TPU's (q * scale) . k without rounding q * scale to bf16.
//     p is rounded to bf16 for the p v product (as the TPU feeds its MXU).
//   * flash_fwd_simt<T>: f32, bf16 or f16, any D <= 256, any row alignment.
//     Scalar f32 FMAs; q is scaled in f32 before the dot exactly as the TPU
//     does.
// What bounds it on an H100: at the served shape ([8, 1024, 8, 128] bf16,
// causal) the bytes (q, k, v, o once each: 67 MB, ~20 us at 3.35 TB/s) and
// the causal FLOPs (17.2 GFLOP, ~17 us at 989 TFLOP/s) are close. This first
// version loads tiles synchronously (no cp.async/TMA pipeline) and uses
// mma.sync rather than wgmma, so it sits well above either bound; PERF.md
// keeps its measured time.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;

struct Strides {
  long long b, t, h;  // in elements; the d stride is 1
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B*H, Tq]
  int B, H, Tq, Tk, D;
  Strides sq, sk, sv, so;
  float scale;
  int causal;
  int offset;  // Tk - Tq: the causal diagonal's shift
};

// Number of K tiles a q tile [q0, q0 + rows) must visit.
__device__ __forceinline__ int key_tiles(const Params& p, int q0, int rows, int bk) {
  int n = (p.Tk + bk - 1) / bk;
  if (p.causal) {
    int last_row = min(q0 + rows, p.Tq) - 1;
    int visible = last_row + p.offset + 1;  // keys [0, visible)
    n = min(n, (visible + bk - 1) / bk);
  }
  return n;
}

__device__ __forceinline__ bool key_visible(const Params& p, int row, int col) {
  return col < p.Tk && (!p.causal || col <= row + p.offset);
}

// ---------------------------------------------------------------------------
// bf16 body on mma.sync
// ---------------------------------------------------------------------------

constexpr int kMmaRows = 64;     // q rows per block: 4 warps x 16
constexpr int kMmaKeys = 64;     // keys per K/V tile
constexpr int kMmaThreads = 128;

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copies rows [row0, row0 + ROWS) of one head into shared memory in 16-byte
// pieces; rows at or past n_rows become zeros. LD is the padded row length.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(uint16_t* dst, const uint16_t* src,
                                          long long row_stride, int row0,
                                          int n_rows) {
  constexpr int kChunks = D / 8;
  constexpr int LD = D + 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kMmaThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < n_rows)
      val = *reinterpret_cast<const uint4*>(src + gr * row_stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_fwd_mma(const Params p) {
  // Rows padded by 8 elements: the fragment reads below then fall on 32
  // distinct banks.
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* sQ = smem;
  uint16_t* sK = sQ + kMmaRows * LD;
  uint16_t* sV = sK + kMmaKeys * LD;

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kMmaRows;  // long causal tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group, column pair

  const uint16_t* qg = static_cast<const uint16_t*>(p.q) + b * p.sq.b + h * p.sq.h;
  const uint16_t* kg = static_cast<const uint16_t*>(p.k) + b * p.sk.b + h * p.sk.h;
  const uint16_t* vg = static_cast<const uint16_t*>(p.v) + b * p.sv.b + h * p.sv.h;
  uint16_t* og = static_cast<uint16_t*>(p.o) + b * p.so.b + h * p.so.h;

  load_tile<D, kMmaRows>(sQ, qg, p.sq.t, q0, p.Tq);
  __syncthreads();

  // This thread's A fragments of q: rows r0 and r0 + 8 of the warp's 16.
  const int r0 = warp * 16 + g;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint16_t* s0 = sQ + r0 * LD + kk * 16 + 2 * t;
    qf[kk][0] = lds32(s0);
    qf[kk][1] = lds32(s0 + 8 * LD);
    qf[kk][2] = lds32(s0 + 8);
    qf[kk][3] = lds32(s0 + 8 * LD + 8);
  }

  const int row[2] = {q0 + r0, q0 + r0 + 8};
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  const int n_tiles = key_tiles(p, q0, kMmaRows, kMmaKeys);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kMmaKeys;
    __syncthreads();  // every warp is done with the previous tile
    load_tile<D, kMmaKeys>(sK, kg, p.sk.t, k0, p.Tk);
    load_tile<D, kMmaKeys>(sV, vg, p.sv.t, k0, p.Tk);
    __syncthreads();

    float s[kMmaKeys / 8][4];
#pragma unroll
    for (int n = 0; n < kMmaKeys / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kMmaKeys / 8; ++n) {
        const uint16_t* kp = sK + (n * 8 + g) * LD + kk * 16 + 2 * t;
        mma_16816(s[n], qf[kk], lds32(kp), lds32(kp + 8));
      }
    }

    // Scale, mask, and the running max of rows row[0] and row[1].
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kMmaKeys / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + n * 8 + 2 * t + (c & 1);
        const float x = key_visible(p, row[c >> 1], col) ? s[n][c] * p.scale : kNeg;
        s[n][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float corr = __expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        acc[dn][2 * r] *= corr;
        acc[dn][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int n = 0; n < kMmaKeys / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[n][c] = __expf(s[n][c] - m[c >> 1]);
        l[c >> 1] += s[n][c];
      }
    }

    // acc += p v. The accumulators of two neighbouring 8-key column tiles
    // are exactly the A fragment of one 16-key slice of p.
#pragma unroll
    for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const uint16_t* vp = sV + (kk * 16 + 2 * t) * LD + dn * 8 + g;
        const uint32_t b0 = uint32_t(vp[0]) | (uint32_t(vp[LD]) << 16);
        const uint32_t b1 = uint32_t(vp[8 * LD]) | (uint32_t(vp[9 * LD]) << 16);
        mma_16816(acc[dn], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (row[r] >= p.Tq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    const float inv = 1.f / lc;
    uint16_t* orow = og + row[r] * p.so.t;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(orow + dn * 8 + 2 * t) =
          pack_bf16(acc[dn][2 * r] * inv, acc[dn][2 * r + 1] * inv);
    if (t == 0) p.lse[(long long)bh * p.Tq + row[r]] = m[r] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// Scalar body: f32, bf16 or f16, any D <= 256
// ---------------------------------------------------------------------------

constexpr int kSimtRows = 32;   // q rows per block
constexpr int kSimtKeys = 32;   // keys per tile: one per lane in the softmax
constexpr int kSimtThreads = 128;
constexpr int kSimtMaxD = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

size_t simt_smem_bytes(int D) {
  return sizeof(float) * (size_t(kSimtRows) * D + size_t(kSimtKeys) * (D + 1) +
                          size_t(kSimtKeys) * D + kSimtRows * (kSimtKeys + 1) +
                          3 * kSimtRows);
}

template <typename T>
__global__ void __launch_bounds__(kSimtThreads) flash_fwd_simt(const Params p) {
  const int D = p.D;
  extern __shared__ __align__(16) float fsm[];
  float* sQ = fsm;                                    // [rows][D], scaled
  float* sK = sQ + kSimtRows * D;                     // [keys][D + 1]
  float* sV = sK + kSimtKeys * (D + 1);               // [keys][D]
  float* sS = sV + kSimtKeys * D;                     // [rows][keys + 1]
  float* sM = sS + kSimtRows * (kSimtKeys + 1);       // running max
  float* sL = sM + kSimtRows;                         // running sum
  float* sCorr = sL + kSimtRows;                      // this tile's rescale

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kSimtRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const T* qg = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* kg = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* vg = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;
  T* og = static_cast<T*>(p.o) + b * p.so.b + h * p.so.h;

  for (int i = tid; i < kSimtRows * D; i += kSimtThreads) {
    const int r = i / D, d = i % D, gr = q0 + r;
    sQ[i] = gr < p.Tq ? to_f32(qg[gr * p.sq.t + d]) * p.scale : 0.f;
  }
  for (int i = tid; i < kSimtRows; i += kSimtThreads) {
    sM[i] = kNeg;
    sL[i] = 0.f;
  }

  constexpr int kPer = kSimtRows * kSimtMaxD / kSimtThreads;  // accumulators a thread owns
  float acc[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) acc[r] = 0.f;

  const int n_tiles = key_tiles(p, q0, kSimtRows, kSimtKeys);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kSimtKeys;
    __syncthreads();
    for (int i = tid; i < kSimtKeys * D; i += kSimtThreads) {
      const int r = i / D, d = i % D, gr = k0 + r;
      const bool in = gr < p.Tk;
      sK[r * (D + 1) + d] = in ? to_f32(kg[gr * p.sk.t + d]) : 0.f;
      sV[i] = in ? to_f32(vg[gr * p.sv.t + d]) : 0.f;
    }
    __syncthreads();

    for (int e = tid; e < kSimtRows * kSimtKeys; e += kSimtThreads) {
      const int i = e / kSimtKeys, c = e % kSimtKeys;
      const float* qr = sQ + i * D;
      const float* kr = sK + c * (D + 1);
      float x = 0.f;
      for (int d = 0; d < D; ++d) x = fmaf(qr[d], kr[d], x);
      sS[i * (kSimtKeys + 1) + c] = key_visible(p, q0 + i, k0 + c) ? x : kNeg;
    }
    __syncthreads();

    // Online softmax: each warp owns rows, one key per lane.
    for (int i = warp; i < kSimtRows; i += kSimtThreads / 32) {
      float* srow = sS + i * (kSimtKeys + 1);
      const float x = srow[lane];
      float mx = x;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = sM[i];
      const float m_new = fmaxf(m_old, mx);
      const float e = expf(x - m_new);
      float sum = e;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      srow[lane] = e;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sM[i] = m_new;
        sL[i] = sL[i] * corr + sum;
        sCorr[i] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int e = tid + r * kSimtThreads;
      if (e < kSimtRows * D) {
        const int i = e / D, d = e % D;
        const float* prow = sS + i * (kSimtKeys + 1);
        float a = acc[r] * sCorr[i];
        for (int c = 0; c < kSimtKeys; ++c) a = fmaf(prow[c], sV[c * D + d], a);
        acc[r] = a;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int e = tid + r * kSimtThreads;
    if (e < kSimtRows * D) {
      const int i = e / D, d = e % D, gr = q0 + i;
      if (gr < p.Tq) og[gr * p.so.t + d] = from_f32<T>(acc[r] / fmaxf(sL[i], 1e-30f));
    }
  }
  for (int i = tid; i < kSimtRows; i += kSimtThreads)
    if (q0 + i < p.Tq)
      p.lse[(long long)bh * p.Tq + q0 + i] = sM[i] + logf(fmaxf(sL[i], 1e-30f));
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                   const Params& p, int threads) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  const dim3 grid(p.B * p.H, (p.Tq + kMmaRows - 1) / kMmaRows);
  const size_t smem = sizeof(uint16_t) * (kMmaRows + 2 * kMmaKeys) * (D + 8);
  return launch(flash_fwd_mma<D>, grid, smem, stream, p, kMmaThreads);
}

}  // namespace

extern "C" {

// variant: 0 = scalar body, 1 = mma body. dtype: 0 = float32, 1 = bfloat16,
// 2 = float16 (scalar body only).
// Strides are in elements, for [B, T, H, D] with a d stride of 1.
// Returns the launch's cudaError_t (0 on success); the launch is
// asynchronous on `stream`.
int mxtt_flash_fwd(int variant, int dtype, const void* q, const void* k,
                   const void* v, void* o, void* lse, int B, int H, int Tq,
                   int Tk, int D, long long q_sb, long long q_st, long long q_sh,
                   long long k_sb, long long k_st, long long k_sh, long long v_sb,
                   long long v_st, long long v_sh, long long o_sb, long long o_st,
                   long long o_sh, float scale, int causal, void* stream) {
  if (B * H <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > kSimtMaxD ||
      (causal && Tq > Tk))
    return int(cudaErrorInvalidValue);
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.lse = static_cast<float*>(lse);
  p.B = B; p.H = H; p.Tq = Tq; p.Tk = Tk; p.D = D;
  p.sq = Strides{q_sb, q_st, q_sh};
  p.sk = Strides{k_sb, k_st, k_sh};
  p.sv = Strides{v_sb, v_st, v_sh};
  p.so = Strides{o_sb, o_st, o_sh};
  p.scale = scale;
  p.causal = causal;
  p.offset = Tk - Tq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  if (variant == 1) {
    if (dtype != 1) return int(cudaErrorInvalidValue);
    switch (D) {
      case 16: return int(launch_mma<16>(p, s));
      case 32: return int(launch_mma<32>(p, s));
      case 64: return int(launch_mma<64>(p, s));
      case 128: return int(launch_mma<128>(p, s));
      default: return int(cudaErrorInvalidValue);
    }
  }
  if (variant != 0) return int(cudaErrorInvalidValue);
  const dim3 grid(B * H, (Tq + kSimtRows - 1) / kSimtRows);
  const size_t smem = simt_smem_bytes(D);
  if (dtype == 0) return int(launch(flash_fwd_simt<float>, grid, smem, s, p, kSimtThreads));
  if (dtype == 1)
    return int(launch(flash_fwd_simt<__nv_bfloat16>, grid, smem, s, p, kSimtThreads));
  if (dtype == 2) return int(launch(flash_fwd_simt<__half>, grid, smem, s, p, kSimtThreads));
  return int(cudaErrorInvalidValue);
}

const char* mxtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
