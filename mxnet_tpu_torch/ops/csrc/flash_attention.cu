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
//   * masked scores are -1e30 (held in f32 only), and l is clamped at 1e-30
//     (the wgmma body masks with -inf, which gives the same result: no row
//     is masked whole, as query i always sees key 0).
// Differences of layout, not of result: q/k/v/o are read and written as
// strided [B, T, H, D] (last stride 1) with no transpose copies, the ragged
// q/k edges are masked here instead of padded, and blocks run in parallel
// over (B*H, q tiles) with nothing carried between them.
//
// Three bodies, one contract (the wrapper picks one per call, before any
// launch, and never retries with another):
//   * flash_fwd_wgmma: bf16, D = 128, 16-byte aligned bases, positive
//     16-byte strides, scale > 0. Hopper's shape: TMA copies, mbarriers,
//     wgmma (see its own comment below).
//   * flash_fwd_mma<D>: bf16, D in {16, 32, 64, 128}, 16-byte aligned rows;
//     at D = 128 it takes what the wgmma body does not, such as K/V
//     broadcast over heads or batch with a zero stride.
//     4 warps x 16 query rows; q k^T and p v on mma.sync m16n8k16 (bf16 in,
//     f32 accumulate). The scores are scaled in f32 after the product, which
//     equals the TPU's (q * scale) . k without rounding q * scale to bf16.
//     p is rounded to bf16 for the p v product (as the TPU feeds its MXU).
//   * flash_fwd_simt<T>: f32, bf16 or f16, any D <= 256, any row alignment.
//     Scalar f32 FMAs; q is scaled in f32 before the dot exactly as the TPU
//     does.
// What bounds it on an H100: at the served shape ([8, 1024, 8, 128] bf16,
// causal) the bytes (q, k, v, o once each: 67 MB, ~20 us at 3.35 TB/s) and
// the causal FLOPs (17.2 GFLOP, ~17 us at 989 TFLOP/s) are close. The mma
// body loads tiles synchronously and runs Ampere's mma.sync, so it sits well
// above either bound; the wgmma body overlaps the copies with the products
// and runs the products at Hopper's tensor-core rate. PERF.md keeps the
// measured times of both.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>
#include <stdio.h>

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
// bf16 body for Hopper: TMA, mbarriers and wgmma (D = 128)
// ---------------------------------------------------------------------------
//
// A persistent kernel: one block an SM, each walking a share of the work
// items, an item being 128 query rows of one (batch, head) against its K/V
// tiles of 128 keys. Three warpgroups of 128 threads:
//   * warpgroup 0, the producer: one thread issues TMA copies (an item's Q,
//     then its K and V tile by tile) into a ring of three K/V stages, each
//     copy completing on a "full" mbarrier with its byte count; it waits on a
//     stage's "empty" mbarrier before it refills the stage, and on "q free"
//     before it loads the next item's Q. It gives its registers up with
//     setmaxnreg (24 a thread).
//   * warpgroups 1 and 2, the consumers (240 registers a thread): 64 query
//     rows each (one wgmma m64 tile). S = Q K^T is wgmma m64n128k16 with
//     both operands in shared memory, K-major. The online softmax runs on
//     S's accumulator fragment (each row spread over the 4 threads of a
//     quad), and P, rounded to bf16, feeds O += P V from registers: the
//     accumulator fragment of 16 key columns is the register A fragment of a
//     k16 slice. V is the B operand MN-major (d contiguous), the
//     transposed-B mode bf16 allows. Each consumer pipelines its tiles: S of
//     tile j and P V of tile j-1 are issued together, and the softmax of tile
//     j runs while P V of tile j-1 is still on the tensor cores. Q is freed
//     as soon as an item's last q k^T has completed, so the next item's Q
//     loads under the last P V and the epilogue.
// Tiles land 128-byte swizzled: each tile is two boxes of 64 d (128 bytes,
// the swizzle's span) by 128 rows, 16 KB each, so the Q tile takes 32 KB and
// a stage of K and V 64 KB: 224 KB in all (three stages, not two: with two,
// the kernel was slower at every shape timed). S (64 registers), O (64) and the
// packed P (32), with one tile in flight beside the other, need the 240
// registers: ptxas gives them to the consumers' branch only while no code is
// shared between the two roles (a __trap() on a stuck wait, reachable from
// both, holds the whole kernel to the 168 of its entry, and it spills). TMA
// zero-fills rows past Tq or Tk, and the tensor maps carry the strided
// [B, T, H, D] views as they are (4-D over d, h, t, b), the model's fused
// qkv included. Only the tiles on the causal diagonal and the ragged last
// tile are masked. The epilogue writes O straight from the accumulators
// with 16-byte stores, after a transpose within each quad.
//
// The softmax works in base 2: m is the running max of s * scale * log2(e)
// and p = 2^(s * scale * log2(e) - m), one FMA and one ex2 an element, so
// scale must be positive (the wrapper sends other scales elsewhere). The
// lse is converted back to the natural log.

constexpr int kWgRows = 128;          // q rows per work item
constexpr int kWgKeys = 128;          // keys per K/V tile
constexpr int kWgD = 128;
constexpr int kWgThreads = 384;       // producer + 2 consumer warpgroups
constexpr int kWgStages = 3;
constexpr uint32_t kBox = 64 * 128 * 2;               // one 64-d box of 128 rows
constexpr uint32_t kTile = 2 * kBox;                  // a 128 x 128 bf16 tile
constexpr uint32_t kSmemQ = 0;
constexpr uint32_t kSmemK = kTile;                    // + stage * kTile
constexpr uint32_t kSmemV = kSmemK + kWgStages * kTile;
constexpr uint32_t kSmemBar = kSmemV + kWgStages * kTile;
// barriers: q, q free, full_k[stages], full_v[stages], empty[stages]
constexpr uint32_t kBarQ = 0, kBarQFree = 8, kBarFullK = 16,
                   kBarFullV = kBarFullK + 8 * kWgStages, kBarEmpty = kBarFullV + 8 * kWgStages;
constexpr size_t kWgSmemBytes = 1024 /* alignment slack */ + kSmemBar + kBarEmpty + 8 * kWgStages;

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

// A 64 x 128-row box of a 4-D tensor map at (d0, h, t0, b) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d0, int h, int t0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(d0), "r"(h), "r"(t0), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle. Offsets in bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
}
// Q and K tiles, K-major: 8-row groups 1024 bytes apart (LBO unused).
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return sw128_desc(addr, 16, 1024);
}
// V tiles as B of p v, MN-major: the two 64-d boxes (MN atoms) 16 KB apart,
// 8-key groups 1024 bytes apart.
__device__ __forceinline__ uint64_t vmajor_desc(uint32_t addr) {
  return sw128_desc(addr, kBox, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N of this warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma that owns them.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[8][4]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(a[i / 4][i % 4]) :: "memory");
}

#define MXTT_ACC8(d, i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define MXTT_ACC64(d)                                                        \
  MXTT_ACC8(d, 0), MXTT_ACC8(d, 8), MXTT_ACC8(d, 16), MXTT_ACC8(d, 24),      \
      MXTT_ACC8(d, 32), MXTT_ACC8(d, 40), MXTT_ACC8(d, 48), MXTT_ACC8(d, 56)
#define MXTT_REGS64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"

// d (+)= A B for A [64 x 16] and B [16 x 128], both from shared memory,
// both K-major. accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " MXTT_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : MXTT_ACC64(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B for A [64 x 16] bf16 from registers (the m16n8k16 A fragment of
// each warp's 16 rows) and B [16 x 128] from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " MXTT_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : MXTT_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T of one tile into sc, from the warpgroup's Q rows at sq and the K
// tile at sk (asynchronous; committed as one group).
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t sq, uint32_t sk) {
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kWgD / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
    wgmma_ss(sc, kmajor_desc(sq + off), kmajor_desc(sk + off), kk > 0);
  }
  wgmma_commit();
}

// O += P V of one tile from the packed p and the V tile at sv (asynchronous;
// committed as one group).
__device__ __forceinline__ void issue_pv(float (&o)[64], uint32_t (&pa)[8][4], uint32_t sv) {
  fence_regs(o);
  fence_regs(pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kWgKeys / 16; ++kk)
    wgmma_rs(o, pa[kk], vmajor_desc(sv + kk * 16 * 128));
  wgmma_commit();
}

// The online softmax of one tile on its scores sc (this thread's rows
// row[0], row[1] of the warpgroup's 64 from row0; key columns k0 + 8 n + 2 t
// + {0, 1}): the mask, only on the ragged last tile and the tiles on the
// causal diagonal; the new running max m (of s * sl2); sc <- 2^(s sl2 - m)
// in f32; l rescaled and summed. corr gets the factor that rescales O.
__device__ __forceinline__ void online_softmax(float (&sc)[64], float (&m)[2], float (&l)[2],
                                               float (&corr)[2], const Params& p, int k0,
                                               int row0, const int (&row)[2], int t,
                                               float sl2) {
  if (k0 + kWgKeys > p.Tk || (p.causal && k0 + kWgKeys - 1 > row0 + p.offset)) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int col = k0 + (i / 4) * 8 + 2 * t + (i & 1);
      if (!key_visible(p, row[(i >> 1) & 1], col)) sc[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * sl2);
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    sc[i] = ex2(fmaf(sc[i], sl2, -m[(i >> 1) & 1]));
    l[(i >> 1) & 1] += sc[i];
  }
}

// p rounded to bf16 and packed as the A fragments of the tile's 8 k16
// slices: the accumulators of key columns 16 kk .. 16 kk + 15.
__device__ __forceinline__ void pack_p(const float (&sc)[64], uint32_t (&pa)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);  // row g,     keys 2t, 2t+1
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);  // row g + 8, keys 2t, 2t+1
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);  // row g,     keys 2t+8, 2t+9
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);  // row g + 8, keys 2t+8, 2t+9
  }
}

// The work items of a launch are the (q tile, batch-head) pairs, longest
// causal tiles first: item i is q tile n_qt - 1 - i / BH of batch-head
// i % BH. Each block walks its share in a snake order (blocks 0..G-1, then
// G-1..0, ...), which evens out the tiles a block computes when the items
// shorten along the way.
struct Item {
  int b, h, q0, n_tiles;
};

__device__ __forceinline__ int snake_item(int k, int c, int G) {
  return (k % 2 == 0) ? k * G + c : (k + 1) * G - 1 - c;
}

__device__ __forceinline__ Item item_at(const Params& p, int i) {
  const int BH = p.B * p.H;
  const int n_qt = (p.Tq + kWgRows - 1) / kWgRows;
  const int bh = i % BH;
  Item it;
  it.b = bh / p.H;
  it.h = bh % p.H;
  it.q0 = (n_qt - 1 - i / BH) * kWgRows;
  it.n_tiles = key_tiles(p, it.q0, kWgRows, kWgKeys);
  return it;
}

// 4 x 4 transpose across the 4 lanes of a quad: afterwards lane t's v[j]
// holds what lane j's v[t] held.
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int t) {
#pragma unroll
  for (int m = 1; m <= 2; m <<= 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j & m) continue;
      const bool hi = t & m;
      const uint32_t send = hi ? v[j] : v[j | m];
      const uint32_t got = __shfl_xor_sync(0xffffffffu, send, m);
      if (hi) v[j] = got; else v[j | m] = got;
    }
  }
}

__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v, const Params p) {
  extern __shared__ uint8_t wg_smem[];
  const uint32_t raw = smem_u32(wg_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles: 1024-aligned
  const uint32_t bars = base + kSmemBar;
  const int n_items = (p.Tq + kWgRows - 1) / kWgRows * p.B * p.H;
  const int c = blockIdx.x, G = gridDim.x;
  // The warpgroup, made warp-uniform for the compiler (a shuffle from lane
  // 0), so that each role's branch keeps the registers setmaxnreg gives it.
  const int wg = __shfl_sync(0xffffffffu, int(threadIdx.x / 128), 0);

  if (threadIdx.x == 0) {
    mbar_init(bars + kBarQ, 1);
    mbar_init(bars + kBarQFree, 8);            // lane 0 of each consumer warp
#pragma unroll
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(bars + kBarFullK + 8 * s, 1);
      mbar_init(bars + kBarFullV + 8 * s, 1);
      mbar_init(bars + kBarEmpty + 8 * s, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int n = 0;  // K/V tiles issued by this block, over all its items
      for (int k = 0;; ++k) {
        const int i = snake_item(k, c, G);
        if (i >= n_items) break;
        const Item it = item_at(p, i);
        // Q of this item once the consumers' last q k^T of the previous one
        // has completed.
        mbar_wait(bars + kBarQFree, (k & 1) ^ 1);
        mbar_expect_tx(bars + kBarQ, kTile);
        tma_load(base + kSmemQ, &map_q, bars + kBarQ, 0, it.h, it.q0, it.b);
        tma_load(base + kSmemQ + kBox, &map_q, bars + kBarQ, 64, it.h, it.q0, it.b);
        for (int j = 0; j < it.n_tiles; ++j, ++n) {
          const int s = n % kWgStages;
          mbar_wait(bars + kBarEmpty + 8 * s, ((n / kWgStages) & 1) ^ 1);
          const int k0 = j * kWgKeys;
          const uint32_t fk = bars + kBarFullK + 8 * s, fv = bars + kBarFullV + 8 * s;
          const uint32_t sk = base + kSmemK + s * kTile, sv = base + kSmemV + s * kTile;
          mbar_expect_tx(fk, kTile);
          tma_load(sk, &map_k, fk, 0, it.h, k0, it.b);
          tma_load(sk + kBox, &map_k, fk, 64, it.h, k0, it.b);
          mbar_expect_tx(fv, kTile);
          tma_load(sv, &map_v, fv, 0, it.h, k0, it.b);
          tma_load(sv + kBox, &map_v, fv, 64, it.h, k0, it.b);
        }
      }
    }
  } else {
    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;                      // which 64 rows of the tile
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;       // fragment row group, column pair
    const int rl = 16 * warp + g;               // this thread's rows: rl, rl + 8
    const float sl2 = p.scale * 1.4426950408889634f;
    const uint32_t sq = base + kSmemQ + cw * 64 * 128;  // within each 64-d box
    const uint32_t sk0 = base + kSmemK, sv0 = base + kSmemV;
    auto stage = [](int n) { return n % kWgStages; };
    auto parity = [](int n) { return uint32_t((n / kWgStages) & 1); };
    auto free_q = [&]() {
      if (lane == 0) mbar_arrive(bars + kBarQFree);
    };

    float o[64], sc[64];
    uint32_t pa[8][4];
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.f;
    int n = 0;  // K/V tiles consumed by this block, over all its items
    for (int k = 0;; ++k) {
      const int i = snake_item(k, c, G);
      if (i >= n_items) break;
      const Item it = item_at(p, i);
      const int row0 = it.q0 + 64 * cw;         // this warpgroup's first row
      const int row[2] = {row0 + rl, row0 + rl + 8};
      // The tiles this warpgroup computes: none when every row is past Tq;
      // under the causal mask, none past its last row's frontier (they come
      // last). It still waits for the others and frees them, keeping the
      // barrier phases in step.
      int n_mine = row0 < p.Tq ? it.n_tiles : 0;
      if (p.causal) n_mine = min(n_mine, (row0 + 63 + p.offset) / kWgKeys + 1);

#pragma unroll
      for (int r = 0; r < 64; ++r) o[r] = 0.f;
      float m[2] = {kNeg, kNeg};
      float l[2] = {0.f, 0.f};  // this thread's share of the row sums
      float corr[2];

      // The pipeline: while tile j's softmax runs on the CUDA cores, tile
      // j-1's p v runs on the tensor cores. Q is freed for the next item as
      // soon as the last q k^T has completed.
      mbar_wait(bars + kBarQ, k & 1);
      if (n_mine == 0) free_q();
      if (n_mine > 0) {
        mbar_wait(bars + kBarFullK + 8 * stage(n), parity(n));
        issue_qk(sc, sq, sk0 + stage(n) * kTile);
        wgmma_wait<0>();
        fence_regs(sc);
        if (n_mine == 1) free_q();
        online_softmax(sc, m, l, corr, p, 0, row0, row, t, sl2);
        pack_p(sc, pa);
        for (int j = 1; j < n_mine; ++j) {
          const int s = stage(n + j), sp = stage(n + j - 1);
          mbar_wait(bars + kBarFullK + 8 * s, parity(n + j));
          issue_qk(sc, sq, sk0 + s * kTile);
          mbar_wait(bars + kBarFullV + 8 * sp, parity(n + j - 1));
          issue_pv(o, pa, sv0 + sp * kTile);
          wgmma_wait<1>();        // S_j is complete; p v of tile j-1 may run on
          fence_regs(sc);
          if (j == n_mine - 1) free_q();
          online_softmax(sc, m, l, corr, p, j * kWgKeys, row0, row, t, sl2);
          wgmma_wait<0>();        // p v of tile j-1 is complete: its stage is free
          fence_regs(o);
          if (lane == 0) mbar_arrive(bars + kBarEmpty + 8 * sp);
#pragma unroll
          for (int r = 0; r < 64; ++r) o[r] *= corr[(r >> 1) & 1];
          pack_p(sc, pa);
        }
        const int sl = stage(n + n_mine - 1);
        mbar_wait(bars + kBarFullV + 8 * sl, parity(n + n_mine - 1));
        issue_pv(o, pa, sv0 + sl * kTile);
        wgmma_wait<0>();
        fence_regs(o);
        if (lane == 0) mbar_arrive(bars + kBarEmpty + 8 * sl);
      }
      for (int j = n_mine; j < it.n_tiles; ++j) {
        const int s = stage(n + j);
        mbar_wait(bars + kBarFullK + 8 * s, parity(n + j));
        mbar_wait(bars + kBarFullV + 8 * s, parity(n + j));
        if (lane == 0) mbar_arrive(bars + kBarEmpty + 8 * s);
      }
      n += it.n_tiles;

      // Epilogue: O / l in bf16, straight from the accumulators. The 4 lanes
      // of a quad hold 8 neighbouring columns of a row, 2 each; a transpose
      // within the quad gives each lane 8 of its own (4 column groups at a
      // time), which it writes with one 16-byte store.
      if (row0 >= p.Tq) continue;
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const float lc = fmaxf(l[r], 1e-30f);
        inv[r] = 1.f / lc;
        if (t == 0 && row[r] < p.Tq)
          p.lse[(long long)(it.b * p.H + it.h) * p.Tq + row[r]] =
              m[r] * 0.6931471805599453f + logf(lc);
      }
      uint16_t* og = static_cast<uint16_t*>(p.o) + it.b * p.so.b + it.h * p.so.h;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t v[4];  // column groups 4q .. 4q + 3, this lane's pair of each
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n8 = 4 * q + j;
            v[j] = pack_bf16(o[4 * n8 + 2 * r] * inv[r], o[4 * n8 + 2 * r + 1] * inv[r]);
          }
          quad_transpose(v, t);  // v: all 8 columns of group 4q + t
          if (row[r] < p.Tq)
            *reinterpret_cast<uint4*>(og + (long long)row[r] * p.so.t + (4 * q + t) * 8) =
                make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
    }
  }
}

#undef MXTT_ACC8
#undef MXTT_ACC64
#undef MXTT_REGS64

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

// cuTensorMapEncodeTiled, reached through the runtime so that nothing but
// the toolkit's runtime is linked.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// Codes below zero are this file's own: -1 to -999 a CUresult of
// cuTensorMapEncodeTiled (negated), kErrNoEncoder when the driver has no
// such entry point.
constexpr int kErrNoEncoder = -1000;

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiledFn>(ptr);
  }();
  return fn;
}

// The 4-D map (d, h, t, b) of a strided [B, T, H, 128] bf16 tensor, read in
// boxes of 64 d x 128 rows of one head, 128-byte swizzled, zero past T.
int encode_map(CUtensorMap* map, const void* ptr, int B, int T, int H, const Strides& s) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[4] = {cuuint64_t(kWgD), cuuint64_t(H), cuuint64_t(T), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(s.h) * 2, cuuint64_t(s.t) * 2, cuuint64_t(s.b) * 2};
  const cuuint32_t box[4] = {64, 1, cuuint32_t(kWgRows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                          strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : -int(res);
}

int launch_wgmma(const Params& p, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = encode_map(&mq, p.q, p.B, p.Tq, p.H, p.sq);
  if (!err) err = encode_map(&mk, p.k, p.B, p.Tk, p.H, p.sk);
  if (!err) err = encode_map(&mv, p.v, p.B, p.Tk, p.H, p.sv);
  if (err) return err;
  // The SM count of each card, and the kernel's shared-memory limit, set
  // once per card rather than at each call.
  static int sms_of[64] = {};
  int device = 0, sms = 0;
  cudaError_t cerr = cudaGetDevice(&device);
  if (cerr != cudaSuccess) return int(cerr);
  if (device < 64) sms = sms_of[device];
  if (sms == 0) {
    cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (cerr == cudaSuccess)
      cerr = cudaFuncSetAttribute(flash_fwd_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  int(kWgSmemBytes));
    if (cerr != cudaSuccess) return int(cerr);
    if (device < 64) sms_of[device] = sms;
  }
  // One block an SM (its shared memory allows no more), each walking its
  // share of the items.
  const long long items = (long long)((p.Tq + kWgRows - 1) / kWgRows) * p.B * p.H;
  const dim3 grid(unsigned(items < sms ? items : sms));
  flash_fwd_wgmma<<<grid, kWgThreads, kWgSmemBytes, stream>>>(mq, mk, mv, p);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// variant: 0 = scalar body, 1 = mma body, 2 = wgmma body. dtype: 0 =
// float32, 1 = bfloat16, 2 = float16 (scalar body only).
// Strides are in elements, for [B, T, H, D] with a d stride of 1.
// Returns the launch's cudaError_t (0 on success), or below zero an error of
// the wgmma body's tensor maps (mxtt_error_string says which); the launch is
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

  if (variant == 2) {
    // TMA: 16-byte aligned bases and 16-byte strides; the epilogue's
    // 16-byte stores: the same of o.
    const void* ptrs[4] = {q, k, v, o};
    const Strides* st[4] = {&p.sq, &p.sk, &p.sv, &p.so};
    bool ok = dtype == 1 && D == kWgD && scale > 0.f &&
              (long long)((Tq + kWgRows - 1) / kWgRows) * B * H <= 2147483647LL;
    for (int i = 0; i < 4; ++i)
      ok = ok && (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0) && st[i]->b % 8 == 0 &&
           st[i]->t % 8 == 0 && st[i]->h % 8 == 0 && st[i]->b > 0 && st[i]->t > 0 &&
           st[i]->h > 0;
    if (!ok) return int(cudaErrorInvalidValue);
    return launch_wgmma(p, s);
  }
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
  static thread_local char msg[96];
  if (err == kErrNoEncoder)
    return "the driver has no cuTensorMapEncodeTiled entry point";
  if (err < 0) {
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed (CUresult %d)", -err);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
