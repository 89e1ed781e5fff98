// Flash-attention forward kernels for Hopper (sm_90a), plain C entry points
// bound from Python with ctypes (kernels/flashattn/kernel.py).
//
// Replaces the three forward Pallas TPU kernels of
// src/repro/kernels/flashattn/kernel.py:
//   flash_attention          (kernel.py:106)  causal / windowed GQA attention
//                                             with an online softmax -> out
//   flash_attention_checked  (kernel.py:258)  the same out plus the f32 check
//                                             column c/l (c <- c*alpha +
//                                             p . rowsum_hd(v)) and csum, the
//                                             per-row mod-2^32 sum of out's
//                                             bit patterns
//   flash_attention_fwd_lse  (kernel.py:522)  the same out plus lse = m + log l
// q is (B, H, S, hd), k and v (B, KV, S, hd), all row-major, f32 or bf16;
// out has q's type; check and lse are (B, H, S) f32, csum (B, H, S) int64
// holding the uint32 value.  hd is 16, 32, 64, 112 or 128.  Each entry runs
// one kernel: flash_fwd_mma_kernel<HD, EMIT> for bf16, flash_fwd_kernel<HD,
// EMIT> for f32.
//
// hd = 112 (kimi-k2's 64 heads over 8 KV heads) is 7 x 16: QK^T takes 7
// k-steps of m16n8k16, PV 14 n-tiles of 8 (acc[14][4], 56 registers), a
// row 14 16-byte cp.async chunks.  Shared rows are 112 + 8 bf16 = 240
// bytes, 60 words: the 8 rows one ldmatrix reads start at banks 0, 28,
// 24, ..., 4, four words each, so they still fall on distinct banks (no
// swizzle assumes a power-of-two row).  The f32 kernel's lanes cover
// columns lane + 32 i for i < 4, and the HD % 32 guards skip 112-127.
//
// Bound on an H100 SXM: max(bytes / 3.35 TB/s, 4*B*H*hd*S(S+1)/2 causal
// FLOPs / 989 TFLOP/s for bf16 or 67 TFLOP/s for f32), each input read once
// and each output written once.  At the SmolLM-135M prefill shape (B 1, H 9,
// KV 3, hd 64, bf16) that is bytes up to S of about 800 and operations
// above: 0.06 us at S = 64, 1.2 us at S = 1024; at the training shape (B 8,
// S 1024) 9.8 us, operations.
//
// Bit identity of out across the three entries.  ABFT recovery swaps
// flagged rows of the checked kernel's out for the plain kernel's, so the
// two must agree bit for bit.  For each input type one kernel template,
// instantiated per output set (EMIT), holds the single copy of the tiling
// and the operation order; the extra outputs only add independent work.
// The f32 arithmetic outside the mma instructions is the order written
// here: products are explicit __fmaf_rn, and the file is compiled with
// -fmad=false (kernel.py), so nvcc cannot contract a*b+c differently in one
// instantiation than in another.  Each output row is reduced in one warp in
// a fixed order (no split over blocks, no atomics), so two launches on the
// same inputs give the same bits, which DMR and TMR compare.  Scores are
// multiplied by the f32 scale 1/sqrt(hd) after the dot, as the reference;
// out = acc / max(l, 1e-30) is an IEEE divide, rounded to nearest; csum sums
// the very bits stored (bf16 as 16 bits, zero-extended) in uint32.
//
// Masks.  Tiles wholly above the diagonal or before the window are
// skipped, as the TPU kernel skips grid steps.  Keys past S are zero and
// masked (score -1e30), V rows past S are zero (the reference's 0*NaN
// guard), Q rows past S are computed on zeros and not stored.  q-head h
// reads kv-head h / G in place (G = 3 for SmolLM-135M), no KV replication.
//
// bf16: tensor cores (flash_fwd_mma_kernel).  A block of 4 warps owns 64
// query rows of one (b, h), 16 per warp, and loops over the 64-key tiles of
// the causal band or window, keeping m, l, acc (and c) in registers.
// Warp-level mma.sync.m16n8k16 (bf16 operands, f32 accumulators) fed by
// ldmatrix from shared memory rows padded by 8 bf16 (the 8 rows one
// ldmatrix reads fall on distinct banks); the K and V tiles arrive by
// cp.async, double-buffered, so the next tile's copy runs under this one's
// products, with zero fill past S.  Q's fragments stay in registers for the
// whole key loop.  Per tile each warp forms S = Q K^T (16 x 64) on the
// accumulators, masks only where the tile meets the diagonal, the window's
// edge or the end of the sequence (a block-uniform test: a tile wholly
// inside the band takes no mask), takes m, l and alpha by shuffles over the
// quad of lanes that holds a row, forms p = exp(s*scale - m) in f32 and
// adds P V into acc.  The accumulator fragment of S is the A-operand
// layout of P V, so P never goes through shared memory; ldmatrix.trans
// reads V as the B operand.  Grid (B*H, ceil(S/64)), the query tiles in
// reverse so that the causal tiles with the most keys start first: 144
// blocks at (1, 9, 1024) for 132 SMs, 9 at S = 64; the training shape (8,
// 9, 1024) has 1152.  Shared memory (Q, two K and two V tiles) is 45 KB at
// hd = 64 and 85 KB at hd = 128, taken dynamically after
// cudaFuncSetAttribute.
//
//   Why P goes in as two bf16 values.  S takes its operands straight from
//   bf16 memory and is exact; p is an f32 value formed on the
//   accumulators.  Rounded once to bf16 (8 significant bits), the output
//   leaves chip_smoke.py's limit (one bf16 step of |w| plus 1e-5 (1 + |w|))
//   by ~110x; as hi = bf16(p) and lo = bf16(p - hi) (16 bits), two products
//   into one f32 accumulator, it stays within 0.993-0.996 of it (CPU
//   emulation of these numerics, tests/test_torch_flash_fwd_split.py: (1,
//   9, 1024, 64) causal, (1, 9, 300, 64) window 100, (1, 4, 1000, 128)).
//   Exact f32 products summed in this order already leave one bf16 step
//   alone by up to 168x, on outputs that cancel to near zero, hence the
//   f32 term.  So the design does three bf16 products per visible score
//   (S, then P V twice): 14.5 GFLOP at the training shape, 15 us at the
//   bf16 peak.  The check column (kChecked) is summed from the f32 p, not
//   from the split: c <- c*alpha + sum_j p_j rowsum_hd(v_j), with
//   rowsum_hd(v) of each key computed once per tile into shared memory.
//
//   What still holds it back (an H100 SXM at 700 W, chip_smoke.py: about
//   0.07 ms of device time at the training shape and 0.025 ms at (1, 9,
//   1024, 64), twice SDPA's): mma.sync, not wgmma (the warp-group,
//   asynchronous product that reaches the full tensor-core rate); cp.async
//   issued by every thread, not TMA; one warp's chain of products,
//   shuffles and exps per 16 rows, with no second warp group to overlap the
//   softmax; and at B = 1 the grid of 144 blocks is barely more than one
//   wave, so the longest block's 16 key tiles in series set the time.
//   Splitting that key loop across two warp groups of one block, merged in
//   a fixed order, would shorten it without atomics.
//
// f32: CUDA cores (flash_fwd_kernel).  f32 inputs keep f32 accuracy: no
// TF32 or bf16 tiles.  A block owns 16 query rows of one (b, h), 4 per
// warp, and runs the K loop inside itself.  A tile is 32 keys, one per
// lane: the warp's 4 rows score their 32 keys with the K tile in shared
// memory (rows padded by one word so that lane j reading row j hits 32
// banks), the row max and sum are butterfly shuffles (every lane ends with
// the same value: IEEE addition is commutative), and the PV product
// broadcasts p_j by shuffle while each lane accumulates its hd/32 columns
// from the V tile.  Grid (ceil(S/16), B*H).  Its products are f32 FMAs
// (67 TFLOP/s), so at S = 1024 it cannot beat about 18 us.
//
// Each C entry returns the first CUDA error of its launch (0 on success).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
// f32 path
constexpr int kBQ = 16;                       // query rows per block
constexpr int kBK = 32;                       // keys per tile, one per lane
constexpr int kRows = kBQ / kWarps;           // query rows per warp
// bf16 path: 16 query rows per warp
constexpr int kMmaBQ = 16 * kWarps;           // query rows per block
constexpr int kMmaBK = 64;                    // keys per tile
constexpr int kPad = 8;                       // bf16 of padding per shared row

enum Emit { kOut = 0, kChecked = 1, kLse = 2 };

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;          // kLse
  float* check;        // kChecked
  long long* csum;     // kChecked
  int b, h, kv, s;
  int causal;
  int window;          // < 0: no window
  float scale;
};

// key visible from query row
__device__ __forceinline__ bool visible(const Args& a, int key, int row) {
  return key < a.s && (!a.causal || key <= row) &&
         (a.window < 0 || key >= row - a.window);
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = x + __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ uint32_t warp_sum_u32(uint32_t x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <int HD, int EMIT>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Args a) {
  constexpr int kDPL = (HD + 31) / 32;        // output columns per lane
  __shared__ float q_s[kBQ][HD];
  __shared__ float k_s[kBK][HD + 1];          // +1: conflict-free row reads
  __shared__ float v_s[kBK][HD];
  __shared__ float v1_s[kBK];                 // rowsum_hd(v), kChecked

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / a.h, h = bh % a.h;
  const int kvh = b * a.kv + h / (a.h / a.kv);
  const int q_lo = blockIdx.x * kBQ;
  const size_t k_off = static_cast<size_t>(kvh) * a.s * HD;
  const float* q =
      static_cast<const float*>(a.q) + static_cast<size_t>(bh) * a.s * HD;
  const float* k = static_cast<const float*>(a.k) + k_off;
  const float* v = static_cast<const float*>(a.v) + k_off;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, row = q_lo + r;
    q_s[r][d] = row < a.s ? q[static_cast<size_t>(row) * HD + d] : 0.f;
  }

  float m[kRows], l[kRows], c[kRows], acc[kRows][kDPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
    c[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) acc[r][i] = 0.f;
  }

  // the K tiles that meet this block's rows: up to the diagonal when
  // causal, from the tile holding key q_lo - window when windowed
  const int k_end = a.causal ? min(a.s, q_lo + kBQ) : a.s;
  const int k_begin = a.window >= 0 ? max(0, q_lo - a.window) / kBK * kBK : 0;

  for (int k_lo = k_begin; k_lo < k_end; k_lo += kBK) {
    __syncthreads();                          // the last tile's reads are done
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD, row = k_lo + r;
      const bool in = row < a.s;
      const size_t off = static_cast<size_t>(row) * HD + d;
      k_s[r][d] = in ? k[off] : 0.f;
      v_s[r][d] = in ? v[off] : 0.f;
    }
    __syncthreads();
    if (EMIT == kChecked) {
      if (tid < kBK) {
        float t = 0.f;
        for (int d = 0; d < HD; ++d) t = t + v_s[tid][d];
        v1_s[tid] = t;
      }
      __syncthreads();
    }

    // scores of this lane's key for the warp's rows, then the online softmax
    const int key = k_lo + lane;
    float p[kRows], alpha[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) p[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float kd = k_s[lane][d];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        p[r] = __fmaf_rn(q_s[warp * kRows + r][d], kd, p[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qrow = q_lo + warp * kRows + r;
      const float s = visible(a, key, qrow) ? p[r] * a.scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(s));
      alpha[r] = expf(m[r] - m_new);
      p[r] = expf(s - m_new);
      l[r] = l[r] * alpha[r] + warp_sum(p[r]);
      if (EMIT == kChecked)
        c[r] = c[r] * alpha[r] + warp_sum(p[r] * v1_s[lane]);
      m[r] = m_new;
    }

    // acc <- acc * alpha + p . V, p_j broadcast from lane j
    float pv[kRows][kDPL];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int i = 0; i < kDPL; ++i) pv[r][i] = 0.f;
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vj[kDPL];
#pragma unroll
      for (int i = 0; i < kDPL; ++i) {
        const int d = lane + 32 * i;
        vj[i] = (HD % 32 == 0 || d < HD) ? v_s[j][d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(kFull, p[r], j);
#pragma unroll
        for (int i = 0; i < kDPL; ++i) pv[r][i] = __fmaf_rn(pj, vj[i], pv[r][i]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int i = 0; i < kDPL; ++i) acc[r][i] = acc[r][i] * alpha[r] + pv[r][i];
  }

  float* out = static_cast<float*>(a.out) + static_cast<size_t>(bh) * a.s * HD;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qrow = q_lo + warp * kRows + r;
    const float lc = fmaxf(l[r], 1e-30f);
    uint32_t bits = 0;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      const int d = lane + 32 * i;
      if (HD % 32 == 0 || d < HD) {
        const float o = acc[r][i] / lc;
        if (qrow < a.s) out[static_cast<size_t>(qrow) * HD + d] = o;
        bits += __float_as_uint(o);
      }
    }
    if (EMIT == kChecked) bits = warp_sum_u32(bits);
    if (lane == 0 && qrow < a.s) {
      const size_t row = static_cast<size_t>(bh) * a.s + qrow;
      if (EMIT == kLse) a.lse[row] = m[r] + logf(lc);
      if (EMIT == kChecked) {
        a.check[row] = c[r] / lc;
        a.csum[row] = static_cast<long long>(bits);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

template <int HD, int EMIT>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * (kMmaBQ + 4 * kMmaBK) * (HD + kPad) +
         (EMIT == kChecked ? sizeof(float) * kMmaBK : 0);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zeros where !ok (src is then any valid
// address and is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + ROWS) of a row-major (s, HD) bf16 matrix into shared
// rows of HD + kPad, zeros past row s
template <int ROWS, int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int row0, int s) {
  constexpr int kChunks = HD / 8;              // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks * 8, row = row0 + r;
    const bool ok = row < s;
    cp_async16(dst + r * (HD + kPad) + c,
               src + (ok ? static_cast<size_t>(row) * HD + c : 0), ok);
  }
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The lane's row address for an ldmatrix.x4 of the 16 x 16 tile at
// (r0, c0) of a shared matrix with row stride LD.
//
// a_tile reads the quarters (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15),
// (8-15, 8-15): the A fragment a0..a3 of m16n8k16 where rows are m and
// cols k; with .trans, where rows are k and cols n, the B fragments b0, b1
// of the n-tile at c0 and then of the one at c0 + 8.
template <int LD>
__device__ __forceinline__ const bf16* a_tile(const bf16* m, int r0, int c0,
                                              int lane) {
  return m + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8;
}

// b_tile reads (rows 0-7, cols 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15):
// where rows are n and cols k, the B fragments b0, b1 of the n-tile at r0
// and then of the one at r0 + 8.
template <int LD>
__device__ __forceinline__ const bf16* b_tile(const bf16* m, int r0, int c0,
                                              int lane) {
  return m + (r0 + (lane & 7) + (lane >> 4) * 8) * LD + c0 +
         ((lane >> 3) & 1) * 8;
}

// d += a b on the tensor cores: m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the two bf16 of x as one register, x.x in the low half
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(x.x)) |
         static_cast<uint32_t>(__bfloat16_as_ushort(x.y)) << 16;
}

// two f32 of one row (adjacent columns) as hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h)));
}

// The hi and lo A fragments of k-step kk of a product whose A operand is
// the f32 accumulator tile c (16 rows, 8 columns per n-tile): an
// accumulator's n-tiles 2kk and 2kk + 1 hold the fragment's columns.
template <int NT>
__device__ __forceinline__ void split_a(const float (&c)[NT][4], int kk,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split2(c[2 * kk][0], c[2 * kk][1], hi[0], lo[0]);
  split2(c[2 * kk][2], c[2 * kk][3], hi[1], lo[1]);
  split2(c[2 * kk + 1][0], c[2 * kk + 1][1], hi[2], lo[2]);
  split2(c[2 * kk + 1][2], c[2 * kk + 1][3], hi[3], lo[3]);
}

// reductions over the quad of lanes that holds one accumulator row; every
// lane of the quad ends with the same value (IEEE min/max and addition
// are commutative)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x = x + __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

__device__ __forceinline__ uint32_t quad_sum_u32(uint32_t x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

template <int HD, int EMIT>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_mma_kernel(const Args a) {
  constexpr int kLd = HD + kPad;
  constexpr int kNT = kMmaBK / 8;             // n-tiles of S
  constexpr int kDT = HD / 8;                 // n-tiles of acc
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(fwd_smem);  // [kMmaBQ][kLd]
  bf16* k_s = q_s + kMmaBQ * kLd;             // [2][kMmaBK][kLd]
  bf16* v_s = k_s + 2 * kMmaBK * kLd;         // [2][kMmaBK][kLd]
  float* v1_s = reinterpret_cast<float*>(v_s + 2 * kMmaBK * kLd);  // [kMmaBK]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.x;
  const int b = bh / a.h, h = bh % a.h;
  const int kvh = b * a.kv + h / (a.h / a.kv);
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * kMmaBQ;
  const size_t q_off = static_cast<size_t>(bh) * a.s * HD;
  const size_t k_off = static_cast<size_t>(kvh) * a.s * HD;
  const bf16* k = static_cast<const bf16*>(a.k) + k_off;
  const bf16* v = static_cast<const bf16*>(a.v) + k_off;

  // the K tiles that meet this block's rows: up to the diagonal when
  // causal, from the tile holding key q_lo - window when windowed; never
  // empty
  const int k_end = a.causal ? min(a.s, q_lo + kMmaBQ) : a.s;
  const int k_begin =
      a.window >= 0 ? max(0, q_lo - a.window) / kMmaBK * kMmaBK : 0;
  const int n_tiles = (k_end - k_begin + kMmaBK - 1) / kMmaBK;

  load_rows<kMmaBQ, HD>(q_s, static_cast<const bf16*>(a.q) + q_off, q_lo,
                        a.s);
  cp_commit();
  load_rows<kMmaBK, HD>(k_s, k, k_begin, a.s);
  load_rows<kMmaBK, HD>(v_s, v, k_begin, a.s);
  cp_commit();
  cp_wait<1>();                               // Q has landed
  __syncthreads();

  // Q's fragments, kept in registers for the whole key loop
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldsm(qa[kk], a_tile<kLd>(q_s, warp * 16, kk * 16, lane));

  // the lane's rows of the accumulator tiles: r0 and r0 + 8; its columns of
  // each n-tile: col and col + 1
  const int r0 = q_lo + warp * 16 + (lane >> 2), col = (lane & 3) * 2;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, c[2] = {0.f, 0.f};
  float acc[kDT][4] = {};

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {                    // the next tile's copy
      const int nxt = k_begin + (t + 1) * kMmaBK, buf = (t + 1) & 1;
      load_rows<kMmaBK, HD>(k_s + buf * kMmaBK * kLd, k, nxt, a.s);
      load_rows<kMmaBK, HD>(v_s + buf * kMmaBK * kLd, v, nxt, a.s);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();                          // this tile has landed
    const int k_lo = k_begin + t * kMmaBK;
    const bf16* kt = k_s + (t & 1) * kMmaBK * kLd;
    const bf16* vt = v_s + (t & 1) * kMmaBK * kLd;
    if (EMIT == kChecked) {                   // rowsum_hd(v) of each key
      if (threadIdx.x < kMmaBK) {
        float sum = 0.f;
        for (int d = 0; d < HD; ++d)
          sum = sum + __bfloat162float(vt[threadIdx.x * kLd + d]);
        v1_s[threadIdx.x] = sum;
      }
      __syncthreads();
    }

    // S = Q K^T, the warp's 16 rows by the tile's keys
    float s[kNT][4] = {};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kNT; n += 2) {
        uint32_t kb[4];
        ldsm(kb, b_tile<kLd>(kt, n * 8, kk * 16, lane));
        mma(s[n], qa[kk], kb[0], kb[1]);
        mma(s[n + 1], qa[kk], kb[2], kb[3]);
      }
    }
    // scale, and mask where the tile meets the diagonal, the window's
    // edge or the end of the sequence
    const bool edge = k_lo + kMmaBK > a.s ||
                      (a.causal && k_lo + kMmaBK - 1 > q_lo) ||
                      (a.window >= 0 && k_lo < q_lo + kMmaBQ - 1 - a.window);
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = !edge || visible(a, k_lo + n * 8 + col + (e & 1),
                                         r0 + 8 * (e >> 1));
        s[n][e] = ok ? s[n][e] * a.scale : kNegInf;
      }
    // the online softmax: p in place of s
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      const float m_new = fmaxf(m[i], quad_max(mx));
      alpha[i] = expf(m[i] - m_new);
      float sum = 0.f, chk = 0.f;
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float p = expf(s[n][2 * i + j] - m_new);
          s[n][2 * i + j] = p;
          sum = sum + p;
          if (EMIT == kChecked) chk = __fmaf_rn(p, v1_s[n * 8 + col + j], chk);
        }
      l[i] = l[i] * alpha[i] + quad_sum(sum);
      if (EMIT == kChecked) c[i] = c[i] * alpha[i] + quad_sum(chk);
      m[i] = m_new;
    }
    // acc <- acc * alpha + P V, P as hi + lo, keys in order
#pragma unroll
    for (int n = 0; n < kDT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = acc[n][e] * alpha[e >> 1];
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_a(s, kk, hi, lo);
#pragma unroll
      for (int n = 0; n < kDT; n += 2) {
        uint32_t vb[4];
        ldsm_t(vb, a_tile<kLd>(vt, kk * 16, n * 8, lane));
        mma(acc[n], hi, vb[0], vb[1]);
        mma(acc[n], lo, vb[0], vb[1]);
        mma(acc[n + 1], hi, vb[2], vb[3]);
        mma(acc[n + 1], lo, vb[2], vb[3]);
      }
    }
    __syncthreads();                          // done reading this buffer
  }

  // out = acc / l in bf16, rows past S not stored; csum over the quad
  bf16* out = static_cast<bf16*>(a.out) + q_off;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    const float lc = fmaxf(l[i], 1e-30f);
    uint32_t sum = 0;
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      const __nv_bfloat162 o =
          __floats2bfloat162_rn(acc[n][2 * i] / lc, acc[n][2 * i + 1] / lc);
      if (row < a.s)
        *reinterpret_cast<__nv_bfloat162*>(
            out + static_cast<size_t>(row) * HD + n * 8 + col) = o;
      sum += static_cast<uint32_t>(__bfloat16_as_ushort(o.x)) +
             static_cast<uint32_t>(__bfloat16_as_ushort(o.y));
    }
    if (EMIT == kChecked) sum = quad_sum_u32(sum);
    if ((lane & 3) == 0 && row < a.s) {
      const size_t at = static_cast<size_t>(bh) * a.s + row;
      if (EMIT == kLse) a.lse[at] = m[i] + logf(lc);
      if (EMIT == kChecked) {
        a.check[at] = c[i] / lc;
        a.csum[at] = static_cast<long long>(sum);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int HD, int EMIT>
int launch_hd(const Args& a, bool bf16_in, cudaStream_t stream) {
  if (!bf16_in) {
    const dim3 grid((a.s + kBQ - 1) / kBQ, a.b * a.h);
    flash_fwd_kernel<HD, EMIT><<<grid, kThreads, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr size_t smem = mma_smem_bytes<HD, EMIT>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<HD, EMIT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.b * a.h, (a.s + kMmaBQ - 1) / kMmaBQ);
  flash_fwd_mma_kernel<HD, EMIT><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int EMIT>
int launch(Args a, int hd, int bf16_in, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_hd<16, EMIT>(a, bf16_in != 0, st);
    case 32: return launch_hd<32, EMIT>(a, bf16_in != 0, st);
    case 64: return launch_hd<64, EMIT>(a, bf16_in != 0, st);
    case 112: return launch_hd<112, EMIT>(a, bf16_in != 0, st);
    case 128: return launch_hd<128, EMIT>(a, bf16_in != 0, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

Args make_args(const void* q, const void* k, const void* v, void* out, int b,
               int h, int kv, int s, int causal, int window, float scale) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.b = b;
  a.h = h;
  a.kv = kv;
  a.s = s;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  return a;
}

}  // namespace

extern "C" {

int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int b, int h, int kv, int s, int hd,
                           int causal, int window, int bf16, float scale,
                           void* stream) {
  return launch<kOut>(make_args(q, k, v, out, b, h, kv, s, causal, window, scale),
                      hd, bf16, stream);
}

int flash_attention_checked_launch(const void* q, const void* k, const void* v,
                                   void* out, void* check, void* csum, int b,
                                   int h, int kv, int s, int hd, int causal,
                                   int window, int bf16, float scale,
                                   void* stream) {
  Args a = make_args(q, k, v, out, b, h, kv, s, causal, window, scale);
  a.check = static_cast<float*>(check);
  a.csum = static_cast<long long*>(csum);
  return launch<kChecked>(a, hd, bf16, stream);
}

int flash_attention_fwd_lse_launch(const void* q, const void* k, const void* v,
                                   void* out, void* lse, int b, int h, int kv,
                                   int s, int hd, int causal, int window,
                                   int bf16, float scale, void* stream) {
  Args a = make_args(q, k, v, out, b, h, kv, s, causal, window, scale);
  a.lse = static_cast<float*>(lse);
  return launch<kLse>(a, hd, bf16, stream);
}

}  // extern "C"
