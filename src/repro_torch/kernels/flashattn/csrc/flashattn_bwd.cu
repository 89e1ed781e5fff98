// Flash-attention backward kernels for Hopper (sm_90a), one plain C entry
// point bound from Python with ctypes (kernels/flashattn/kernel.py).
//
// Replaces the backward Pallas TPU kernel of
// src/repro/kernels/flashattn/kernel.py:
//   flash_attention_bwd  (kernel.py:571)  (dq, dk, dv) from q, k, v, out,
//                                          lse, dO; its two pallas_calls
//                                          (:603 dQ, :640 dK/dV) become two
//                                          kernels for each input type:
//     _flash_bwd_dq_kernel   (kernel.py:419)  -> flash_bwd_dq_mma_kernel
//                                               (bf16), flash_bwd_dq_kernel
//                                               (f32)
//     _flash_bwd_dkv_kernel  (kernel.py:466)  -> flash_bwd_dkv_mma_kernel
//                                               (bf16), flash_bwd_dkv_kernel
//                                               (f32)
// q, out, dO and dq are (B, H, S, hd), k, v, dk and dv (B, KV, S, hd), all
// row-major, f32 or bf16 (the gradients have the inputs' type); lse and
// dvec = rowsum(dO * out) are (B, H, S) f32.  dvec is a tensor op in the
// wrapper, as in the reference (kernel.py:583).  hd is 16, 32, 64, 112 or
// 128.
//
// Bound on an H100 SXM: max(bytes / 3.35 TB/s, 10*B*H*hd*S(S+1)/2 causal
// FLOPs / 989 TFLOP/s bf16 or 67 TFLOP/s f32): five products per visible
// score (S = QK^T, dP = dO V^T, dV = P^T dO, dK = dS^T Q, dQ = dS K), each
// input read once and each output written once.  That is the function's own
// work, not this design's.  At (1, 9, 1024, 64)/(1, 3, 1024, 64) bf16:
// 3.1 us, operations; at the training shape (8, 9, 1024, 64): 24.5 us,
// operations (51 MB of traffic would take 15 us).
//
// Determinism.  Blocks run in no order on 132 SMs and nothing carries over
// between them, so each gradient row is owned by exactly one block that
// loops over everything it sums, in a fixed order: no split reductions and
// no float atomics.  Two launches on the same inputs give the same bits,
// which the fault-tolerant trainer's bit-identical replay relies on.
//
// bf16: tensor cores.  Warp-level mma.sync.m16n8k16 (bf16 operands, f32
// accumulators) fed by ldmatrix from shared memory; every tile arrives by
// cp.async, double-buffered, so the next tile's copy runs under this one's
// products.  Shared rows are padded by 8 bf16 so that the 8 rows one
// ldmatrix reads fall on distinct banks.
//
//   dQ: a block of 4 warps owns 64 query rows of one (b, h), 16 per warp,
//   and loops over the 64-key tiles of the causal band or window (the
//   forward's range).  Per tile each warp forms S = Q K^T and dP = dO V^T
//   (16 x 64) on the accumulators, p = exp(s*scale - lse) (the reference's
//   _recompute_p) and ds = p (dp - dvec) scale in f32 on those fragments,
//   and dq += dS K.  Grid (B*H, ceil(S/64)), the query tiles in reverse so
//   that the causal rows with the most keys start first.
//
//   dK/dV: a block of 4 warps owns 64 keys of one (b, kv-head), 16 per
//   warp, and loops over the G query heads of the group and, for each, the
//   query tiles (64 rows; 32 at hd 112 and 128) that can see its keys: the
//   reference's sequential G*nq scan, which also sums the GQA group without
//   atomics.  Per tile each warp forms S^T = K Q^T and dP^T = V dO^T, keys
//   as rows, so that P^T and dS^T come out in the A-operand layout of
//   dv += P^T dO and dk += dS^T Q.  Grid (B*KV, ceil(S/64)): key tile 0,
//   which the most causal query tiles see, first.
//
//   The tensor cores' f32 accumulation comes out short on long sums: over
//   llama3-405b's G * S = 16 * 1024 products per dk and dv element (2,048
//   mma steps into one accumulator) the mean error of |dk| and |dv| was
//   -2.4e-5 and -2.5e-5 relative to a float64 witness, against -3e-6 and
//   -5e-6 for the plain version, and 14 elements left chip_smoke.py's
//   limit (python -m repro_torch.kernels.flashattn.bwd_witness, an H100).
//   So dk and dv are flushed every kFlushTiles query tiles into f32
//   totals with round-to-nearest adds, in a fixed order: at most 64 mma
//   steps (128 at 64-row tiles) feed an accumulator between flushes,
//   whatever G and S.  The totals, each thread's own fragment's, live in
//   an f32 workspace the wrapper allocates (64 KB a block at hd 128): held
//   in shared memory they would double the block's 70 KB and halve the
//   blocks an SM runs (mixtral-8x7b's windowed shape took 1.4x as long).
//
//   ldmatrix without .trans reads the A operands (Q, dO; K, V) and the B
//   operands of S and dP (K^T, V^T; Q^T, dO^T), whose k index runs along a
//   shared row; with .trans it reads the B operands of the three gradient
//   products (K for dQ, dO for dV, Q for dK), whose k index runs down.
//
//   Why P and dS go in as two bf16 values.  S and dP take their operands
//   straight from bf16 memory and are exact; P and dS are f32 values formed
//   on the accumulators.  Rounded once to bf16 (8 significant bits), the
//   dV, dK and dQ products leave chip_smoke.py's tolerance (5e-5 (1 + |w|)
//   plus one bf16 step of the plain value) by 18-62x; as hi = bf16(x) and
//   lo = bf16(x - hi) (16 bits), two products each into one f32
//   accumulator, they stay within 0.90-0.98 of it (CPU emulation of these
//   numerics, tests/test_torch_flash_bwd_split.py: (1, 3, 1024, 64) causal,
//   (1, 3, 512, 64) window 100, (1, 3, 1000, 128)).  So the design does
//   ten bf16 products per visible score: S and dP in both kernels, and the
//   three gradient products twice; 48 GFLOP at the training shape, 49 us at
//   the bf16 peak.
//
//   Registers.  At hd = 128 the dk and dv accumulators of 16 keys take 128
//   registers a thread, so the dK/dV query tile is 32 rows there (S^T and
//   dP^T then take 32; ptxas: 254 registers, no spill).  At hd = 112 they
//   take 112, and a 64-row tile's S^T and dP^T would add 64 more, so the
//   tile is 32 rows there too.
//
//   What still holds it back: mma.sync, not wgmma (the warp-group,
//   asynchronous product that reaches the full tensor-core rate); cp.async
//   issued by every thread, not TMA; S and dP computed in both kernels; one
//   or two warps per SM sub-partition, so each warp's chain of loads,
//   products and exps is exposed; and the dK/dV kernel's longest block
//   (key tile 0 under causality, G * S/64 query tiles in series) is most of
//   its time at any batch (an H100 SXM at 700 W: 0.198 ms at (1, 9, 1024,
//   64), 0.226 ms at (8, 9, 1024, 64), chip_smoke.py).  At B = 1 and 3 KV
//   heads the dK/dV grid is 48 blocks for 132 SMs.
//
// f32: CUDA cores.  f32 inputs keep f32 accuracy: no TF32 or bf16 tiles.
// f32 FMAs, seven products per score.
//
//   dQ: a block owns 16 query rows of one (b, h) (4 per warp) and loops
//   over the 32-key tiles of the causal band or window.  Lane j scores key
//   j of the tile against the warp's rows (s = q.k, dp = dO.v from shared
//   memory, K and V rows padded by one word so that lane j reading row j
//   hits 32 banks), forms p and ds, and the dQ product broadcasts ds_j by
//   shuffle while each lane accumulates its hd/32 columns of dq from the K
//   tile.  Grid (ceil(S/16), B*H).
//
//   dK/dV: a block owns 32 keys of one (b, kv-head) (8 per warp) and loops
//   over the G query heads and, for each, the 32-row query tiles that can
//   see its keys, accumulating dk and dv in registers.  Lane i scores query
//   row i of the tile against the warp's 8 keys (Q and dO rows padded in
//   shared memory, K and V rows read by broadcast), and the dV and dK
//   products broadcast p_ij and ds_ij by shuffle while each lane
//   accumulates its hd/32 columns.  Grid (ceil(S/32), B*KV).
//
// Ragged and masked entries.  Rows of q, dO and keys past S load as zeros
// (cp.async's zero fill on the bf16 path); p and ds are selected to exact
// zeros wherever the key is not visible from the row or either lies past S
// (the reference's 0*NaN guards at kernel.py:453-455 and :505-508 become
// these selects), so no out-of-range lse or dvec is read; rows past S are
// not stored.
//
// FMA policy.  The f32 arithmetic outside the mma instructions is the
// order written here: the f32 products are explicit __fmaf_rn and the file
// is built with -fmad=false (kernel.py), as the forward.  Each kernel
// needs more than 48 KB of shared memory at its larger head dims, so all
// take it dynamically, after cudaFuncSetAttribute.
//
// The C entry launches both kernels of the inputs' type on the given
// stream and returns the first CUDA error (0 on success).  For bf16 inputs
// acc is an f32 workspace of flash_attention_bwd_workspace_floats(b, kv, s,
// hd) floats, the dK/dV kernel's totals; f32 inputs do not read it.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
// f32 path
constexpr int kBQ = 16;                        // dQ: query rows per block
constexpr int kRowsQ = kBQ / kWarps;           // dQ: query rows per warp
constexpr int kBK = 32;                        // dQ: keys per tile, one per lane
constexpr int kKeysW = 8;                      // dKV: keys per warp
constexpr int kBKV = kWarps * kKeysW;          // dKV: keys per block
constexpr int kQT = 32;                        // dKV: query rows per tile
constexpr unsigned kFull = 0xffffffffu;
// bf16 path: 16 rows of every tile per warp
constexpr int kMmaBQ = 16 * kWarps;            // dQ: query rows per block
constexpr int kMmaBK = 64;                     // dQ: keys per tile
constexpr int kMmaBKV = 16 * kWarps;           // dKV: keys per block
constexpr int kPad = 8;                        // bf16 of padding per shared row
constexpr int kFlushTiles = 16;                // dKV: query tiles per flush
// bf16 dKV: the f32 totals of dk and dv per block of kMmaBKV keys, every
// thread's accumulator fragments of both
__host__ __device__ constexpr long long dkv_totals(int hd) {
  return 2LL * (hd / 8) * 4 * kThreads;
}

// dKV: query rows per tile
template <int HD>
__host__ __device__ constexpr int mma_qt() { return HD > 64 ? 32 : 64; }

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* dvec;
  void* dq;
  void* dk;
  void* dv;
  float* acc;          // bf16 dK/dV: the f32 totals (the C entry's acc)
  int b, h, kv, s;
  int causal;
  int window;          // < 0: no window
  float scale;
};

// key visible from query row (both inside the sequence)
__device__ __forceinline__ bool visible(const Args& a, int key, int row) {
  return key < a.s && row < a.s && (!a.causal || key <= row) &&
         (a.window < 0 || key >= row - a.window);
}

// p and ds of one (row, key) pair from the dot products s = q.k, dp = dO.v
__device__ __forceinline__ void p_ds(const Args& a, bool ok, float s, float dp,
                                     float lse, float dvec, float& p,
                                     float& ds) {
  p = ok ? expf(s * a.scale - lse) : 0.f;
  ds = ok ? p * (dp - dvec) * a.scale : 0.f;
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

template <int HD>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * kBQ * HD + 2 * kBK * (HD + 1));
}

template <int HD>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * kBKV * HD + 2 * kQT * (HD + 1) + 2 * kQT);
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const Args a) {
  constexpr int kDPL = (HD + 31) / 32;        // dq columns per lane
  constexpr int kLd = HD + 1;
  extern __shared__ float smem[];
  float* q_s = smem;                          // [kBQ][HD]
  float* do_s = q_s + kBQ * HD;               // [kBQ][HD]
  float* k_s = do_s + kBQ * HD;               // [kBK][kLd]
  float* v_s = k_s + kBK * kLd;               // [kBK][kLd]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / a.h, h = bh % a.h;
  const int kvh = b * a.kv + h / (a.h / a.kv);
  const int q_lo = blockIdx.x * kBQ;
  const size_t q_off = static_cast<size_t>(bh) * a.s * HD;
  const size_t k_off = static_cast<size_t>(kvh) * a.s * HD;
  const float* q = static_cast<const float*>(a.q) + q_off;
  const float* dout = static_cast<const float*>(a.dout) + q_off;
  const float* k = static_cast<const float*>(a.k) + k_off;
  const float* v = static_cast<const float*>(a.v) + k_off;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int row = q_lo + i / HD;
    const size_t off = static_cast<size_t>(row) * HD + i % HD;
    q_s[i] = row < a.s ? q[off] : 0.f;
    do_s[i] = row < a.s ? dout[off] : 0.f;
  }
  float lse[kRowsQ], dvec[kRowsQ], acc[kRowsQ][kDPL];
#pragma unroll
  for (int r = 0; r < kRowsQ; ++r) {
    const int row = q_lo + warp * kRowsQ + r;
    const size_t at = static_cast<size_t>(bh) * a.s + row;
    lse[r] = row < a.s ? a.lse[at] : 0.f;
    dvec[r] = row < a.s ? a.dvec[at] : 0.f;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) acc[r][i] = 0.f;
  }

  // the forward's tile range: up to the diagonal when causal, from the tile
  // holding key q_lo - window when windowed
  const int k_end = a.causal ? min(a.s, q_lo + kBQ) : a.s;
  const int k_begin = a.window >= 0 ? max(0, q_lo - a.window) / kBK * kBK : 0;

  for (int k_lo = k_begin; k_lo < k_end; k_lo += kBK) {
    __syncthreads();                          // the last tile's reads are done
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD, row = k_lo + r;
      const size_t off = static_cast<size_t>(row) * HD + d;
      k_s[r * kLd + d] = row < a.s ? k[off] : 0.f;
      v_s[r * kLd + d] = row < a.s ? v[off] : 0.f;
    }
    __syncthreads();

    // s and dp of this lane's key for the warp's rows, then p and ds
    const int key = k_lo + lane;
    float s[kRowsQ], dp[kRowsQ], ds[kRowsQ];
#pragma unroll
    for (int r = 0; r < kRowsQ; ++r) s[r] = dp[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float kd = k_s[lane * kLd + d], vd = v_s[lane * kLd + d];
#pragma unroll
      for (int r = 0; r < kRowsQ; ++r) {
        s[r] = __fmaf_rn(q_s[(warp * kRowsQ + r) * HD + d], kd, s[r]);
        dp[r] = __fmaf_rn(do_s[(warp * kRowsQ + r) * HD + d], vd, dp[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsQ; ++r) {
      float p;
      p_ds(a, visible(a, key, q_lo + warp * kRowsQ + r), s[r], dp[r], lse[r],
           dvec[r], p, ds[r]);
    }

    // dq += ds . K, ds_j broadcast from lane j, keys in order
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float kj[kDPL];
#pragma unroll
      for (int i = 0; i < kDPL; ++i) {
        const int d = lane + 32 * i;
        kj[i] = (HD % 32 == 0 || d < HD) ? k_s[j * kLd + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsQ; ++r) {
        const float dsj = __shfl_sync(kFull, ds[r], j);
#pragma unroll
        for (int i = 0; i < kDPL; ++i) acc[r][i] = __fmaf_rn(dsj, kj[i], acc[r][i]);
      }
    }
  }

  float* dq = static_cast<float*>(a.dq) + q_off;
#pragma unroll
  for (int r = 0; r < kRowsQ; ++r) {
    const int row = q_lo + warp * kRowsQ + r;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      const int d = lane + 32 * i;
      if ((HD % 32 == 0 || d < HD) && row < a.s)
        dq[static_cast<size_t>(row) * HD + d] = acc[r][i];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const Args a) {
  constexpr int kDPL = (HD + 31) / 32;        // dk/dv columns per lane
  constexpr int kLd = HD + 1;
  extern __shared__ float smem[];
  float* k_s = smem;                          // [kBKV][HD]
  float* v_s = k_s + kBKV * HD;               // [kBKV][HD]
  float* q_s = v_s + kBKV * HD;               // [kQT][kLd]
  float* do_s = q_s + kQT * kLd;              // [kQT][kLd]
  float* lse_s = do_s + kQT * kLd;            // [kQT]
  float* dvec_s = lse_s + kQT;                // [kQT]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bkv = blockIdx.y;
  const int b = bkv / a.kv, kvh = bkv % a.kv, groups = a.h / a.kv;
  const int k_lo = blockIdx.x * kBKV;
  const size_t k_off = static_cast<size_t>(bkv) * a.s * HD;
  const float* k = static_cast<const float*>(a.k) + k_off;
  const float* v = static_cast<const float*>(a.v) + k_off;

  for (int i = tid; i < kBKV * HD; i += kThreads) {
    const int row = k_lo + i / HD;
    const size_t off = static_cast<size_t>(row) * HD + i % HD;
    k_s[i] = row < a.s ? k[off] : 0.f;
    v_s[i] = row < a.s ? v[off] : 0.f;
  }
  float dk[kKeysW][kDPL], dv[kKeysW][kDPL];
#pragma unroll
  for (int jj = 0; jj < kKeysW; ++jj)
#pragma unroll
    for (int i = 0; i < kDPL; ++i) dk[jj][i] = dv[jj][i] = 0.f;

  // the query tiles that can see this block's keys: from the tile holding
  // row k_lo when causal, up to row k_lo + kBKV - 1 + window when windowed
  const int q_begin = a.causal ? k_lo / kQT * kQT : 0;
  const int q_end = a.window >= 0 ? min(a.s, k_lo + kBKV + a.window) : a.s;

  for (int g = 0; g < groups; ++g) {
    const int bh = b * a.h + kvh * groups + g;
    const size_t q_off = static_cast<size_t>(bh) * a.s * HD;
    const float* q = static_cast<const float*>(a.q) + q_off;
    const float* dout = static_cast<const float*>(a.dout) + q_off;
    for (int q_lo = q_begin; q_lo < q_end; q_lo += kQT) {
      __syncthreads();                        // the last tile's reads are done
      for (int i = tid; i < kQT * HD; i += kThreads) {
        const int r = i / HD, d = i % HD, row = q_lo + r;
        const size_t off = static_cast<size_t>(row) * HD + d;
        q_s[r * kLd + d] = row < a.s ? q[off] : 0.f;
        do_s[r * kLd + d] = row < a.s ? dout[off] : 0.f;
      }
      if (tid < kQT) {
        const int row = q_lo + tid;
        const size_t at = static_cast<size_t>(bh) * a.s + row;
        lse_s[tid] = row < a.s ? a.lse[at] : 0.f;
        dvec_s[tid] = row < a.s ? a.dvec[at] : 0.f;
      }
      __syncthreads();

      // s and dp of this lane's query row against the warp's keys
      const int row = q_lo + lane;
      float s[kKeysW], dp[kKeysW], p[kKeysW], ds[kKeysW];
#pragma unroll
      for (int jj = 0; jj < kKeysW; ++jj) s[jj] = dp[jj] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        const float qd = q_s[lane * kLd + d], dd = do_s[lane * kLd + d];
#pragma unroll
        for (int jj = 0; jj < kKeysW; ++jj) {
          s[jj] = __fmaf_rn(qd, k_s[(warp * kKeysW + jj) * HD + d], s[jj]);
          dp[jj] = __fmaf_rn(dd, v_s[(warp * kKeysW + jj) * HD + d], dp[jj]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < kKeysW; ++jj)
        p_ds(a, visible(a, k_lo + warp * kKeysW + jj, row), s[jj], dp[jj],
             lse_s[lane], dvec_s[lane], p[jj], ds[jj]);

      // dv += p^T . dO and dk += ds^T . Q, row i's values broadcast from
      // lane i, rows in order
#pragma unroll 2
      for (int i = 0; i < kQT; ++i) {
        float doi[kDPL], qi[kDPL];
#pragma unroll
        for (int c = 0; c < kDPL; ++c) {
          const int d = lane + 32 * c;
          const bool in = HD % 32 == 0 || d < HD;
          doi[c] = in ? do_s[i * kLd + d] : 0.f;
          qi[c] = in ? q_s[i * kLd + d] : 0.f;
        }
#pragma unroll
        for (int jj = 0; jj < kKeysW; ++jj) {
          const float pij = __shfl_sync(kFull, p[jj], i);
          const float dsij = __shfl_sync(kFull, ds[jj], i);
#pragma unroll
          for (int c = 0; c < kDPL; ++c) {
            dv[jj][c] = __fmaf_rn(pij, doi[c], dv[jj][c]);
            dk[jj][c] = __fmaf_rn(dsij, qi[c], dk[jj][c]);
          }
        }
      }
    }
  }

  float* dk_out = static_cast<float*>(a.dk) + k_off;
  float* dv_out = static_cast<float*>(a.dv) + k_off;
#pragma unroll
  for (int jj = 0; jj < kKeysW; ++jj) {
    const int key = k_lo + warp * kKeysW + jj;
#pragma unroll
    for (int c = 0; c < kDPL; ++c) {
      const int d = lane + 32 * c;
      if ((HD % 32 == 0 || d < HD) && key < a.s) {
        const size_t off = static_cast<size_t>(key) * HD + d;
        dk_out[off] = dk[jj][c];
        dv_out[off] = dv[jj][c];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

template <int HD>
constexpr size_t dq_mma_smem_bytes() {
  return sizeof(bf16) * (2 * kMmaBQ + 4 * kMmaBK) * (HD + kPad);
}

template <int HD>
constexpr size_t dkv_mma_smem_bytes() {
  return sizeof(bf16) * (2 * kMmaBKV + 4 * mma_qt<HD>()) * (HD + kPad) +
         sizeof(float) * 4 * mma_qt<HD>();
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes global -> shared, zeros where !ok (src is then any valid
// address and is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
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

// entries [row0, row0 + ROWS) of an f32 vector of length s, zeros past s
template <int ROWS>
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int row0, int s) {
  for (int i = threadIdx.x; i < ROWS; i += kThreads) {
    const bool ok = row0 + i < s;
    cp_async4(dst + i, src + (ok ? row0 + i : 0), ok);
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

// rows r and r + 8 (the lane's rows of a 16-row accumulator tile) of an
// (s, HD) bf16 matrix from the f32 tile c; rows past s are not stored
template <int HD>
__device__ __forceinline__ void store_rows(bf16* out,
                                           const float (&c)[HD / 8][4], int r,
                                           int col, int s) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (r + 8 * i >= s) continue;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(
          out + static_cast<size_t>(r + 8 * i) * HD + n * 8 + col) =
          __floats2bfloat162_rn(c[n][2 * i], c[n][2 * i + 1]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_mma_kernel(const Args a) {
  constexpr int kLd = HD + kPad;
  constexpr int kNT = kMmaBK / 8;             // n-tiles of S and dP
  constexpr int kDT = HD / 8;                 // n-tiles of dq
  extern __shared__ __align__(16) unsigned char dq_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(dq_smem);  // [kMmaBQ][kLd]
  bf16* do_s = q_s + kMmaBQ * kLd;            // [kMmaBQ][kLd]
  bf16* k_s = do_s + kMmaBQ * kLd;            // [2][kMmaBK][kLd]
  bf16* v_s = k_s + 2 * kMmaBK * kLd;         // [2][kMmaBK][kLd]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.x;
  const int b = bh / a.h, h = bh % a.h;
  const int kvh = b * a.kv + h / (a.h / a.kv);
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * kMmaBQ;
  const size_t q_off = static_cast<size_t>(bh) * a.s * HD;
  const size_t k_off = static_cast<size_t>(kvh) * a.s * HD;
  const bf16* k = static_cast<const bf16*>(a.k) + k_off;
  const bf16* v = static_cast<const bf16*>(a.v) + k_off;

  // the forward's tile range: up to the diagonal when causal, from the tile
  // holding key q_lo - window when windowed; never empty
  const int k_end = a.causal ? min(a.s, q_lo + kMmaBQ) : a.s;
  const int k_begin =
      a.window >= 0 ? max(0, q_lo - a.window) / kMmaBK * kMmaBK : 0;
  const int n_tiles = (k_end - k_begin + kMmaBK - 1) / kMmaBK;

  load_rows<kMmaBQ, HD>(q_s, static_cast<const bf16*>(a.q) + q_off, q_lo,
                        a.s);
  load_rows<kMmaBQ, HD>(do_s, static_cast<const bf16*>(a.dout) + q_off, q_lo,
                        a.s);
  load_rows<kMmaBK, HD>(k_s, k, k_begin, a.s);
  load_rows<kMmaBK, HD>(v_s, v, k_begin, a.s);
  cp_commit();

  // the lane's rows of the accumulator tiles: r0 and r0 + 8; its columns of
  // each n-tile: col and col + 1
  const int r0 = q_lo + warp * 16 + (lane >> 2), col = (lane & 3) * 2;
  float lse[2], dvec[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    const size_t at = static_cast<size_t>(bh) * a.s + row;
    lse[i] = row < a.s ? a.lse[at] : 0.f;
    dvec[i] = row < a.s ? a.dvec[at] : 0.f;
  }
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

    // S = Q K^T and dP = dO V^T, the warp's 16 rows by the tile's keys
    float s[kNT][4] = {}, dp[kNT][4] = {};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[4], da[4];
      ldsm(qa, a_tile<kLd>(q_s, warp * 16, kk * 16, lane));
      ldsm(da, a_tile<kLd>(do_s, warp * 16, kk * 16, lane));
#pragma unroll
      for (int n = 0; n < kNT; n += 2) {
        uint32_t kb[4], vb[4];
        ldsm(kb, b_tile<kLd>(kt, n * 8, kk * 16, lane));
        ldsm(vb, b_tile<kLd>(vt, n * 8, kk * 16, lane));
        mma(s[n], qa, kb[0], kb[1]);
        mma(s[n + 1], qa, kb[2], kb[3]);
        mma(dp[n], da, vb[0], vb[1]);
        mma(dp[n + 1], da, vb[2], vb[3]);
      }
    }
    // p, then ds in place of dp
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p;
        p_ds(a, visible(a, k_lo + n * 8 + col + (e & 1), r0 + 8 * i),
             s[n][e], dp[n][e], lse[i], dvec[i], p, dp[n][e]);
      }
    // dq += dS K, dS as hi + lo, keys in order
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_a(dp, kk, hi, lo);
#pragma unroll
      for (int n = 0; n < kDT; n += 2) {
        uint32_t kb[4];
        ldsm_t(kb, a_tile<kLd>(kt, kk * 16, n * 8, lane));
        mma(acc[n], hi, kb[0], kb[1]);
        mma(acc[n], lo, kb[0], kb[1]);
        mma(acc[n + 1], hi, kb[2], kb[3]);
        mma(acc[n + 1], lo, kb[2], kb[3]);
      }
    }
    __syncthreads();                          // done reading this buffer
  }
  store_rows<HD>(static_cast<bf16*>(a.dq) + q_off, acc, r0, col, a.s);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_mma_kernel(const Args a) {
  constexpr int kLd = HD + kPad, kQTm = mma_qt<HD>();
  constexpr int kNT = kQTm / 8;               // n-tiles of S^T and dP^T
  constexpr int kDT = HD / 8;                 // n-tiles of dk and dv
  extern __shared__ __align__(16) unsigned char dkv_smem[];
  bf16* k_s = reinterpret_cast<bf16*>(dkv_smem);  // [kMmaBKV][kLd]
  bf16* v_s = k_s + kMmaBKV * kLd;            // [kMmaBKV][kLd]
  bf16* q_s = v_s + kMmaBKV * kLd;            // [2][kQTm][kLd]
  bf16* do_s = q_s + 2 * kQTm * kLd;          // [2][kQTm][kLd]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kQTm * kLd);  // [2][kQTm]
  float* dvec_s = lse_s + 2 * kQTm;           // [2][kQTm]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bkv = blockIdx.x;
  const int b = bkv / a.kv, kvh = bkv % a.kv, groups = a.h / a.kv;
  const int k_lo = blockIdx.y * kMmaBKV;
  const size_t k_off = static_cast<size_t>(bkv) * a.s * HD;
  // the block's f32 totals of dk and dv in the workspace, each thread's own
  // fragment: element (n, e) of dk at [(n * 4 + e) * 2][thread], of dv at
  // [(n * 4 + e) * 2 + 1][thread]
  float* tot = a.acc + (static_cast<size_t>(bkv) * gridDim.y + blockIdx.y) *
                           dkv_totals(HD);

  // the query tiles that can see this block's keys: from the tile holding
  // row k_lo when causal, up to row k_lo + kMmaBKV - 1 + window when
  // windowed; never empty.  Step it is query head it / n_q of the group
  // and its (it % n_q)-th tile.
  const int q_begin = a.causal ? k_lo / kQTm * kQTm : 0;
  const int q_end =
      a.window >= 0 ? min(a.s, k_lo + kMmaBKV + a.window) : a.s;
  const int n_q = (q_end - q_begin + kQTm - 1) / kQTm;
  const int n_it = groups * n_q;
  auto stage = [&](int it, int buf) {
    const int bh = b * a.h + kvh * groups + it / n_q;
    const int q_lo = q_begin + it % n_q * kQTm;
    const size_t q_off = static_cast<size_t>(bh) * a.s * HD;
    load_rows<kQTm, HD>(q_s + buf * kQTm * kLd,
                        static_cast<const bf16*>(a.q) + q_off, q_lo, a.s);
    load_rows<kQTm, HD>(do_s + buf * kQTm * kLd,
                        static_cast<const bf16*>(a.dout) + q_off, q_lo, a.s);
    load_vec<kQTm>(lse_s + buf * kQTm, a.lse + static_cast<size_t>(bh) * a.s,
                   q_lo, a.s);
    load_vec<kQTm>(dvec_s + buf * kQTm,
                   a.dvec + static_cast<size_t>(bh) * a.s, q_lo, a.s);
  };

  load_rows<kMmaBKV, HD>(k_s, static_cast<const bf16*>(a.k) + k_off, k_lo,
                         a.s);
  load_rows<kMmaBKV, HD>(v_s, static_cast<const bf16*>(a.v) + k_off, k_lo,
                         a.s);
  stage(0, 0);
  cp_commit();

  // the lane's keys (rows of the accumulator tiles): r0 and r0 + 8; its
  // query columns of each n-tile: col and col + 1
  const int r0 = k_lo + warp * 16 + (lane >> 2), col = (lane & 3) * 2;
  float dk[kDT][4] = {}, dv[kDT][4] = {};
  for (int j = 0; j < 2 * kDT * 4; ++j) tot[j * kThreads + threadIdx.x] = 0.f;
  // dk and dv added into the totals with round-to-nearest f32 adds and
  // zeroed; on the last tile the sums stay in dk and dv for the store
  auto flush = [&](bool last) {
#pragma unroll
    for (int n = 0; n < kDT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float* tk = tot + (n * 4 + e) * 2 * kThreads + threadIdx.x;
        float* tv = tk + kThreads;
        const float k_sum = __fadd_rn(*tk, dk[n][e]);
        const float v_sum = __fadd_rn(*tv, dv[n][e]);
        if (last) {
          dk[n][e] = k_sum;
          dv[n][e] = v_sum;
        } else {
          *tk = k_sum;
          *tv = v_sum;
          dk[n][e] = dv[n][e] = 0.f;
        }
      }
  };

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) {                      // the next tile's copy
      stage(it + 1, (it + 1) & 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();                          // this tile has landed
    const int buf = it & 1, q_lo = q_begin + it % n_q * kQTm;
    const bf16* qt = q_s + buf * kQTm * kLd;
    const bf16* dot = do_s + buf * kQTm * kLd;
    const float* lse_t = lse_s + buf * kQTm;
    const float* dvec_t = dvec_s + buf * kQTm;

    // S^T = K Q^T and dP^T = V dO^T, the warp's 16 keys by the tile's rows
    float s[kNT][4] = {}, dp[kNT][4] = {};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t ka[4], va[4];
      ldsm(ka, a_tile<kLd>(k_s, warp * 16, kk * 16, lane));
      ldsm(va, a_tile<kLd>(v_s, warp * 16, kk * 16, lane));
#pragma unroll
      for (int n = 0; n < kNT; n += 2) {
        uint32_t qb[4], db[4];
        ldsm(qb, b_tile<kLd>(qt, n * 8, kk * 16, lane));
        ldsm(db, b_tile<kLd>(dot, n * 8, kk * 16, lane));
        mma(s[n], ka, qb[0], qb[1]);
        mma(s[n + 1], ka, qb[2], qb[3]);
        mma(dp[n], va, db[0], db[1]);
        mma(dp[n + 1], va, db[2], db[3]);
      }
    }
    // p in place of s, ds in place of dp
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + col + (e & 1);
        p_ds(a, visible(a, r0 + 8 * (e >> 1), q_lo + c), s[n][e], dp[n][e],
             lse_t[c], dvec_t[c], s[n][e], dp[n][e]);
      }
    // dv += P^T dO and dk += dS^T Q, P and dS as hi + lo, rows in order
#pragma unroll
    for (int kk = 0; kk < kQTm / 16; ++kk) {
      uint32_t phi[4], plo[4], dhi[4], dlo[4];
      split_a(s, kk, phi, plo);
      split_a(dp, kk, dhi, dlo);
#pragma unroll
      for (int n = 0; n < kDT; n += 2) {
        uint32_t db[4], qb[4];
        ldsm_t(db, a_tile<kLd>(dot, kk * 16, n * 8, lane));
        ldsm_t(qb, a_tile<kLd>(qt, kk * 16, n * 8, lane));
        mma(dv[n], phi, db[0], db[1]);
        mma(dv[n], plo, db[0], db[1]);
        mma(dv[n + 1], phi, db[2], db[3]);
        mma(dv[n + 1], plo, db[2], db[3]);
        mma(dk[n], dhi, qb[0], qb[1]);
        mma(dk[n], dlo, qb[0], qb[1]);
        mma(dk[n + 1], dhi, qb[2], qb[3]);
        mma(dk[n + 1], dlo, qb[2], qb[3]);
      }
    }
    if (it + 1 == n_it)
      flush(true);
    else if ((it + 1) % kFlushTiles == 0)
      flush(false);
    __syncthreads();                          // done reading this buffer
  }
  store_rows<HD>(static_cast<bf16*>(a.dk) + k_off, dk, r0, col, a.s);
  store_rows<HD>(static_cast<bf16*>(a.dv) + k_off, dv, r0, col, a.s);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

int launch_one(void (*kernel)(Args), dim3 grid, size_t smem, const Args& a,
               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_hd(const Args& a, bool bf16_in, cudaStream_t stream) {
  int err;
  if (bf16_in) {
    const int n_q = (a.s + kMmaBQ - 1) / kMmaBQ;
    const int n_k = (a.s + kMmaBKV - 1) / kMmaBKV;
    err = launch_one(flash_bwd_dq_mma_kernel<HD>, dim3(a.b * a.h, n_q),
                     dq_mma_smem_bytes<HD>(), a, stream);
    if (err) return err;
    return launch_one(flash_bwd_dkv_mma_kernel<HD>, dim3(a.b * a.kv, n_k),
                      dkv_mma_smem_bytes<HD>(), a, stream);
  }
  err = launch_one(flash_bwd_dq_kernel<HD>,
                   dim3((a.s + kBQ - 1) / kBQ, a.b * a.h), dq_smem_bytes<HD>(),
                   a, stream);
  if (err) return err;
  return launch_one(flash_bwd_dkv_kernel<HD>,
                    dim3((a.s + kBKV - 1) / kBKV, a.b * a.kv),
                    dkv_smem_bytes<HD>(), a, stream);
}

int launch(const Args& a, int hd, bool bf16_in, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_hd<16>(a, bf16_in, stream);
    case 32: return launch_hd<32>(a, bf16_in, stream);
    case 64: return launch_hd<64>(a, bf16_in, stream);
    case 112: return launch_hd<112>(a, bf16_in, stream);
    case 128: return launch_hd<128>(a, bf16_in, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// the floats of the bf16 path's workspace (the launch entry's acc) at these
// sizes: the totals of every key block of every (batch, kv head)
long long flash_attention_bwd_workspace_floats(int b, int kv, int s, int hd) {
  return static_cast<long long>(b) * kv * ((s + kMmaBKV - 1) / kMmaBKV) *
         dkv_totals(hd);
}

int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* dvec, void* dq, void* dk, void* dv,
                               void* acc,
                               int b, int h, int kv, int s, int hd, int causal,
                               int window, int bf16, float scale,
                               void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.dvec = static_cast<const float*>(dvec);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.acc = static_cast<float*>(acc);
  if (bf16 && acc == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  a.b = b;
  a.h = h;
  a.kv = kv;
  a.s = s;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  return launch(a, hd, bf16 != 0, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
