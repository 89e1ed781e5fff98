// Flash-attention backward kernels for Hopper (sm_90a), one plain C entry
// point bound from Python with ctypes (kernels/flashattn/kernel.py).
//
// Replaces the backward Pallas TPU kernel of
// src/repro/kernels/flashattn/kernel.py:
//   flash_attention_bwd  (kernel.py:571)  (dq, dk, dv) from q, k, v, out,
//                                          lse, dO; its two pallas_calls
//                                          become the two kernels below:
//     _flash_bwd_dq_kernel   (kernel.py:419)  -> flash_bwd_dq_kernel
//     _flash_bwd_dkv_kernel  (kernel.py:466)  -> flash_bwd_dkv_kernel
// q, out, dO and dq are (B, H, S, hd), k, v, dk and dv (B, KV, S, hd), all
// row-major, f32 or bf16 (the gradients have the inputs' type); lse and
// dvec = rowsum(dO * out) are (B, H, S) f32.  dvec is a tensor op in the
// wrapper, as in the reference (kernel.py:583).  hd is 16, 32, 64 or 128.
//
// Bound on an H100 SXM: max(bytes / 3.35 TB/s, 10*B*H*hd*S(S+1)/2 causal
// FLOPs / 989 TFLOP/s bf16 or 67 TFLOP/s f32): five products per visible
// score (S = QK^T, dP = dO V^T, dV = P^T dO, dK = dS^T Q, dQ = dS K), each
// input read once and each output written once.  That is the function's own
// work, not this design's, which computes S and dP in both kernels.  At
// (1, 9, 1024, 64)/(1, 3, 1024, 64) bf16: 3.1 us, operations; at the
// training shape (8, 9, 1024, 64): 24.5 us, operations (51 MB of traffic
// would take 15 us).  These first kernels do their products in f32 FMAs on
// the CUDA cores (67 TFLOP/s, 15x below the bf16 tensor-core rate) with
// seven products per score, so they cannot beat ~0.25 ms at the training
// shape; mma/wgmma tiles with TMA loads are later work.
//
// Design.  Blocks run in no order on 132 SMs and nothing carries over
// between them, so each gradient row is owned by exactly one block that
// loops over everything it sums, in a fixed order: no split reductions and
// no float atomics.  Two launches on the same inputs give the same bits,
// which the fault-tolerant trainer's bit-identical replay relies on.
//
//   dQ: a block owns 16 query rows of one (b, h) (4 per warp) and loops
//   over the 32-key tiles of the causal band or window (the forward's
//   range).  Lane j scores key j of the tile against the warp's rows
//   (s = q.k, dp = dO.v from shared memory, K and V rows padded by one word
//   so that lane j reading row j hits 32 banks), rebuilds p = exp(s*scale -
//   lse) (the reference's _recompute_p), forms ds = p (dp - dvec) scale,
//   and the dQ product broadcasts ds_j by shuffle while each lane
//   accumulates its hd/32 columns of dq from the K tile.  Grid (ceil(S/16),
//   B*H).
//
//   dK/dV: a block owns 32 keys of one (b, kv-head) (8 per warp) and loops
//   inside itself over the G query heads of the group and, for each, the
//   32-row query tiles that can see its keys, accumulating dk and dv in
//   registers: the reference's sequential G*nq scan, which also sums the
//   GQA group without atomics.  Lane i scores query row i of the tile
//   against the warp's 8 keys (Q and dO rows padded in shared memory, K and
//   V rows read by broadcast), and the dV and dK products broadcast p_ij and
//   ds_ij by shuffle while each lane accumulates its hd/32 columns.  Grid
//   (ceil(S/32), B*KV).
//
// Ragged and masked entries.  Rows of q, dO and keys past S load as zeros;
// p and ds are selected to exact zeros wherever the key is not visible from
// the row or either lies past S (the reference's 0*NaN guards at
// kernel.py:453-455 and :505-508 become these selects), so no out-of-range
// lse or dvec is read; rows past S are not stored.
//
// FMA policy.  The products are explicit __fmaf_rn and the file is built
// with -fmad=false (kernel.py), as the forward: nvcc contracts nothing
// behind the source's back, so the arithmetic is the order written here.
// Each kernel needs more than 48 KB of shared memory at hd = 128, so both
// take it dynamically, after cudaFuncSetAttribute.
//
// The C entry launches both kernels on the given stream and returns the
// first CUDA error (0 on success).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16;                        // dQ: query rows per block
constexpr int kRowsQ = kBQ / kWarps;           // dQ: query rows per warp
constexpr int kBK = 32;                        // dQ: keys per tile, one per lane
constexpr int kKeysW = 8;                      // dKV: keys per warp
constexpr int kBKV = kWarps * kKeysW;          // dKV: keys per block
constexpr int kQT = 32;                        // dKV: query rows per tile
constexpr unsigned kFull = 0xffffffffu;

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
  int b, h, kv, s;
  int causal;
  int window;          // < 0: no window
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

template <int HD>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * kBQ * HD + 2 * kBK * (HD + 1));
}

template <int HD>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * kBKV * HD + 2 * kQT * (HD + 1) + 2 * kQT);
}

template <typename T, int HD>
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
  const T* q = static_cast<const T*>(a.q) + q_off;
  const T* dout = static_cast<const T*>(a.dout) + q_off;
  const T* k = static_cast<const T*>(a.k) + k_off;
  const T* v = static_cast<const T*>(a.v) + k_off;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int row = q_lo + i / HD;
    const size_t off = static_cast<size_t>(row) * HD + i % HD;
    q_s[i] = row < a.s ? to_f32(q[off]) : 0.f;
    do_s[i] = row < a.s ? to_f32(dout[off]) : 0.f;
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
      k_s[r * kLd + d] = row < a.s ? to_f32(k[off]) : 0.f;
      v_s[r * kLd + d] = row < a.s ? to_f32(v[off]) : 0.f;
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

  T* dq = static_cast<T*>(a.dq) + q_off;
#pragma unroll
  for (int r = 0; r < kRowsQ; ++r) {
    const int row = q_lo + warp * kRowsQ + r;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      const int d = lane + 32 * i;
      if ((HD % 32 == 0 || d < HD) && row < a.s)
        dq[static_cast<size_t>(row) * HD + d] = from_f32<T>(acc[r][i]);
    }
  }
}

template <typename T, int HD>
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
  const T* k = static_cast<const T*>(a.k) + k_off;
  const T* v = static_cast<const T*>(a.v) + k_off;

  for (int i = tid; i < kBKV * HD; i += kThreads) {
    const int row = k_lo + i / HD;
    const size_t off = static_cast<size_t>(row) * HD + i % HD;
    k_s[i] = row < a.s ? to_f32(k[off]) : 0.f;
    v_s[i] = row < a.s ? to_f32(v[off]) : 0.f;
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
    const T* q = static_cast<const T*>(a.q) + q_off;
    const T* dout = static_cast<const T*>(a.dout) + q_off;
    for (int q_lo = q_begin; q_lo < q_end; q_lo += kQT) {
      __syncthreads();                        // the last tile's reads are done
      for (int i = tid; i < kQT * HD; i += kThreads) {
        const int r = i / HD, d = i % HD, row = q_lo + r;
        const size_t off = static_cast<size_t>(row) * HD + d;
        q_s[r * kLd + d] = row < a.s ? to_f32(q[off]) : 0.f;
        do_s[r * kLd + d] = row < a.s ? to_f32(dout[off]) : 0.f;
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

  T* dk_out = static_cast<T*>(a.dk) + k_off;
  T* dv_out = static_cast<T*>(a.dv) + k_off;
#pragma unroll
  for (int jj = 0; jj < kKeysW; ++jj) {
    const int key = k_lo + warp * kKeysW + jj;
#pragma unroll
    for (int c = 0; c < kDPL; ++c) {
      const int d = lane + 32 * c;
      if ((HD % 32 == 0 || d < HD) && key < a.s) {
        const size_t off = static_cast<size_t>(key) * HD + d;
        dk_out[off] = from_f32<T>(dk[jj][c]);
        dv_out[off] = from_f32<T>(dv[jj][c]);
      }
    }
  }
}

template <typename T, int HD>
int launch_hd(const Args& a, cudaStream_t stream) {
  constexpr size_t dq_bytes = dq_smem_bytes<HD>();
  constexpr size_t dkv_bytes = dkv_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dq_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dkv_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 dq_grid((a.s + kBQ - 1) / kBQ, a.b * a.h);
  flash_bwd_dq_kernel<T, HD><<<dq_grid, kThreads, dq_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 dkv_grid((a.s + kBKV - 1) / kBKV, a.b * a.kv);
  flash_bwd_dkv_kernel<T, HD><<<dkv_grid, kThreads, dkv_bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Args& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_hd<T, 16>(a, stream);
    case 32: return launch_hd<T, 32>(a, stream);
    case 64: return launch_hd<T, 64>(a, stream);
    case 128: return launch_hd<T, 128>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* dvec, void* dq, void* dk, void* dv,
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
  a.b = b;
  a.h = h;
  a.kv = kv;
  a.s = s;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(a, hd, st) : launch<float>(a, hd, st);
}

}  // extern "C"
