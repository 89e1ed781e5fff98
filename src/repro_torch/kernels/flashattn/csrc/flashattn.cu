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
// holding the uint32 value.  hd is 16, 32, 64 or 128.
//
// Bound on an H100 SXM: max(bytes / 3.35 TB/s, 4*B*H*hd*S(S+1)/2 causal
// FLOPs / 989 TFLOP/s for bf16 or 67 TFLOP/s for f32), each input read once
// and each output written once.  At the SmolLM-135M prefill shape (B 1, H 9,
// KV 3, hd 64, bf16) that is bytes up to S of about 800 and operations
// above: 0.06 us at S = 64, 1.2 us at S = 1024.  This first kernel does its
// products in f32 FMAs on the CUDA cores (67 TFLOP/s, 15x below the bf16
// tensor-core rate), so at S = 1024 it cannot beat about 18 us; mma/wgmma
// tiles with TMA loads are later work.
//
// Design.  Blocks run in no order on 132 SMs, so nothing carries over
// between them: a block owns 16 query rows of one (b, h) and runs the K
// loop inside itself, in place of the TPU kernel's sequential "arbitrary"
// grid axis, keeping m, l, acc (and c) in registers.  Each output row is
// reduced inside one warp in a fixed order (no split over blocks, no
// atomics), so two launches on the same inputs give the same bits, which
// DMR and TMR compare.  A tile is 32 keys, one per lane: the warp's 4 rows
// score their 32 keys with the K tile in shared memory (rows padded by one
// word so that lane j reading row j hits 32 banks), the row max and sum are
// butterfly shuffles (every lane ends with the same value: IEEE addition is
// commutative), and the PV product broadcasts p_j by shuffle while each
// lane accumulates its hd/32 columns from the V tile.  Grid (ceil(S/16),
// B*H): at S = 64 and H = 9 that is 36 blocks.  Tiles wholly above the
// diagonal or before the window are skipped, as the TPU kernel skips grid
// steps; K rows past S are zero and masked, V rows past S are zeroed (the
// reference's 0*NaN guard), Q rows past S are computed on zeros and not
// stored.  q-head h reads kv-head h / G in place (G = 3 for SmolLM-135M),
// no KV replication.
//
// Bit identity of out across the three entries.  ABFT recovery swaps
// flagged rows of the checked kernel's out for the plain kernel's, so the
// two must agree bit for bit.  One kernel template, instantiated per output
// set, holds the single copy of the tiling and the operation order; the
// extra outputs only add independent work.  The products are explicit
// __fmaf_rn, and the file is compiled with -fmad=false (kernel.py), so nvcc
// cannot contract a*b+c differently in one instantiation than in another.
// Scores are multiplied by the f32 scale 1/sqrt(hd) after the dot, as the
// reference; out = acc / max(l, 1e-30) is an IEEE divide, rounded to bf16
// with __float2bfloat16_rn; csum sums the very bits stored (bf16 as 16
// bits, zero-extended) in uint32.
//
// Each C entry returns cudaGetLastError() after its launch (0 on success).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 16;                       // query rows per block
constexpr int kBK = 32;                       // keys per tile, one per lane
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = kBQ / kWarps;           // query rows per warp
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ uint32_t bits_of(float x) {
  return __float_as_uint(x);
}
__device__ __forceinline__ uint32_t bits_of(__nv_bfloat16 x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(x));
}

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

template <typename T, int HD, int EMIT>
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
  const T* q = static_cast<const T*>(a.q) + static_cast<size_t>(bh) * a.s * HD;
  const T* k = static_cast<const T*>(a.k) + static_cast<size_t>(kvh) * a.s * HD;
  const T* v = static_cast<const T*>(a.v) + static_cast<size_t>(kvh) * a.s * HD;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, row = q_lo + r;
    q_s[r][d] = row < a.s ? to_f32(q[static_cast<size_t>(row) * HD + d]) : 0.f;
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
      k_s[r][d] = in ? to_f32(k[off]) : 0.f;
      v_s[r][d] = in ? to_f32(v[off]) : 0.f;
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
      const bool ok = key < a.s && (!a.causal || key <= qrow) &&
                      (a.window < 0 || key >= qrow - a.window);
      const float s = ok ? p[r] * a.scale : kNegInf;
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

  T* out = static_cast<T*>(a.out) + static_cast<size_t>(bh) * a.s * HD;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qrow = q_lo + warp * kRows + r;
    const float lc = fmaxf(l[r], 1e-30f);
    uint32_t bits = 0;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      const int d = lane + 32 * i;
      if (HD % 32 == 0 || d < HD) {
        const T o = from_f32<T>(acc[r][i] / lc);
        if (qrow < a.s) out[static_cast<size_t>(qrow) * HD + d] = o;
        bits += bits_of(o);
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

template <typename T, int EMIT>
int launch_hd(const Args& a, int hd, cudaStream_t stream) {
  const dim3 grid((a.s + kBQ - 1) / kBQ, a.b * a.h);
  switch (hd) {
    case 16: flash_fwd_kernel<T, 16, EMIT><<<grid, kThreads, 0, stream>>>(a); break;
    case 32: flash_fwd_kernel<T, 32, EMIT><<<grid, kThreads, 0, stream>>>(a); break;
    case 64: flash_fwd_kernel<T, 64, EMIT><<<grid, kThreads, 0, stream>>>(a); break;
    case 128: flash_fwd_kernel<T, 128, EMIT><<<grid, kThreads, 0, stream>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int EMIT>
int launch(Args a, int hd, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_hd<__nv_bfloat16, EMIT>(a, hd, st)
              : launch_hd<float, EMIT>(a, hd, st);
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
