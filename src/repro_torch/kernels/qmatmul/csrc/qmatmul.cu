// Int8 matmul kernels for Hopper (sm_90a), plain C entry points bound from
// Python with ctypes (kernels/qmatmul/kernel.py).
//
// Replaces the three Pallas TPU kernels of src/repro/kernels/qmatmul/kernel.py:
//   qmatmul_acc           (kernel.py:138)  X (M,K) int8 . W (K,N) int8
//                                          -> (M,N) int32 accumulator
//   qmatmul_acc_checksum  (kernel.py:176)  the same acc plus the ABFT check
//                                          vector want (M,) = X . w_check
//   qmatmul               (kernel.py:224)  the same acc plus the fused
//                                          requantisation epilogue -> int8
// X and W are row-major; out is (M, N) row-major.
//
// Bound on an H100 SXM: max(bytes / 3.35 TB/s, 2*M*N*K / 1,979 TOPS int8),
// each input read once and each output written once.  On the serving path
// (the W8A8 FFN: M = 8 decode rows or 64 prefill rows, (K, N) = (576, 1536)
// or (1536, 576)) the K*N = 884,736 weight bytes dominate: every call is
// bound by bytes, 0.27-0.39 us, and the arithmetic is 100x below the int8
// rate.  What matters is to read W once, in wide coalesced loads, from as
// many SMs as possible.
//
// Design.  Blocks run in no order, so nothing carries over between them:
// the grid is (N tiles of 64 columns, M tiles of 16 rows, K splits) and the
// K loop of a split runs inside the block, 128 rows of W per stage, so W is
// read exactly once.  At M = 8 there are only 9-24 (N, M) tiles, too few to
// keep enough loads in flight, so the acc kernels split K over blocks until
// about two blocks per SM are resident and add their partial sums into the
// zeroed output with integer atomics (exact and order-independent mod 2^32;
// the fused kernel needs the whole sum in one block and never splits).  A
// stage issues all of its loads before using any: W as 32-bit words of four
// neighbouring columns (a warp reads 64 contiguous bytes of a row), then a
// 4x4 byte transpose with __byte_perm into k-packed words (four K steps of
// one column), so that one __dp4a does four int8 MACs.  X is staged in its
// natural K-packed layout.  Each thread owns 2 rows x 4 columns of int32
// accumulators in registers; the fused kernel requantises in registers, so
// int32 never reaches device memory.  K tails, ragged M and N, and K or N
// not a multiple of 4 are zero-filled in the stage (the TPU kernel's K-tail
// mask, kernel.py:66-73).  dp4a runs on the CUDA cores; int8 mma/wgmma tiles
// with TMA are later work.
//
// Integer arithmetic.  The reference wraps mod 2^32 and signed overflow is
// undefined in C++, so the zero-point correction and the check vector run
// in uint32.  The check vector is computed by the N-tile-0 blocks of each K
// split for their own rows (the TPU kernel accumulated it in n == 0 tiles,
// relying on sequential grid order): 8 threads per row, each over its share
// of the stage, summed with a width-8 shuffle and across splits with an
// atomic add (addition mod 2^32 is associative, so the order does not
// matter).  The fused epilogue gives
// JAX's rounding bit for bit: int->float round-to-nearest, a multiply that
// is never contracted into an FMA (__fmul_rn), rintf (half to even),
// + out_zp, clamp to [-128, 127].
//
// Each C entry returns cudaGetLastError() after its launch (0 on success).

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 16;                       // rows of X per block
constexpr int kBN = 64;                       // columns of W per block
constexpr int kBK = 128;                      // K per stage
constexpr int kK4 = kBK / 4;                  // k-packed words per stage
constexpr int kThreads = 128;
constexpr int kColThreads = kBN / 4;          // 16 threads across columns
constexpr int kCheckLanes = kThreads / kBM;   // 8 threads per check row
constexpr int kSMs = 132;                     // H100 SXM

enum Mode { kAcc = 0, kAccChecksum = 1, kRequant = 2 };

struct Shape {
  int m, k, n;
};

// Bytes b of the four words r0..r3 (rows k..k+3 of four neighbouring
// columns) regrouped into one word per column: out[c] = {r0.c, r1.c, r2.c,
// r3.c}, little-endian.
__device__ __forceinline__ void transpose4x4(int r0, int r1, int r2, int r3,
                                             int out[4]) {
  const int t0 = __byte_perm(r0, r1, 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const int t1 = __byte_perm(r2, r3, 0x5140);  // r2.b0 r3.b0 r2.b1 r3.b1
  const int t2 = __byte_perm(r0, r1, 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const int t3 = __byte_perm(r2, r3, 0x7362);  // r2.b2 r3.b2 r2.b3 r3.b3
  out[0] = __byte_perm(t0, t1, 0x5410);
  out[1] = __byte_perm(t0, t1, 0x7632);
  out[2] = __byte_perm(t2, t3, 0x5410);
  out[3] = __byte_perm(t2, t3, 0x7632);
}

__device__ __forceinline__ uint32_t byte_at(const int8_t* p, size_t i) {
  return static_cast<uint32_t>(static_cast<uint8_t>(p[i]));
}

// One stage's loads, issued together before any of them is used: 4 words
// of X and 4 x 4 words of W per thread, zero-filled outside [0, M) x
// [k0, k_end) x [0, N).
struct Stage {
  int x[4];
  int w[4][4];
};

__device__ __forceinline__ void load_stage(Stage& st, const int8_t* __restrict__ x,
                                           const int8_t* __restrict__ w,
                                           const Shape& s, int m0, int n0, int k0,
                                           int k_end, bool x_words, bool w_words) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // X: kBM rows x kK4 words, as X lies in memory
    const int e = tid + i * kThreads;
    const int m = m0 + e / kK4;
    const int k = k0 + 4 * (e % kK4);
    uint32_t v = 0;
    if (m < s.m && k < k_end) {
      const size_t base = static_cast<size_t>(m) * s.k + k;
      if (x_words && k + 4 <= k_end) {
        v = static_cast<uint32_t>(__ldg(reinterpret_cast<const int*>(x + base)));
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if (k + b < k_end) v |= byte_at(x, base + b) << (8 * b);
        }
      }
    }
    st.x[i] = static_cast<int>(v);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // W: 4 K rows x 4 neighbouring columns
    const int e = tid + i * kThreads;
    const int n = n0 + 4 * (e % kColThreads);
    const int k = k0 + 4 * (e / kColThreads);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t v = 0;
      if (n < s.n && k + j < k_end) {
        const size_t base = static_cast<size_t>(k + j) * s.n + n;
        if (w_words) {
          v = static_cast<uint32_t>(__ldg(reinterpret_cast<const int*>(w + base)));
        } else {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            if (n + b < s.n) v |= byte_at(w, base + b) << (8 * b);
          }
        }
      }
      st.w[i][j] = static_cast<int>(v);
    }
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
qmatmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const int32_t* __restrict__ w_check,
               const int32_t* __restrict__ colsum,
               const int32_t* __restrict__ bias,
               const float* __restrict__ scale,
               const int32_t* __restrict__ zps,
               int32_t* __restrict__ acc_out, int32_t* __restrict__ want_out,
               int8_t* __restrict__ q_out, Shape s, int k_split, bool x_words,
               bool w_words) {
  __shared__ int x_s[kBM][kK4 + 1];
  __shared__ __align__(16) int w_s[kK4][kBN];
  __shared__ int wc_s[kBK];

  const int tid = threadIdx.x;
  const int tx = tid % kColThreads;
  const int ty = tid / kColThreads;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  // split K: block z sums K rows [k_begin, k_end) and adds into the output
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(s.k, k_begin + k_split);
  const bool split = gridDim.z > 1;
  const bool check = kMode == kAccChecksum && blockIdx.x == 0;
  const int check_row = tid / kCheckLanes;
  const int check_part = tid % kCheckLanes;

  int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
  uint32_t want = 0;
  Stage st;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    load_stage(st, x, w, s, m0, n0, k0, k_end, x_words, w_words);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * kThreads;
      x_s[e / kK4][e % kK4] = st.x[i];
      const int q = e % kColThreads;
      const int k4 = e / kColThreads;
      int cols[4];
      transpose4x4(st.w[i][0], st.w[i][1], st.w[i][2], st.w[i][3], cols);
#pragma unroll
      for (int c = 0; c < 4; ++c) w_s[k4][4 * q + c] = cols[c];
    }
    if (check) {
      for (int e = tid; e < kBK; e += kThreads) {
        wc_s[e] = k0 + e < k_end ? w_check[k0 + e] : 0;
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int k4 = 0; k4 < kK4; ++k4) {
      const int4 wv = *reinterpret_cast<const int4*>(&w_s[k4][4 * tx]);
      const int xa = x_s[2 * ty][k4];
      const int xb = x_s[2 * ty + 1][k4];
      acc[0][0] = __dp4a(xa, wv.x, acc[0][0]);
      acc[0][1] = __dp4a(xa, wv.y, acc[0][1]);
      acc[0][2] = __dp4a(xa, wv.z, acc[0][2]);
      acc[0][3] = __dp4a(xa, wv.w, acc[0][3]);
      acc[1][0] = __dp4a(xb, wv.x, acc[1][0]);
      acc[1][1] = __dp4a(xb, wv.y, acc[1][1]);
      acc[1][2] = __dp4a(xb, wv.z, acc[1][2]);
      acc[1][3] = __dp4a(xb, wv.w, acc[1][3]);
    }
    if (check) {
      constexpr int kPer = kBK / kCheckLanes;
      for (int kk = check_part * kPer; kk < (check_part + 1) * kPer; ++kk) {
        const int xv = static_cast<int8_t>(
            static_cast<uint32_t>(x_s[check_row][kk / 4]) >> (8 * (kk % 4)));
        want += static_cast<uint32_t>(xv) * static_cast<uint32_t>(wc_s[kk]);
      }
    }
    __syncthreads();
  }

  if (check) {
    // the 8 lanes of one row are neighbours in one warp
    for (int off = kCheckLanes / 2; off > 0; off /= 2) {
      want += __shfl_down_sync(0xffffffffu, want, off, kCheckLanes);
    }
    const int m = m0 + check_row;
    if (check_part == 0 && m < s.m) {
      if (split) {
        atomicAdd(reinterpret_cast<unsigned int*>(want_out + m), want);
      } else {
        want_out[m] = static_cast<int>(want);
      }
    }
  }

  uint32_t x_zp = 0;
  float out_zp = 0.0f;
  if (kMode == kRequant) {
    x_zp = static_cast<uint32_t>(zps[0]);
    out_zp = static_cast<float>(zps[1]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + 2 * ty + i;
    if (m >= s.m) continue;
    const size_t row = static_cast<size_t>(m) * s.n;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (n >= s.n) continue;
      if (kMode == kRequant) {
        const uint32_t a = static_cast<uint32_t>(acc[i][j])
                           - x_zp * static_cast<uint32_t>(colsum[n])
                           + static_cast<uint32_t>(bias[n]);
        float y = __fmul_rn(__int2float_rn(static_cast<int>(a)), scale[n]);
        y = __fadd_rn(rintf(y), out_zp);
        y = fminf(fmaxf(y, -128.0f), 127.0f);
        q_out[row + n] = static_cast<int8_t>(y);
      } else if (split) {
        atomicAdd(reinterpret_cast<unsigned int*>(acc_out + row + n),
                  static_cast<unsigned int>(acc[i][j]));
      } else {
        acc_out[row + n] = acc[i][j];
      }
    }
  }
}

template <int kMode>
int launch(const void* x, const void* w, const void* w_check,
           const void* colsum, const void* bias, const void* scale,
           const void* zps, void* acc_out, void* want_out, void* q_out,
           Shape s, void* stream) {
  if (s.m == 0 || s.n == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (s.n + kBN - 1) / kBN;
  const int m_tiles = (s.m + kBM - 1) / kBM;
  // Split K over blocks until about two blocks per SM are in flight; each
  // split is whole stages.  The requantising kernel needs the full sum in
  // one block, so it never splits.
  const int stages = std::max(1, (s.k + kBK - 1) / kBK);
  int splits = 1;
  if (kMode != kRequant) {
    const int tiles = n_tiles * m_tiles;
    splits = std::min(stages, std::max(1, (2 * kSMs + tiles - 1) / tiles));
  }
  const int k_split = ((stages + splits - 1) / splits) * kBK;
  splits = std::max(1, (s.k + k_split - 1) / k_split);
  if (splits > 1) {  // the blocks add into zeroed outputs
    cudaError_t err = cudaMemsetAsync(acc_out, 0, sizeof(int32_t) * s.m * s.n, st);
    if (err == cudaSuccess && kMode == kAccChecksum) {
      err = cudaMemsetAsync(want_out, 0, sizeof(int32_t) * s.m, st);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(m_tiles),
                  static_cast<unsigned>(splits));
  // 32-bit loads need 4-byte aligned rows
  const bool x_words = s.k % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
  const bool w_words = s.n % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  qmatmul_kernel<kMode><<<grid, kThreads, 0, st>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(w_check), static_cast<const int32_t*>(colsum),
      static_cast<const int32_t*>(bias), static_cast<const float*>(scale),
      static_cast<const int32_t*>(zps), static_cast<int32_t*>(acc_out),
      static_cast<int32_t*>(want_out), static_cast<int8_t*>(q_out), s, k_split,
      x_words, w_words);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int qmatmul_acc_launch(const void* x, const void* w, void* out, int m, int k,
                       int n, void* stream) {
  return launch<kAcc>(x, w, nullptr, nullptr, nullptr, nullptr, nullptr, out,
                      nullptr, nullptr, Shape{m, k, n}, stream);
}

int qmatmul_acc_checksum_launch(const void* x, const void* w,
                                const void* w_check, void* out, void* want,
                                int m, int k, int n, void* stream) {
  return launch<kAccChecksum>(x, w, w_check, nullptr, nullptr, nullptr,
                              nullptr, out, want, nullptr, Shape{m, k, n},
                              stream);
}

int qmatmul_launch(const void* x, const void* w, const void* colsum,
                   const void* bias, const void* scale, const void* zps,
                   void* out, int m, int k, int n, void* stream) {
  return launch<kRequant>(x, w, nullptr, colsum, bias, scale, zps, nullptr,
                          nullptr, out, Shape{m, k, n}, stream);
}

}  // extern "C"
