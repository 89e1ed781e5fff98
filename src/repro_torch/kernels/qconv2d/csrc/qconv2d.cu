// Direct int8 NHWC convolution kernels for Hopper (sm_90a), plain C entry
// points bound from Python with ctypes (kernels/qconv2d/kernel.py).
//
// Replaces the three Pallas TPU kernels of src/repro/kernels/qconv2d/kernel.py:
//   qconv2d_acc           (kernel.py:128)  conv(x_p, w) - zp*colsum -> int32 acc
//   qconv2d_acc_checksum  (kernel.py:163)  the same acc plus the ABFT check
//                                          channel want = conv(x_p - zp, w_check)
//   qconv2d               (kernel.py:211)  the same acc plus the fused
//                                          requantisation epilogue -> int8
// x_p is the input already padded with the zero point (N, Hp, Wp, Cin) int8,
// w is (KH, KW, Cin, Cout) int8, outputs are NHWC.
//
// Bound on an H100 SXM: max(bytes / 3.35 TB/s, 2*MACs / 1,979 TOPS int8),
// each input read once and each output written once.  The two acc kernels
// write 4 bytes per output for KH*KW*Cin MACs, so every Table-1 layer is
// bound by the bytes they write.  The fused kernel writes 1 byte per output;
// at Cin = Cout = 96, 3x3 it is bound by compute.
//
// Design.  Blocks run in no order, so nothing carries over between them: the
// grid is (output-pixel tiles of N*OH*OW, Cout tiles of 32).  A block stages
// its 32-channel weight tile in shared memory once, packed four input
// channels to a word (Cin zero-padded to a multiple of 4 inside the kernel:
// the stem has Cin = 3), so that one __dp4a does four int8 MACs.  Each thread
// owns one output pixel and 8 channels; a warp's lanes take 32 neighbouring
// pixels and read the same weight words (a shared-memory broadcast).  The
// int32 accumulators live in registers and each output is written once; the
// fused epilogue requantises in registers, so int32 never reaches device
// memory on the default forward path.  dp4a runs on the CUDA cores, far below
// the tensor cores' int8 rate, so the compute-bound layers stay well above
// their bound: moving the inner product to int8 mma/wgmma tiles is later work.
//
// Integer arithmetic.  The zero-point correction and all checksum arithmetic
// run in uint32: the reference wraps mod 2^32, and signed overflow is
// undefined in C++.  The check channel is computed by the Cout-tile-0 blocks
// for their own pixel tile (the TPU emitted it once per image at c == 0,
// relying on sequential grid order), as sum (x_p - zp) * w_check, which equals
// conv(x_p, w_check) - zp * sum(w_check) mod 2^32.  The fused epilogue gives
// JAX's rounding bit for bit: int->float round-to-nearest, a multiply that is
// never contracted into an FMA (__fmul_rn), rintf (half to even), + out_zp,
// clamp to [-128, 127].
//
// Each C entry returns cudaGetLastError() after its launch (0 on success).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTilePix = 32;                  // output pixels per block
constexpr int kTileCout = 32;                 // output channels per block
constexpr int kGroups = 4;                    // warps per block
constexpr int kChanPerThread = kTileCout / kGroups;
constexpr int kThreads = kTilePix * kGroups;
constexpr size_t kDefaultSmem = 48 * 1024;

enum Mode { kAcc = 0, kAccChecksum = 1, kRequant = 2 };

struct Geometry {
  int n, hp, wp, cin, kh, kw, cout, oh, ow, sh, sw;
};

// Input channels 4*group .. 4*group+3 of one pixel packed little-endian into
// one word; channels at or past cin read as 0.
template <bool kAligned>
__device__ __forceinline__ int load_x4(const int8_t* row, int group, int cin) {
  if (kAligned) return __ldg(reinterpret_cast<const int*>(row) + group);
  uint32_t v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int c = 4 * group + b;
    if (c < cin) v |= static_cast<uint32_t>(static_cast<uint8_t>(row[c])) << (8 * b);
  }
  return static_cast<int>(v);
}

template <int kMode, bool kAligned>
__global__ void __launch_bounds__(kThreads)
qconv2d_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const int32_t* __restrict__ colsum,
               const int32_t* __restrict__ w_check,
               const int32_t* __restrict__ bias,
               const float* __restrict__ scale,
               const int32_t* __restrict__ zps,
               int32_t* __restrict__ acc_out, int32_t* __restrict__ want_out,
               int8_t* __restrict__ q_out, Geometry g) {
  extern __shared__ int smem[];
  const int cin4 = (g.cin + 3) / 4;
  const int taps = g.kh * g.kw;
  int* w_s = smem;                                // [taps][cin4][kTileCout]
  int* check_s = smem + taps * cin4 * kTileCout;  // [taps][cin]
  const int c0 = blockIdx.y * kTileCout;
  const bool check = kMode == kAccChecksum && blockIdx.y == 0;

  for (int e = threadIdx.x; e < taps * cin4 * kTileCout; e += kThreads) {
    const int c = e % kTileCout;
    const int group = (e / kTileCout) % cin4;
    const int tap = e / (kTileCout * cin4);
    uint32_t v = 0;
    if (c0 + c < g.cout) {
      for (int b = 0; b < 4; ++b) {
        const int ci = 4 * group + b;
        if (ci < g.cin) {
          const int8_t wv = w[(static_cast<size_t>(tap) * g.cin + ci) * g.cout + c0 + c];
          v |= static_cast<uint32_t>(static_cast<uint8_t>(wv)) << (8 * b);
        }
      }
    }
    w_s[e] = static_cast<int>(v);
  }
  if (check) {
    for (int e = threadIdx.x; e < taps * g.cin; e += kThreads) check_s[e] = w_check[e];
  }
  __syncthreads();

  const int lane = threadIdx.x % kTilePix;
  const int grp = threadIdx.x / kTilePix;
  const long long plane = static_cast<long long>(g.oh) * g.ow;
  const long long pix = static_cast<long long>(blockIdx.x) * kTilePix + lane;
  if (pix >= g.n * plane) return;
  const int img = static_cast<int>(pix / plane);
  const int rem = static_cast<int>(pix % plane);
  const int oy = rem / g.ow;
  const int ox = rem % g.ow;
  const int zp = zps[0];
  const bool do_check = check && grp == 0;

  int acc[kChanPerThread];
#pragma unroll
  for (int k = 0; k < kChanPerThread; ++k) acc[k] = 0;
  uint32_t want = 0;

  for (int i = 0; i < g.kh; ++i) {
    for (int j = 0; j < g.kw; ++j) {
      const int8_t* row = x + ((static_cast<size_t>(img) * g.hp + oy * g.sh + i) * g.wp
                               + ox * g.sw + j) * g.cin;
      const int* w_tap = w_s + (i * g.kw + j) * cin4 * kTileCout + grp * kChanPerThread;
      for (int group = 0; group < cin4; ++group) {
        const int xv = load_x4<kAligned>(row, group, g.cin);
        const int* w_grp = w_tap + group * kTileCout;
#pragma unroll
        for (int k = 0; k < kChanPerThread; ++k) acc[k] = __dp4a(xv, w_grp[k], acc[k]);
      }
      if (do_check) {
        const int* c_tap = check_s + (i * g.kw + j) * g.cin;
        for (int ci = 0; ci < g.cin; ++ci) {
          want += static_cast<uint32_t>(static_cast<int>(row[ci]) - zp)
                  * static_cast<uint32_t>(c_tap[ci]);
        }
      }
    }
  }

  const size_t out_base = static_cast<size_t>(pix) * g.cout;
  const uint32_t zp_u = static_cast<uint32_t>(zp);
#pragma unroll
  for (int k = 0; k < kChanPerThread; ++k) {
    const int c = c0 + grp * kChanPerThread + k;
    if (c >= g.cout) break;
    uint32_t a = static_cast<uint32_t>(acc[k]) - zp_u * static_cast<uint32_t>(colsum[c]);
    if (kMode == kRequant) {
      a += static_cast<uint32_t>(bias[c]);
      float y = __fmul_rn(__int2float_rn(static_cast<int>(a)), scale[c]);
      y = __fadd_rn(rintf(y), static_cast<float>(zps[1]));
      y = fminf(fmaxf(y, -128.0f), 127.0f);
      q_out[out_base + c] = static_cast<int8_t>(y);
    } else {
      acc_out[out_base + c] = static_cast<int>(a);
    }
  }
  if (kMode == kAccChecksum && do_check) want_out[pix] = static_cast<int>(want);
}

template <int kMode>
int launch(const void* x, const void* w, const void* colsum,
           const void* w_check, const void* bias, const void* scale,
           const void* zps, void* acc_out, void* want_out, void* q_out,
           Geometry g, void* stream) {
  const long long npix = static_cast<long long>(g.n) * g.oh * g.ow;
  if (npix == 0 || g.cout == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned>((npix + kTilePix - 1) / kTilePix),
                  static_cast<unsigned>((g.cout + kTileCout - 1) / kTileCout));
  const int cin4 = (g.cin + 3) / 4;
  size_t smem = sizeof(int) * g.kh * g.kw * cin4 * kTileCout;
  if (kMode == kAccChecksum) smem += sizeof(int) * g.kh * g.kw * g.cin;
  const bool aligned = g.cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
  auto kernel = aligned ? &qconv2d_kernel<kMode, true> : &qconv2d_kernel<kMode, false>;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(colsum), static_cast<const int32_t*>(w_check),
      static_cast<const int32_t*>(bias), static_cast<const float*>(scale),
      static_cast<const int32_t*>(zps), static_cast<int32_t*>(acc_out),
      static_cast<int32_t*>(want_out), static_cast<int8_t*>(q_out), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int qconv2d_acc_launch(const void* x, const void* w, const void* colsum,
                       const void* zp, void* out, int n, int hp, int wp,
                       int cin, int kh, int kw, int cout, int oh, int ow,
                       int sh, int sw, void* stream) {
  const Geometry g{n, hp, wp, cin, kh, kw, cout, oh, ow, sh, sw};
  return launch<kAcc>(x, w, colsum, nullptr, nullptr, nullptr, zp, out,
                      nullptr, nullptr, g, stream);
}

int qconv2d_acc_checksum_launch(const void* x, const void* w,
                                const void* colsum, const void* w_check,
                                const void* zp, void* out, void* want, int n,
                                int hp, int wp, int cin, int kh, int kw,
                                int cout, int oh, int ow, int sh, int sw,
                                void* stream) {
  const Geometry g{n, hp, wp, cin, kh, kw, cout, oh, ow, sh, sw};
  return launch<kAccChecksum>(x, w, colsum, w_check, nullptr, nullptr, zp,
                              out, want, nullptr, g, stream);
}

int qconv2d_launch(const void* x, const void* w, const void* colsum,
                   const void* bias, const void* scale, const void* zps,
                   void* out, int n, int hp, int wp, int cin, int kh, int kw,
                   int cout, int oh, int ow, int sh, int sw, void* stream) {
  const Geometry g{n, hp, wp, cin, kh, kw, cout, oh, ow, sh, sw};
  return launch<kRequant>(x, w, colsum, nullptr, bias, scale, zps, nullptr,
                          nullptr, out, g, stream);
}

}  // extern "C"
