// Int8 NHWC convolution kernels for Hopper (sm_90a), plain C entry points
// bound from Python with ctypes (kernels/qconv2d/kernel.py).
//
// Replaces the three Pallas TPU kernels of src/repro/kernels/qconv2d/kernel.py,
// all three on one template, qconv2d_mma_kernel<kMode>:
//   qconv2d_acc           (kernel.py:128)  conv(x_p, w) - zp*colsum -> int32 acc
//                                          qconv2d_mma_kernel<kAcc>
//   qconv2d_acc_checksum  (kernel.py:163)  the same acc plus the ABFT check
//                                          channel want = conv(x_p - zp, w_check)
//                                          qconv2d_mma_kernel<kAccChecksum>
//   qconv2d               (kernel.py:211)  the same acc plus the fused
//                                          requantisation epilogue -> int8
//                                          qconv2d_mma_kernel<kRequant>
// x_p is the input already padded with the zero point (N, Hp, Wp, Cin) int8,
// w is (KH, KW, Cin, Cout) int8, outputs are NHWC.  Integer results wrap mod
// 2^32 as the reference's do, bit for bit.
//
// Bound on an H100 SXM: max(bytes / 3.35 TB/s, 2*MACs / 1,979 TOPS int8),
// each input read once and each output written once.  The two accumulator
// kernels write 4 bytes per output for KH*KW*Cin MACs, so every layer of the
// ship detector is bound by the int32 it writes (0.23-14.45 MB a layer at
// batch 4), far below the tensor cores' rate; the fused kernel writes one
// byte per output, and is bound by bytes too.
//
// The template.
//
//   An implicit GEMM on the tensor cores: output pixels (the flattened
//   N*OH*OW) are the rows, Cout the columns, and K runs, for each ky, over
//   the kw * Cin bytes that lie together in x ((kx, ci) order), padded to a
//   multiple of 16 (the stem's 3x3x3: three runs of 9 bytes, one 64-byte
//   step).  The products run on mma.sync.aligned.m16n8k32.row.col.s32.s8.
//   s8.s32, pixels on the m = 16 side and Cout on n = 8: Cout 24, 48 and 96
//   are 3, 6 and 12 n tiles, and Cout 6 is one with two idle columns.  No
//   .satfinite: the reference wraps, and int32 sums mod 2^32 do not depend
//   on their order.  mma.sync rather than wgmma: these layers are bound by
//   bytes (conv_96's 797 M MACs take ~0.8 us at the int8 rate against 1.4 us
//   of bytes).
//
//   A warp owns 16 pixels by 24 channels (3 n tiles) and needs no barrier:
//   each lane loads its A words straight from x into registers (x is at
//   most a few MB, so it stays in the 50 MB L2, and the taps of neighbouring
//   pixels hit L1), so the im2col matrix exists in no memory at all.  K is
//   walked in 64-byte steps, two mma steps: lane (gq, t4) loads 16-byte run
//   4m + t4 of its pixels gq and gq + 8 (one 16-byte load where Cin and x
//   allow it; 8- or 4-byte loads; or, for Cin = 3, ragged Cin and x_p views
//   off a 4-byte boundary, words cut from the one or two aligned words that
//   hold them with __funnelshift_r; all in the same kernel), and mma step s
//   takes words 2s and 2s + 1 of each run as its two A words.  The mma's k
//   index thus maps lane t4's words to K bytes 16(4m + t4) + 8s .. + 7, and
//   B's words for the lane are the same, 16m + 4t4 + 2s and + 1 of each
//   channel row: one 16-byte shared-memory load serves both steps.  A table
//   in shared memory holds each run's offset in x and its real bytes, so the
//   walk does no division.  An earlier form of this kernel staged an im2col
//   tile in shared memory with cp.async and ldmatrix over double- or
//   triple-buffered K chunks; it was slower (PERF.md), its time spent at
//   the barriers of each chunk and in the staging instructions.
//
//   B, W's columns K-contiguous: HWIO keeps Cout contiguous, so the block
//   turns rows 4k .. 4k + 3 of four channels into one k-packed word per
//   channel with __byte_perm, straight from w_q: once per launch where all of
//   K fits in shared memory (every layer of the ship detector: 31 KB at
//   conv_96), else per piece of K between two barriers (the plan's bt_k
//   bytes: 2048), again for every pixel tile of the block.  Rows
//   are 16 mod 32 words apart, so a quarter-warp's 16-byte loads of eight
//   rows fall in 32 banks.  w_q is read as passed on every call: nothing is
//   cached across calls, so a flipped weight bit is seen.
//
//   A block is 8 warps, 128 pixels x 24 channels (a 64 x 48 tile was no
//   faster per forward, PERF.md).  The plan (kernel.py's plan(): pixel
//   tiles, Cout tiles, bytes of K of B staged at once) comes from Python;
//   the C entry launches it after checking that it covers every pixel and
//   channel once and fits in shared memory, and refuses one that does not.
//   The grid is one wave of blocks (as many as the device holds at once,
//   from the occupancy query), block b walking pixel tiles b, b + gridDim.x,
//   ...: resident B is staged once per block, and each warp moves its pixels
//   on by a whole grid with no division.  Cout tiles are on gridDim.y.
//   Opening shared memory past 48 KB (large K only) and the occupancy query
//   are done once per device and size, not on every call.
//
//   The check channel (row 2) is one more n tile in every warp of the
//   Cout-tile-0 blocks.  w_check (int32) is split into
//   four signed byte digits with carries, w_check == sum_i 256^i d_i mod
//   2^32, which fill 4 B columns; each S_i = sum x_p d_i comes out of the mma
//   mod 2^32, and want = sum_i 2^(8i) S_i - zp * sum(w_check) in uint32.  It
//   reads x and w_check only, never acc: a check computed from acc could not
//   catch a flip in it.
//
//   The epilogue adds each column's constant, -zp * colsum (and + bias in
//   the fused kernel), in uint32 (signed overflow is undefined in C++); a
//   lane holds the constants of its 2 x kNT columns in registers, loaded
//   once per block.  The accumulator kernels store each lane's two columns
//   of its two pixels as 8-byte stores straight from the fragments: each
//   store instruction fills eight whole 32-byte sectors.  One device op per
//   call: no memset, no atomics.
//
//   The fused kernel (row 3) requantises in registers, so int32 never
//   reaches device memory, and gives JAX's rounding bit for bit:
//   int->float round-to-nearest, a multiply that is never contracted into
//   an FMA (__fmul_rn: this file is built without -fmad=false), rintf (half
//   to even), + out_zp (__fadd_rn), clamp to [-128, 127].  Each lane stores
//   its two int8 columns of a pixel and n tile as one 2-byte store.
//
// Each C entry returns a CUDA error code (0 on success): a plan it cannot
// run, or cudaGetLastError() after its launch.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Geometry {
  int n, hp, wp, cin, kh, kw, cout, oh, ow, sh, sw;
};

// An output pixel as (image, row, column), moved forward by a step given
// the same way (each part below its bound): no division on the way.
struct Pixel {
  int img, oy, ox;

  __device__ __forceinline__ void add(const Pixel& d, const Geometry& g) {
    ox += d.ox;
    oy += d.oy;
    img += d.img;
    if (ox >= g.ow) {
      ox -= g.ow;
      ++oy;
    }
    if (oy >= g.oh) {
      oy -= g.oh;
      ++img;
    }
  }

  // Offset in x of the pixel's window (-1 past the last image).
  __device__ __forceinline__ long long base(const Geometry& g) const {
    if (img >= g.n) return -1;
    return ((static_cast<long long>(img) * g.hp + static_cast<long long>(oy) * g.sh) * g.wp
            + static_cast<long long>(ox) * g.sw) * g.cin;
  }
};

__host__ __device__ inline Pixel split_pixel(long long pix, const Geometry& g) {
  const long long plane = static_cast<long long>(g.oh) * g.ow;
  const long long img = pix / plane;
  const int rem = static_cast<int>(pix - img * plane);
  return Pixel{static_cast<int>(img), rem / g.ow, rem % g.ow};
}

// ---------------------------------------------------------------------------
// qconv2d_mma_kernel: rows 1, 2 and 3
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 256;              // 8 warps
constexpr int kWarps = kMmaThreads / 32;
constexpr int kNT = 3;                        // n tiles of 8 channels per warp
constexpr int kMacro = 64;                    // K bytes of two mma steps
constexpr int kMaxSmem = 232448;              // 227 KB a block can take
constexpr int kMaxDevices = 64;
// Pixels and channels of a block's tile (kernel.py's TILE_M, TILE_N): 8
// groups of 16 pixels, one warp each, by 3 n tiles.
constexpr int kTileM = 16 * kWarps;
constexpr int kTileN = 8 * kNT;

enum Mode { kAcc = 0, kAccChecksum = 1, kRequant = 2 };

// Words per B row over bt_k bytes of K: 16 mod 32, so that the eight rows x
// 16 bytes of one quarter-warp's 16-byte loads fall in 32 banks.
__host__ __device__ constexpr int row_words(int bt_k) {
  return bt_k / 4 + (48 - bt_k / 4 % 32) % 32;
}

// Shared memory (kernel.py's smem_bytes() gives the same total): B's rows
// (the tile's channels, then the check's 8) over bt_k bytes of K; the K
// walk's table, one (offset in x, bytes) pair per 16 bytes of K; the
// per-warp sums of w_check.
__host__ __device__ constexpr int table_offset(int bt_k) {
  return 4 * (kTileN + 8) * row_words(bt_k);
}
inline int smem_bytes(int bt_k) {
  return table_offset(bt_k) + 8 * (bt_k / 16) + 4 * kWarps;
}

struct MmaArgs {
  const int8_t* x;
  const int8_t* w;
  const int32_t* colsum;
  const int32_t* w_check;                     // kAccChecksum
  const int32_t* bias;                        // kRequant
  const float* scale;                         // kRequant
  const int32_t* zp;                          // zp, or [x_zp, out_zp] (kRequant)
  int32_t* acc;                               // kAcc, kAccChecksum
  int32_t* want;                              // kAccChecksum
  int8_t* q;                                  // kRequant
  Geometry g;
  int row16;                                  // Kw * Cin padded to a multiple of 16
  int kpad;                                   // Kh * row16
  int kpad64;                                 // kpad rounded up to 64
  int bt_k;                                   // K bytes of B staged at once
                                              // (the plan's)
  int tiles;                                  // pixel tiles (the plan's)
  int xv;                                     // bytes per x load: 16, 8, 4,
                                              // or 1 (words from any address)
  bool w_words;                               // W rows 4-byte aligned
  bool out_pairs;                             // two-column stores allowed
  Pixel step8;                                // 8 pixels on
  Pixel step_grid;                            // a grid of tiles on
};

// The n (1..4) bytes at src, any alignment, zero-extended to a word: from
// the one or two aligned words that hold them (never a word without one of
// them, so never past the end of the tensor's allocation).
__device__ __forceinline__ uint32_t load_word(const int8_t* src, int n) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(src);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(p & ~static_cast<uintptr_t>(3));
  const int sh = static_cast<int>(p & 3);
  const uint32_t lo = __ldg(w);
  const uint32_t hi = sh + n > 4 ? __ldg(w + 1) : 0u;
  const uint32_t v = __funnelshift_r(lo, hi, 8 * sh);
  return n >= 4 ? v : v & ((1u << (8 * n)) - 1u);
}

// The n (0..16) bytes at p (one run of K), zero-filled to 16, in loads of
// kXV bytes (1: words from any address).
template <int kXV>
__device__ __forceinline__ void load_run(const int8_t* p, int n, uint32_t (&w)[4]) {
  if constexpr (kXV == 16) {
    const int4 v = n > 0 ? __ldg(reinterpret_cast<const int4*>(p)) : make_int4(0, 0, 0, 0);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else if constexpr (kXV == 8) {
    const int2 lo = n > 0 ? __ldg(reinterpret_cast<const int2*>(p)) : make_int2(0, 0);
    const int2 hi = n > 8 ? __ldg(reinterpret_cast<const int2*>(p + 8)) : make_int2(0, 0);
    w[0] = lo.x, w[1] = lo.y, w[2] = hi.x, w[3] = hi.y;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nj = n - 4 * j;
      if (kXV == 4) {
        w[j] = nj > 0 ? static_cast<uint32_t>(__ldg(reinterpret_cast<const int*>(p + 4 * j))) : 0u;
      } else {
        w[j] = nj > 0 ? load_word(p + 4 * j, min(4, nj)) : 0u;
      }
    }
  }
}

__device__ __forceinline__ void mma_s8(uint32_t (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// JAX's requantisation of one wrapped int32 sum v, bit for bit: v to f32
// rounded to nearest, times scale (never contracted into an FMA), rounded
// half to even, + out_zp, clamped to int8.
__device__ __forceinline__ int8_t requant(uint32_t v, float scale, float out_zp) {
  float y = __fmul_rn(__int2float_rn(static_cast<int>(v)), scale);
  y = __fadd_rn(rintf(y), out_zp);
  return static_cast<int8_t>(fminf(fmaxf(y, -128.0f), 127.0f));
}

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

// For K bytes [kb, kb + bt_k): B's rows of the tile's channels, where
// thread item (q, k4) turns rows 4 k4 .. + 3 of columns 4q .. + 3 into one
// k-packed word per column straight from w_q (two items' loads in flight at
// once; zero for row padding, past K or past Cout); the K walk's table, the
// offset in x of each 16-byte run (from the window's corner) and its real
// bytes; and, in the check blocks, the check rows: w_check = sum_i 256^i d_i
// mod 2^32 as four signed byte digits d_i.
template <int kMode>
__device__ __forceinline__ void stage_b(const MmaArgs& a, int* bt, int rw,
                                        int2* table, int kb, int n0, bool check) {
  constexpr int kQ = kTileN / 4;
  constexpr int kBatch = 2;
  const int k4s = a.bt_k / 4;
  const int items = kQ * k4s;
  const int run = a.g.kw * a.g.cin;            // x's bytes of one ky
  for (int e0 = threadIdx.x; e0 < items; e0 += kBatch * kMmaThreads) {
    int r[kBatch][4];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kMmaThreads;
      const int k = kb + 4 * (e / kQ);
      const int col = n0 + 4 * (e % kQ);
      const int ky = k / a.row16;
      const int j = k - ky * a.row16;
      int kx = j / a.g.cin;
      int ci = j - kx * a.g.cin;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool live = e < items && k < a.kpad && j + i < run && col < a.g.cout;
        const int8_t* p = a.w + (static_cast<long long>(ky * a.g.kw + kx) * a.g.cin + ci) * a.g.cout + col;
        r[u][i] = !live ? 0
                  : a.w_words ? __ldg(reinterpret_cast<const int*>(p))
                              : static_cast<int>(load_word(p, min(4, a.g.cout - col)));
        if (++ci == a.g.cin) ci = 0, ++kx;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kMmaThreads;
      if (e < items) {
        int cols[4];
        transpose4x4(r[u][0], r[u][1], r[u][2], r[u][3], cols);
#pragma unroll
        for (int i = 0; i < 4; ++i) bt[(4 * (e % kQ) + i) * rw + e / kQ] = cols[i];
      }
    }
  }
  for (int h = threadIdx.x; h < a.bt_k / 16; h += kMmaThreads) {
    const int k = kb + 16 * h;
    const int ky = k / a.row16;
    const int j = k - ky * a.row16;
    const int n = k < a.kpad ? min(16, run - j) : 0;
    table[h] = make_int2(n > 0 ? ky * a.g.wp * a.g.cin + j : 0, max(0, n));
  }
  if (kMode != kAccChecksum || !check) return;
  for (int k4 = threadIdx.x; k4 < k4s; k4 += kMmaThreads) {
    const int k = kb + 4 * k4;
    const int ky = k / a.row16;
    const int j = k - ky * a.row16;
    int kx = j / a.g.cin;
    int ci = j - kx * a.g.cin;
    uint32_t words[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t u = k < a.kpad && j + i < run
                   ? static_cast<uint32_t>(__ldg(a.w_check + (ky * a.g.kw + kx) * a.g.cin + ci))
                   : 0u;
      if (++ci == a.g.cin) ci = 0, ++kx;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const int digit = static_cast<int8_t>(u & 0xffu);
        words[d] |= static_cast<uint32_t>(static_cast<uint8_t>(digit)) << (8 * i);
        u = (u - static_cast<uint32_t>(digit)) >> 8;
      }
    }
#pragma unroll
    for (int d = 0; d < 4; ++d) bt[(kTileN + d) * rw + k4] = static_cast<int>(words[d]);
  }
}

// The block's pixel tiles (blockIdx.x, + gridDim.x, ...), each warp its 16
// pixels of each, with x's runs loaded kXV bytes at a time (the K walk is
// set out in the header).
template <int kMode, int kXV>
__device__ __forceinline__ void conv_tiles(const MmaArgs& a, int* bt, int rw,
                                           int2* table, uint32_t zsum,
                                           const uint32_t (&cs)[kNT][2],
                                           const float (&sc)[kNT][2]) {
  const Geometry& g = a.g;
  const int warp = threadIdx.x / 32;          // the 16-pixel group
  const int lane = threadIdx.x % 32;
  const int gq = lane / 4;                    // the mma's groupID
  const int t4 = lane % 4;                    // its threadID_in_group
  const long long npix = static_cast<long long>(g.n) * g.oh * g.ow;
  const int n0 = blockIdx.y * kTileN;         // the tile's first channel
  const bool check = kMode == kAccChecksum && blockIdx.y == 0;
  const bool resident = a.bt_k >= a.kpad64;
  // n tiles that hold a channel below Cout (at least one)
  const int nt_live = min(kNT, (g.cout - n0 + 7) / 8);
  const float out_zp = kMode == kRequant ? static_cast<float>(__ldg(a.zp + 1)) : 0.0f;

  // rows gq and gq + 8 of the warp's first tile, moved a grid of tiles on
  // per tile
  long long p0 = static_cast<long long>(blockIdx.x) * kTileM + 16 * warp + gq;
  Pixel px0 = split_pixel(p0, g);
  Pixel px8 = px0;
  px8.add(a.step8, g);
  for (long long tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const long long b0 = px0.base(g);
    const long long b8 = px8.base(g);
    uint32_t acc[kNT][4] = {};
    uint32_t chk[4] = {};
    for (int kb = 0; kb < a.kpad64; kb += a.bt_k) {
      if (!resident) {
        __syncthreads();  // every warp is done with the last piece of B
        stage_b<kMode>(a, bt, rw, table, kb, n0, check);
        __syncthreads();
      }
      const int macros = min(a.bt_k, a.kpad64 - kb) / kMacro;
#pragma unroll 2
      for (int m = 0; m < macros; ++m) {
        const int2 run = table[4 * m + t4];
        uint32_t w0[4], w8[4];
        load_run<kXV>(a.x + b0 + run.x, b0 >= 0 ? run.y : 0, w0);
        load_run<kXV>(a.x + b8 + run.x, b8 >= 0 ? run.y : 0, w8);
        const int* brow = bt + 16 * m + 4 * t4;
        int4 bv[kNT + 1];
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          if (j < nt_live) {
            bv[j] = *reinterpret_cast<const int4*>(brow + (8 * j + gq) * rw);
          }
        }
        if (check) bv[kNT] = *reinterpret_cast<const int4*>(brow + (kTileN + gq) * rw);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const uint32_t af[4] = {w0[2 * s], w8[2 * s], w0[2 * s + 1], w8[2 * s + 1]};
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            if (j < nt_live) {
              mma_s8(acc[j], af, s ? bv[j].z : bv[j].x, s ? bv[j].w : bv[j].y);
            }
          }
          if (check) {
            mma_s8(chk, af, s ? bv[kNT].z : bv[kNT].x, s ? bv[kNT].w : bv[kNT].y);
          }
        }
      }
    }

    // acc + each column's constant, straight from the fragments: a lane
    // holds columns 2 t4, 2 t4 + 1 of each n tile for rows gq and gq + 8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long pix = p0 + 8 * h;
      if (pix >= npix) continue;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int col = n0 + 8 * j + 2 * t4;
        const uint32_t v0 = acc[j][2 * h] + cs[j][0];
        const uint32_t v1 = acc[j][2 * h + 1] + cs[j][1];
        const bool pair = a.out_pairs && col + 1 < g.cout;
        if constexpr (kMode == kRequant) {
          int8_t* out = a.q + pix * g.cout;
          const int8_t y0 = requant(v0, sc[j][0], out_zp);
          const int8_t y1 = requant(v1, sc[j][1], out_zp);
          if (pair) {
            *reinterpret_cast<char2*>(out + col) = make_char2(y0, y1);
          } else {
            if (col < g.cout) out[col] = y0;
            if (col + 1 < g.cout) out[col + 1] = y1;
          }
        } else {
          int32_t* out = a.acc + pix * g.cout;
          if (pair) {
            *reinterpret_cast<uint2*>(out + col) = make_uint2(v0, v1);
          } else {
            if (col < g.cout) out[col] = static_cast<int32_t>(v0);
            if (col + 1 < g.cout) out[col + 1] = static_cast<int32_t>(v1);
          }
        }
      }
    }
    // want = sum_i 2^(8i) S_i - zp * sum(w_check): digit columns 0, 1 in
    // lanes t4 = 0, columns 2, 3 in t4 = 1
    if (check) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t part = t4 == 0 ? chk[2 * h] + (chk[2 * h + 1] << 8)
                      : t4 == 1 ? (chk[2 * h] << 16) + (chk[2 * h + 1] << 24) : 0u;
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        const long long pix = p0 + 8 * h;
        if (t4 == 0 && pix < npix) a.want[pix] = static_cast<int32_t>(part - zsum);
      }
    }
    p0 += static_cast<long long>(gridDim.x) * kTileM;
    px0.add(a.step_grid, g);
    px8.add(a.step_grid, g);
  }
}

template <int kMode>
__global__ void __launch_bounds__(kMmaThreads)
qconv2d_mma_kernel(MmaArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* bt = reinterpret_cast<int*>(smem);
  const int rw = row_words(a.bt_k);
  int2* table = reinterpret_cast<int2*>(smem + table_offset(a.bt_k));
  uint32_t* sum_s = reinterpret_cast<uint32_t*>(table + a.bt_k / 16);
  const Geometry& g = a.g;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int t4 = lane % 4;
  const int n0 = blockIdx.y * kTileN;
  const bool check = kMode == kAccChecksum && blockIdx.y == 0;

  // the epilogue's constants: for each of the lane's columns, bias -
  // zp * colsum (bias in the fused kernel only) and the fused kernel's
  // scale; zp * sum(w_check) in the check blocks
  const uint32_t zp = static_cast<uint32_t>(__ldg(a.zp));
  uint32_t cs[kNT][2];
  float sc[kNT][2];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + 8 * j + 2 * t4 + h;
      if (col >= g.cout) {
        cs[j][h] = 0u;
        sc[j][h] = 0.0f;
        continue;
      }
      const uint32_t b = kMode == kRequant ? static_cast<uint32_t>(__ldg(a.bias + col)) : 0u;
      cs[j][h] = b - zp * static_cast<uint32_t>(__ldg(a.colsum + col));
      sc[j][h] = kMode == kRequant ? __ldg(a.scale + col) : 0.0f;
    }
  }
  uint32_t zsum = 0;
  if (check) {
    uint32_t s = 0;
    const int taps_cin = g.kh * g.kw * g.cin;
    for (int e = tid; e < taps_cin; e += kMmaThreads) s += static_cast<uint32_t>(__ldg(a.w_check + e));
#pragma unroll
    for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) sum_s[warp] = s;
    // the check n tile's last 4 columns stay zero
    for (int e = tid; e < 4 * rw; e += kMmaThreads) bt[(kTileN + 4) * rw + e] = 0;
  }
  // B over all of K, once, where it fits
  if (a.bt_k >= a.kpad64) stage_b<kMode>(a, bt, rw, table, 0, n0, check);
  __syncthreads();
  if (check) {
#pragma unroll
    for (int q = 0; q < kWarps; ++q) zsum += sum_s[q];
    zsum *= zp;
  }
  switch (a.xv) {
    case 16: conv_tiles<kMode, 16>(a, bt, rw, table, zsum, cs, sc); break;
    case 8: conv_tiles<kMode, 8>(a, bt, rw, table, zsum, cs, sc); break;
    case 4: conv_tiles<kMode, 4>(a, bt, rw, table, zsum, cs, sc); break;
    default: conv_tiles<kMode, 1>(a, bt, rw, table, zsum, cs, sc); break;
  }
}

// Blocks of the kernel with `smem` bytes of shared memory that the device
// holds at once (per SM times SMs); shared memory past 48 KB opened for the
// kernel.  Both once per device and size, so never on the hot path after
// the first launch.
template <int kMode>
cudaError_t resident_blocks(int smem, int* blocks) {
  struct Entry {
    int smem, blocks;
  };
  constexpr int kSlots = 16;
  static Entry cache[kMaxDevices][kSlots];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  Entry* slots = dev < kMaxDevices ? cache[dev] : nullptr;
  for (int i = 0; slots && i < kSlots; ++i) {
    if (slots[i].blocks > 0 && slots[i].smem == smem) {
      *blocks = slots[i].blocks;
      return cudaSuccess;
    }
  }
  auto kernel = qconv2d_mma_kernel<kMode>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMmaThreads, smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *blocks = std::max(1, per_sm) * sms;
  for (int i = 0; slots && i < kSlots; ++i) {
    if (slots[i].blocks == 0) {
      slots[i] = Entry{smem, *blocks};
      break;
    }
  }
  return cudaSuccess;
}

// The plan (kernel.py's plan()) checked, then launched as one wave of blocks,
// each walking every gridDim.x-th pixel tile.  `a` holds the entry's
// pointers and geometry; the rest is filled in here.
template <int kMode>
int launch_mma(MmaArgs a, int tiles, int grid_y, int bt_k, void* stream) {
  const Geometry& g = a.g;
  const long long npix = static_cast<long long>(g.n) * g.oh * g.ow;
  if (npix == 0 || g.cout == 0) return static_cast<int>(cudaSuccess);
  const long long row16 = (static_cast<long long>(g.kw) * g.cin + 15) / 16 * 16;
  const long long kpad = g.kh * row16;
  // the walk's offsets in x are ints
  const long long reach = (static_cast<long long>(g.kh) * g.wp + g.kw) * g.cin;
  // every pixel and channel in one tile; B's pieces whole mma steps that
  // fit in shared memory
  if (tiles != (npix + kTileM - 1) / kTileM || grid_y != (g.cout + kTileN - 1) / kTileN
      || grid_y > 65535 || bt_k < kMacro || bt_k % kMacro != 0 || bt_k > kMaxSmem
      || smem_bytes(bt_k) > kMaxSmem || kpad > INT_MAX / 2 || reach > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.row16 = static_cast<int>(row16);
  a.kpad = static_cast<int>(kpad);
  a.kpad64 = static_cast<int>((kpad + kMacro - 1) / kMacro * kMacro);
  a.bt_k = bt_k;
  a.tiles = tiles;
  // x's runs start at multiples of Cin: the widest load that divides Cin
  // and x's address
  a.xv = 1;
  for (int v = 16; v >= 4; v /= 2) {
    if (g.cin % v == 0 && reinterpret_cast<uintptr_t>(a.x) % v == 0) {
      a.xv = v;
      break;
    }
  }
  a.w_words = g.cout % 4 == 0 && reinterpret_cast<uintptr_t>(a.w) % 4 == 0;
  // two columns of int32 (8 bytes) or of int8 (2 bytes) at once
  const uintptr_t out = kMode == kRequant ? reinterpret_cast<uintptr_t>(a.q)
                                          : reinterpret_cast<uintptr_t>(a.acc);
  a.out_pairs = g.cout % 2 == 0 && out % (kMode == kRequant ? 2 : 8) == 0;
  a.step8 = split_pixel(8, g);
  const int smem = smem_bytes(bt_k);
  int blocks = 0;
  const cudaError_t err = resident_blocks<kMode>(smem, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid_x = std::min(tiles, std::max(1, blocks / grid_y));
  a.step_grid = split_pixel(static_cast<long long>(grid_x) * kTileM, g);
  qconv2d_mma_kernel<kMode>
      <<<dim3(static_cast<unsigned>(grid_x), static_cast<unsigned>(grid_y)),
         kMmaThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int qconv2d_acc_launch(const void* x, const void* w, const void* colsum,
                       const void* zp, void* out, int n, int hp, int wp,
                       int cin, int kh, int kw, int cout, int oh, int ow,
                       int sh, int sw, int tiles, int grid_y, int bt_k,
                       void* stream) {
  MmaArgs a{};
  a.x = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.colsum = static_cast<const int32_t*>(colsum);
  a.zp = static_cast<const int32_t*>(zp);
  a.acc = static_cast<int32_t*>(out);
  a.g = Geometry{n, hp, wp, cin, kh, kw, cout, oh, ow, sh, sw};
  return launch_mma<kAcc>(a, tiles, grid_y, bt_k, stream);
}

int qconv2d_acc_checksum_launch(const void* x, const void* w,
                                const void* colsum, const void* w_check,
                                const void* zp, void* out, void* want, int n,
                                int hp, int wp, int cin, int kh, int kw,
                                int cout, int oh, int ow, int sh, int sw,
                                int tiles, int grid_y, int bt_k,
                                void* stream) {
  MmaArgs a{};
  a.x = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.colsum = static_cast<const int32_t*>(colsum);
  a.w_check = static_cast<const int32_t*>(w_check);
  a.zp = static_cast<const int32_t*>(zp);
  a.acc = static_cast<int32_t*>(out);
  a.want = static_cast<int32_t*>(want);
  a.g = Geometry{n, hp, wp, cin, kh, kw, cout, oh, ow, sh, sw};
  return launch_mma<kAccChecksum>(a, tiles, grid_y, bt_k, stream);
}

int qconv2d_launch(const void* x, const void* w, const void* colsum,
                   const void* bias, const void* scale, const void* zps,
                   void* out, int n, int hp, int wp, int cin, int kh, int kw,
                   int cout, int oh, int ow, int sh, int sw, int tiles,
                   int grid_y, int bt_k, void* stream) {
  MmaArgs a{};
  a.x = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.colsum = static_cast<const int32_t*>(colsum);
  a.bias = static_cast<const int32_t*>(bias);
  a.scale = static_cast<const float*>(scale);
  a.zp = static_cast<const int32_t*>(zps);
  a.q = static_cast<int8_t*>(out);
  a.g = Geometry{n, hp, wp, cin, kh, kw, cout, oh, ow, sh, sw};
  return launch_mma<kRequant>(a, tiles, grid_y, bt_k, stream);
}

}  // extern "C"
