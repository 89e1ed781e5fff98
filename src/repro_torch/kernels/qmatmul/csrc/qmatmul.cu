// Int8 matmul kernels for Hopper (sm_90a), plain C entry points bound from
// Python with ctypes (kernels/qmatmul/kernel.py).
//
// Replaces the three Pallas TPU kernels of src/repro/kernels/qmatmul/kernel.py,
// all three on one template, qmatmul_mma_kernel<kMode>:
//   qmatmul_acc           (kernel.py:138)  X (M,K) int8 . W (K,N) int8
//                                          -> (M,N) int32 accumulator
//                                          qmatmul_mma_kernel<kAcc>
//   qmatmul_acc_checksum  (kernel.py:176)  the same acc plus the ABFT check
//                                          vector want (M,) = X . w_check
//                                          qmatmul_mma_kernel<kAccChecksum>
//   qmatmul               (kernel.py:224)  the same acc plus the fused
//                                          requantisation epilogue -> int8
//                                          qmatmul_mma_kernel<kRequant>
// X and W are row-major; the outputs are row-major.  Integer results wrap
// mod 2^32 as the reference's do, bit for bit.
//
// Bound on an H100 SXM: max(bytes / 3.35 TB/s, 2*M*N*K / 1,979 TOPS int8),
// each input read once and each output written once.  On the serving path
// (the W8A8 FFN: M = 8 decode rows or 64 prefill rows, (K, N) = (576, 1536)
// or (1536, 576)) the K*N = 884,736 weight bytes dominate: every call is
// bound by bytes at 0.27-0.39 us, and the arithmetic is 100x below the
// int8 rate.  That bound is out of reach for one call: at ~1 us of memory
// latency, Little's law wants ~3 MB in flight to draw 3.35 TB/s, and the
// whole call moves 0.9 MB.  The floor of one call is one launch plus about
// one memory round trip.  The design aims at that floor: one device op per
// call, every load of a block in flight before its first wait, about one
// wave of blocks, and few barriers after the loads.
//
// The template.
//
//   Tensor cores, with A and B swapped.  The products run on
//   mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 as C^T = W^T . X^T:
//   the mma's m = 16 rows are 16 output columns of W and its n = 8 side is
//   8 token rows of X, so that at decode (M = 8) every lane carries a real
//   row instead of half of a 16-row tile being zeros.  B's .col layout is
//   K-contiguous per column, which X's rows already are.  A wants each W
//   column's K bytes packed into words; Hopper has no 8-bit ldmatrix.trans,
//   so each staged W chunk is byte-transposed once (__byte_perm,
//   transpose4x4) into W^T rows padded to 4 mod 8 words, which makes every
//   fragment load hit 32 distinct banks.  No .satfinite: the reference
//   wraps.  mma.sync rather than wgmma: these shapes are bound by latency
//   and bytes, 100x below the tensor-core rate, and wgmma's 64-row
//   warpgroup tiles would only add zero rows and a descriptor layout for
//   the transposed W.  A block is 8 warps over a tile of 32 columns by up
//   to 64 rows: warp (jg, kp) takes the 8 rows 8 jg.. and every ksplit-th
//   32-deep K step from kp (ksplit = 8 / row groups: 8 warps share the K
//   steps of one group at M = 8, one warp per group at 64 rows).  C's
//   fragment is stored transposed, as rows of X.
//
//   Loads.  A block's W slice (k_rank x 32 columns; 6 KB at the decode
//   shapes), its X rows and its w_check slice are copied with 16-byte
//   cp.async, all issued before the first wait; past the block's K range,
//   M or N, cp.async's src-size zero-fills.  A W row's 32 bytes land in a
//   32-byte slot that rotates every four rows, so the transpose's reads of
//   four rows hit four different slots.  A row off a 16-byte boundary (K or
//   N not a multiple of 16, an offset view) is copied bytewise in the same
//   kernel.  K ranges above k_chunk (256) run as a loop of chunks, one
//   exposed round trip each: only large-M calls with one block per K range
//   take it.  One warp per SM scheduler leaves no latency hidden, so the
//   copy loops are unrolled with compile-time bounds, and the host passes
//   the shared-memory layout and the splits as shifts: a runtime integer
//   division is a long chain of dependent instructions.
//
//   Split K inside a thread block cluster.  The grid is (M tiles, ranks x N
//   tiles) in clusters of (1, ranks, 1): the K ranges of one output tile
//   are the ranks of one cluster (at most 8, the portable size), and M
//   tiles on gridDim.x are not limited to 65535 (ranks x N tiles on
//   gridDim.y is).  Each block sums its warps' partial tiles in its shared
//   memory and pushes the sum into slot `rank` of rank 0's shared memory
//   through DSMEM (cluster.map_shared_rank); after one cluster.sync() rank
//   0 adds the slots in rank order and writes acc (and want) with plain
//   stores, or requantises them (below).  Every thread arrives on the
//   cluster barrier's first phase as the kernel starts and waits on it
//   just before the first push, so no
//   block writes into a rank that has not started.  No memset, no
//   atomics: one call is one device op.  Rank 0 pulling the partials from
//   the other ranks instead would need a round trip of remote loads and a
//   second cluster barrier to keep their shared memory alive until read.
//   Python's plan() (kernel.py) sizes the clusters so that a decode shape
//   fills about one wave of 132 SMs (3 x 48 and 8 x 18 = 144 blocks).
//
//   The check vector stays independent of acc: want = X . w_check mod
//   2^32, from the staged X rows and w_check in uint32 on the CUDA cores
//   (w_check is int32).  Its rows are spread over the N tiles
//   (check_rows each: one at M = 8), each rank of such a cluster sums its
//   own K range with up to a warp of lanes per row, and the sums travel
//   to rank 0 beside the partial tiles.  A check computed from acc could
//   not catch a flip in it.
//
//   The fused kernel (row 6) is the same kernel up to rank 0's sum, which
//   is the whole int32 sum of each output, exact mod 2^32 in any order.
//   Rank 0 requantises it there, so int32 never reaches device memory, and
//   gives JAX's rounding bit for bit: the zero-point and bias terms in
//   uint32 (signed overflow is undefined in C++), int->float
//   round-to-nearest, a multiply that is never contracted into an FMA
//   (__fmul_rn), rintf (half to even), + out_zp (__fadd_rn), clamp to
//   [-128, 127].  A thread sums the same 4 columns of every row it takes, so
//   it loads their constants (bias - x_zp * colsum, scale) once, before the
//   cluster barrier, and stores each row's 4 int8 as one 4-byte store: a
//   block writes 32 contiguous bytes per row of X.
//
// Each C entry returns a CUDA error code (0 on success): a plan it cannot
// run, or cudaGetLastError() after its launch.

#include <algorithm>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

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

// ---------------------------------------------------------------------------
// qmatmul_mma_kernel: rows 4 and 5
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 256;              // 8 warps
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kTileN = 32;                    // W columns per block
constexpr int kMaxTileM = 64;                 // X rows per block
constexpr int kMaxKChunk = 256;               // K rows staged at once
constexpr int kMaxCluster = 8;                // portable cluster size
constexpr int kMaxSmem = 232448;              // 227 KB a block can take
constexpr int kRedStride = kTileN + 4;        // words per partial-tile row

enum Mode { kAcc = 0, kAccChecksum = 1, kRequant = 2 };

// The launch plan from kernel.py's plan(): X rows per block, K rows per
// cluster rank, K rows per staged chunk, ranks per cluster, blocks.
struct Plan {
  int tile_m, k_rank, k_chunk, cluster, grid;
};

// Byte offsets of the shared-memory regions (kernel.py's smem_bytes()
// gives the same total).
struct Layout {
  int wraw, wt, wc, red, slots, want_slots, total;
};

struct Args {
  const int8_t* x;
  const int8_t* w;
  const int32_t* w_check;                     // kAccChecksum
  const int32_t* colsum;                      // kRequant
  const int32_t* bias;                        // kRequant
  const float* scale;                         // kRequant
  const int32_t* zps;                         // kRequant: [x_zp, out_zp]
  int32_t* acc;                               // kAcc, kAccChecksum
  int32_t* want;                              // kAccChecksum
  int8_t* q;                                  // kRequant
  int m, k, n;
  int tile_m, k_rank, k_chunk;
  int rw;                                     // words per staged X / W^T row
  int ksplit_log;                             // log2 of the warps per row group
  int check_rows;                             // check rows per N tile
  int tpr_log;                                // log2 of the check's lanes per row
  Layout L;                                   // X rows start at offset 0
  bool x_vec, w_vec, wc_vec;                  // 16-byte cp.async allowed
  bool out_vec;                               // 4-column stores allowed
};

// Words per staged row of k_chunk K bytes (a multiple of 32): 4 mod 8, so
// that the 8 rows x 4 words of one fragment load fall in 32 banks.
constexpr int row_words(int k_chunk) { return k_chunk / 4 + 4; }

// Warps that split the K steps of one group of 8 X rows: the 8 warps
// cover the tile_m / 8 groups (8, 4, 2, 2, 1, 1, 1, 1 for 1..8 groups).
constexpr int k_split(int tile_m) { return kMmaWarps / (tile_m / 8); }

// Each region starts where the one before it ends: X rows (at 0), then
inline Layout layout(int tile_m, int k_chunk, int cluster) {
  const int rw = row_words(k_chunk);
  Layout s;
  s.wraw = 4 * tile_m * rw;             // W rows, as copied
  s.wt = s.wraw + kTileN * k_chunk;     // W^T rows of k-packed words
  s.wc = s.wt + 4 * kTileN * rw;        // w_check
  s.red = s.wc + 4 * k_chunk;           // the warps' partial tiles
  s.slots = s.red + 4 * k_split(tile_m) * tile_m * kRedStride;  // rank 0's:
  s.want_slots = s.slots + 4 * cluster * tile_m * kRedStride;   // the ranks'
  s.total = s.want_slots + 4 * cluster * kMaxTileM;             // tiles, wants
  return s;
}

constexpr int log2i(int v) { return v > 1 ? 1 + log2i(v / 2) : 0; }

// Byte offset of staged W row k: four rows to a 128-byte line, row k in
// the 32-byte slot (k + k/4) mod 4, so that rows 4i + j of four
// consecutive i (one read of the transpose) sit in four different slots.
__device__ __forceinline__ int wraw_offset(int k) {
  return (k >> 2) * 128 + (((k + (k >> 2)) & 3) << 5);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes at dst (shared, 16-byte aligned): the len (0..16) bytes at src,
// zero-filled after them.  vec: src is 16-byte aligned, one cp.async;
// otherwise byte loads (src off a 16-byte boundary).  A src with len 0 is
// never read.
__device__ __forceinline__ void copy16(void* dst, const int8_t* src, int len,
                                       bool vec) {
  if (vec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(len)
                 : "memory");
    return;
  }
  uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (i < len) {
      v[i / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(src + i)))
                  << (8 * (i % 4));
    }
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void mma_s8(uint32_t (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 add4(uint4 s, uint4 v) {
  return make_uint4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
}

// JAX's requantisation of one wrapped int32 sum v, bit for bit: v to f32
// rounded to nearest, times scale (never contracted into an FMA), rounded
// half to even, + out_zp, clamped to int8.
__device__ __forceinline__ int8_t requant(uint32_t v, float scale, float out_zp) {
  float y = __fmul_rn(__int2float_rn(static_cast<int>(v)), scale);
  y = __fadd_rn(rintf(y), out_zp);
  return static_cast<int8_t>(fminf(fmaxf(y, -128.0f), 127.0f));
}

template <int kMode>
__global__ void __launch_bounds__(kMmaThreads) qmatmul_mma_kernel(Args a) {
  // Arrive on the cluster barrier's first phase at once; its wait, before
  // the first store into rank 0's shared memory, guarantees that every
  // rank has started.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  extern __shared__ __align__(16) unsigned char smem[];
  int* xs = reinterpret_cast<int*>(smem);
  unsigned char* wraw = smem + a.L.wraw;
  int* wt = reinterpret_cast<int*>(smem + a.L.wt);
  int32_t* wcs = reinterpret_cast<int32_t*>(smem + a.L.wc);
  uint32_t* red = reinterpret_cast<uint32_t*>(smem + a.L.red);
  uint32_t* slots = reinterpret_cast<uint32_t*>(smem + a.L.slots);
  uint32_t* want_slots = reinterpret_cast<uint32_t*>(smem + a.L.want_slots);

  // grid (M tiles, ranks x N tiles), clusters of (1, ranks, 1)
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.dim_blocks().y);
  const int rank = static_cast<int>(cluster.block_index().y);
  int n_tile;
  asm("mov.u32 %0, %%clusterid.y;" : "=r"(n_tile));
  const int n0 = n_tile * kTileN;
  const int m0 = blockIdx.x * a.tile_m;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;                     // the mma's groupID
  const int t4 = lane % 4;                    // its threadID_in_group
  const int rw = a.rw;
  // the check's rows: check_rows of the tile's rows per N tile
  const int c_lo = min(a.tile_m, n_tile * a.check_rows);
  const int c_hi = min(a.tile_m, c_lo + a.check_rows);
  const bool check = kMode == kAccChecksum && c_lo < c_hi;
  const int k_begin = min(a.k, rank * a.k_rank);
  const int k_end = min(a.k, k_begin + a.k_rank);
  // warp (jg, kp): rows 8 jg .. 8 jg + 7, K steps kp, kp + ksplit, ...
  const int ksplit = 1 << a.ksplit_log;
  const int jg = warp >> a.ksplit_log;
  const int kp = warp & (ksplit - 1);
  // the check: tpr neighbouring lanes per row split its K words
  const int tpr = 1 << a.tpr_log;
  const int check_row = c_lo + (tid >> a.tpr_log);
  const int check_part = tid & (tpr - 1);

  uint32_t acc[2][4] = {};                    // [16-column half][fragment]
  uint32_t want = 0;

  for (int kb = k_begin; kb < k_end; kb += a.k_chunk) {
    const int ke = min(k_end, kb + a.k_chunk);
    const int steps = (ke - kb + 31) / 32;     // 32-deep mma steps
    const int kw = 8 * steps;                   // staged words per row
    // X: 16 threads per row, a 16-byte piece each
#pragma unroll
    for (int i = 0; i < kMaxTileM / (kMmaThreads / 16); ++i) {
      const int r = tid / 16 + i * (kMmaThreads / 16);
      const int c = tid % 16;
      if (r < a.tile_m && c < 2 * steps) {
        const int k = kb + 16 * c;
        const int len = m0 + r < a.m ? max(0, min(16, ke - k)) : 0;
        copy16(xs + r * rw + 4 * c,
               len ? a.x + static_cast<size_t>(m0 + r) * a.k + k : a.x, len,
               a.x_vec);
      }
    }
    // W: the 32 columns of a row in two 16-byte pieces
#pragma unroll
    for (int i = 0; i < 2 * kMaxKChunk / kMmaThreads; ++i) {
      const int e = tid + i * kMmaThreads;
      const int kk = e / 2;
      if (kk < 32 * steps) {
        const int col = n0 + 16 * (e % 2);
        const int len = kb + kk < ke ? max(0, min(16, a.n - col)) : 0;
        copy16(wraw + wraw_offset(kk) + 16 * (e % 2),
               len ? a.w + static_cast<size_t>(kb + kk) * a.n + col : a.w,
               len, a.w_vec);
      }
    }
    if (check && tid < kw) {  // w_check, 4 values a piece
      const int k = kb + 4 * tid;
      const int len = 4 * max(0, min(4, ke - k));
      copy16(wcs + 4 * tid,
             reinterpret_cast<const int8_t*>(len ? a.w_check + k
                                                 : a.w_check),
             len, a.wc_vec);
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                     : "memory");
    __syncthreads();

    // W^T: thread (q, k4) turns rows 4 k4 .. 4 k4 + 3 of columns 4q .. 4q +
    // 3 into one k-packed word per column
#pragma unroll
    for (int i = 0; i < 8 * kMaxKChunk / 4 / kMmaThreads; ++i) {
      const int e = tid + i * kMmaThreads;
      const int q = e % 8;
      const int k4 = e / 8;
      if (k4 < kw) {
        int r[4], cols[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          r[j] = *reinterpret_cast<const int*>(wraw + wraw_offset(4 * k4 + j)
                                               + 4 * q);
        }
        transpose4x4(r[0], r[1], r[2], r[3], cols);
#pragma unroll
        for (int c = 0; c < 4; ++c) wt[(4 * q + c) * rw + k4] = cols[c];
      }
    }
    if (check && check_row < c_hi) {
      for (int k4 = check_part; k4 < kw; k4 += tpr) {
        const int xw = xs[check_row * rw + k4];
        const int4 cv = *reinterpret_cast<const int4*>(wcs + 4 * k4);
        const int c4[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int xv = static_cast<int8_t>(xw >> (8 * b));
          want += static_cast<uint32_t>(xv) * static_cast<uint32_t>(c4[b]);
        }
      }
    }
    __syncthreads();

    // A: W^T rows 16h + g (+ 8), words t4 (+ 4) of the step; B: X row
    // 8 jg + g, the same words
    if (8 * jg < a.tile_m) {
      for (int st = kp; st < steps; st += ksplit) {
        uint32_t af[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int* c0 = wt + (16 * h + g) * rw + 8 * st + t4;
          const int* c8 = c0 + 8 * rw;
          af[h][0] = c0[0];
          af[h][1] = c8[0];
          af[h][2] = c0[4];
          af[h][3] = c8[4];
        }
        const int* xr = xs + (8 * jg + g) * rw + 8 * st + t4;
        const uint32_t b0 = xr[0];
        const uint32_t b1 = xr[4];
        mma_s8(acc[0], af[0], b0, b1);
        mma_s8(acc[1], af[1], b0, b1);
      }
    }
    if (kb + a.k_chunk < k_end) __syncthreads();  // the next chunk restages
  }

  // The warp's partial C^T as 8 rows of X in slot kp (element c of half h
  // is column 16h + g + 8(c / 2), row 2 t4 + c % 2 of the group).
  if (8 * jg < a.tile_m) {
    uint32_t* mine = red + (kp * a.tile_m + 8 * jg) * kRedStride;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        mine[(2 * t4 + (c & 1)) * kRedStride + 16 * h + g + 8 * (c >> 1)] =
            acc[h][c];
      }
    }
  }
  if (check) {
    for (int off = tpr / 2; off > 0; off /= 2) {
      want += __shfl_xor_sync(0xffffffffu, want, off);
    }
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (check && check_row < c_hi && check_part == 0) {
    cluster.map_shared_rank(want_slots, 0)[rank * kMaxTileM + check_row] =
        want;
  }
  __syncthreads();
  // The block's partial tile, the sum of its K splits, pushed into slot
  // `rank` of rank 0's shared memory through DSMEM, 4 columns at a time.
  const int groups = a.tile_m * (kTileN / 4);
  uint32_t* slot =
      cluster.map_shared_rank(slots, 0) + rank * a.tile_m * kRedStride;
  for (int e = tid; e < groups; e += kMmaThreads) {
    const int i = (e / (kTileN / 4)) * kRedStride + 4 * (e % (kTileN / 4));
    uint4 v[kMmaWarps];
#pragma unroll
    for (int q = 0; q < kMmaWarps; ++q) {
      if (q < ksplit) {
        v[q] = *reinterpret_cast<const uint4*>(red + q * a.tile_m * kRedStride
                                               + i);
      }
    }
    uint4 s = v[0];
#pragma unroll
    for (int q = 1; q < kMmaWarps; ++q) {
      if (q < ksplit) s = add4(s, v[q]);
    }
    *reinterpret_cast<uint4*>(slot + i) = s;
  }
  // the fused kernel's constants of this thread's 4 columns (the same in
  // every row it takes below), loaded while the cluster meets
  const int c = 4 * (tid % (kTileN / 4));
  uint32_t off[4] = {};
  float sc[4] = {};
  float out_zp = 0.0f;
  if (kMode == kRequant && rank == 0) {
    const uint32_t x_zp = static_cast<uint32_t>(__ldg(a.zps));
    out_zp = static_cast<float>(__ldg(a.zps + 1));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (n0 + c + i < a.n) {
        off[i] = static_cast<uint32_t>(__ldg(a.bias + n0 + c + i))
                 - x_zp * static_cast<uint32_t>(__ldg(a.colsum + n0 + c + i));
        sc[i] = __ldg(a.scale + n0 + c + i);
      }
    }
  }
  cluster.sync();  // every push has landed in rank 0
  if (rank != 0) return;

  // Rank 0 sums the slots in rank order and stores the tile and want, or
  // the requantised tile.
  static_assert(kMmaThreads % (kTileN / 4) == 0, "a thread keeps its columns");
  for (int e = tid; e < groups; e += kMmaThreads) {
    const int r = e / (kTileN / 4);
    uint4 v[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      if (q < ranks) {
        v[q] = *reinterpret_cast<const uint4*>(
            slots + (q * a.tile_m + r) * kRedStride + c);
      }
    }
    uint4 s = v[0];
#pragma unroll
    for (int q = 1; q < kMaxCluster; ++q) {
      if (q < ranks) s = add4(s, v[q]);
    }
    if (m0 + r >= a.m) continue;
    const size_t at = static_cast<size_t>(m0 + r) * a.n + n0 + c;
    const bool vec = a.out_vec && n0 + c + 4 <= a.n;
    const uint32_t sv[4] = {s.x, s.y, s.z, s.w};
    if constexpr (kMode == kRequant) {
      int8_t y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) y[i] = requant(sv[i] + off[i], sc[i], out_zp);
      if (vec) {
        *reinterpret_cast<char4*>(a.q + at) = make_char4(y[0], y[1], y[2], y[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (n0 + c + i < a.n) a.q[at + i] = y[i];
        }
      }
    } else if (vec) {
      *reinterpret_cast<uint4*>(a.acc + at) = s;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (n0 + c + i < a.n) a.acc[at + i] = static_cast<int32_t>(sv[i]);
      }
    }
  }
  const int r = c_lo + tid;
  if (check && r < c_hi && m0 + r < a.m) {
    uint32_t v[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      if (q < ranks) v[q] = want_slots[q * kMaxTileM + r];
    }
    uint32_t s = v[0];
#pragma unroll
    for (int q = 1; q < kMaxCluster; ++q) {
      if (q < ranks) s += v[q];
    }
    a.want[m0 + r] = static_cast<int32_t>(s);
  }
}

// The plan (kernel.py's plan()) checked, then launched as clusters of
// (1, ranks, 1).  `a` holds the entry's pointers and shape; the rest is
// filled in here.
template <int kMode>
int launch_mma(Args a, Plan p, void* stream) {
  const int m = a.m, k = a.k, n = a.n;
  if (m == 0 || n == 0) return static_cast<int>(cudaSuccess);
  const long long n_tiles = (n + kTileN - 1) / kTileN;
  const long long m_tiles = p.tile_m > 0 ? (m + p.tile_m - 1) / p.tile_m : 0;
  if (p.tile_m < 8 || p.tile_m > kMaxTileM || p.tile_m % 8 != 0
      || p.k_chunk < 32 || p.k_chunk > kMaxKChunk || p.k_chunk % 32 != 0
      || p.k_rank < 32 || p.k_rank % 32 != 0 || p.cluster < 1
      || p.cluster > kMaxCluster
      || static_cast<long long>(p.cluster) * p.k_rank < k
      || static_cast<long long>(p.grid) != p.cluster * n_tiles * m_tiles
      || p.cluster * n_tiles > 65535 || m_tiles > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Layout L = layout(p.tile_m, p.k_chunk, p.cluster);
  if (L.total > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (L.total > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        qmatmul_mma_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L.total);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  a.tile_m = p.tile_m;
  a.k_rank = p.k_rank;
  a.k_chunk = p.k_chunk;
  a.rw = row_words(p.k_chunk);
  a.ksplit_log = log2i(k_split(p.tile_m));
  // the check's rows spread over the N tiles, and over the largest power
  // of 2 of lanes per row (at most a warp) that the block's threads cover
  a.check_rows = static_cast<int>((p.tile_m + n_tiles - 1) / n_tiles);
  int tpr = 32;
  while (tpr * a.check_rows > kMmaThreads) tpr /= 2;
  a.tpr_log = log2i(tpr);
  a.L = L;
  // 16-byte copies need 16-byte aligned rows
  a.x_vec = k % 16 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  a.w_vec = n % 16 == 0 && reinterpret_cast<uintptr_t>(a.w) % 16 == 0;
  a.wc_vec = reinterpret_cast<uintptr_t>(a.w_check) % 16 == 0;
  // 4 columns of int32 (16 bytes) or of int8 (4 bytes) at once
  a.out_vec = n % 4 == 0
              && (kMode == kRequant ? reinterpret_cast<uintptr_t>(a.q) % 4 == 0
                                    : reinterpret_cast<uintptr_t>(a.acc) % 16 == 0);

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = static_cast<unsigned>(p.cluster);
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(m_tiles),
                     static_cast<unsigned>(p.cluster * n_tiles));
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(L.total);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, qmatmul_mma_kernel<kMode>, a);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace

extern "C" {

int qmatmul_acc_launch(const void* x, const void* w, void* out, int m, int k,
                       int n, int tile_m, int k_rank, int k_chunk,
                       int cluster, int grid, void* stream) {
  Args a{};
  a.x = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.acc = static_cast<int32_t*>(out);
  a.m = m, a.k = k, a.n = n;
  return launch_mma<kAcc>(a, Plan{tile_m, k_rank, k_chunk, cluster, grid}, stream);
}

int qmatmul_acc_checksum_launch(const void* x, const void* w,
                                const void* w_check, void* out, void* want,
                                int m, int k, int n, int tile_m, int k_rank,
                                int k_chunk, int cluster, int grid,
                                void* stream) {
  Args a{};
  a.x = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.w_check = static_cast<const int32_t*>(w_check);
  a.acc = static_cast<int32_t*>(out);
  a.want = static_cast<int32_t*>(want);
  a.m = m, a.k = k, a.n = n;
  return launch_mma<kAccChecksum>(a, Plan{tile_m, k_rank, k_chunk, cluster, grid}, stream);
}

int qmatmul_launch(const void* x, const void* w, const void* colsum,
                   const void* bias, const void* scale, const void* zps,
                   void* out, int m, int k, int n, int tile_m, int k_rank,
                   int k_chunk, int cluster, int grid, void* stream) {
  Args a{};
  a.x = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.colsum = static_cast<const int32_t*>(colsum);
  a.bias = static_cast<const int32_t*>(bias);
  a.scale = static_cast<const float*>(scale);
  a.zps = static_cast<const int32_t*>(zps);
  a.q = static_cast<int8_t*>(out);
  a.m = m, a.k = k, a.n = n;
  return launch_mma<kRequant>(a, Plan{tile_m, k_rank, k_chunk, cluster, grid}, stream);
}

}  // extern "C"
