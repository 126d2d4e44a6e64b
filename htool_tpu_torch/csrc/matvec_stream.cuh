// Streaming core of the H-matrix product kernels for NVIDIA Hopper (sm_90a):
// the redesign of the block routines of matvec_block.cuh for this card.
//
// It serves the planned kernel (stream_matvec.cu, behind
// tiled_bucket_matvec; replaces htool_tpu/ops/tiled_matvec.py::_tiled_kernel
// and its two-stage route build_tile_plan_lr_split) and the unplanned dense
// and two-stage low-rank kernels (bucket_stream.cu, behind
// dense_bucket_matvec and lr_bucket_matvec; replaces
// htool_tpu/ops/bucket_matvec.py::_dense_kernel and ::_lr_kernel).
//
// One primitive: a row-major matrix A [R, C] per block, applied to an input
// window and written or added to an output window,
//
//   N:  out[r] (+)= sum_c g(A[r, c]) x[c]        T:  out[c] (+)= sum_r g(A[r, c]) x[r]
//
// with g = conj when asked.  A dense block is one such matrix.  A low-rank
// block U [bm, r] · V [r, bn] is two launches through a staging tensor t in
// device memory (stage A: t = V x or Uᵀ x, stored; stage B: y += U t or
// Vᵀ t), so no CTA walks a block in passes of rank rows and one wide block
// spreads over many CTAs in both stages.
//
// What bounds the work on the H100: every entry of A is read once for 2·k
// (real) or 8·k (complex) flops, so device memory bandwidth (3.35 TB/s);
// at k = 8 complex that is 40 % of the FP32/FP64 pipes' peak, so the inner
// loops must be mostly multiply-adds.  Every block also adds out_w · k sums
// into y, and the rate of those requests at the L2 bounds narrow blocks.
// What the design does about it:
//
// - Work is cut by bytes, on the host (ops/cut.py): large blocks are cut into
//   P panels along the OUTPUT dimension (row panels for N, column slabs for
//   T), small ones grouped G to a CTA, so every CTA streams about the same
//   number of bytes, no partial sum of one output is spread over CTAs, and
//   stage A can store instead of adding.  The pipeline runs on from slot to
//   slot, and the CTA reads its slots' offsets in one round trip before it
//   starts.  (One wave of CTAs with equal static shares was tried and lost to
//   many CTAs scheduled by the hardware: 29.4 against 24.9 ms on the hermitian
//   product at k = 8.)
// - A CTA streams its matrices through a ring of STAGES tiles in dynamic
//   shared memory, filled by cp.async (16 bytes a copy; the element size
//   when a panel lacks 16-byte alignment: odd widths, rank 99 in float32).
//   The bytes in flight are set by the ring (2 CTAs x 2 tiles x 18 KB per
//   SM), not by registers and occupancy.
// - The x window is staged in shared memory by cp.async as well, once per
//   panel when it fits a slot (16 KB), else once per tile, in planes of
//   16-byte vectors [k/VW][rows][VW] so that lanes on consecutive rows read
//   consecutive vectors (no bank conflicts); each x vector read serves RW
//   rows of A.
// - N: a row is shared by few lanes (4 where the panel has rows enough), a
//   tile is 128 row segments of 128 bytes with a 16-byte pad (conflict-free
//   for 4 lanes x 8 rows), so a sum crosses 2 shuffle steps, not 5.
// - Accumulators stay in registers; results go to y with atomicAdd (the
//   order of the additions, and so the rounding, varies from run to run) or
//   to t with plain stores, as reals, consecutive lanes on consecutive
//   addresses: one request per 32-byte sector of a row, not one per sum.
// - float64 and complex128 at KC >= 4 run the inner loop on the FP64 tensor
//   cores (mma.sync m16n8k16, IEEE double multiply-adds: 2048 per warp
//   instruction, where a lane's DFMA does one), which the FP64 pipe and the
//   loop's loads had held back; the sm_80 shape m8n8k4 was slower than
//   multiply-adds here.  No ldmatrix exists for 64-bit types: lanes read
//   their A and B fragments from the staged tiles themselves (N: 8 rows x 32
//   bytes, rows 16 bytes apart modulo 128; T: 4 rows x 64 bytes, rows 64
//   bytes apart: no bank conflicts).  N: warps take m16 tiles of rows and,
//   where a panel has few rows (stage A's rank rows), split the row's reals
//   between them; their sums meet in shared memory, and consecutive threads
//   add consecutive reals of a row into y.  complex128 reads a tile row as 2C
//   reals; for N, B is the real 2C x 2KC matrix of x (rows [xr, xi] and [-xi,
//   xr], signs flipped by conj), built in registers from the staged x, so
//   the sums come out as (re, im) pairs; for T, M runs over the slab's reals
//   and lanes swap fragment rows to form re = Ar xr - Ai xi, im = Ar xi +
//   Ai xr.  The host picks the loop (mma_wanted).  float32 products stay on
//   FP32 multiply-adds: the package pins full float32 products
//   (utils/precision.py), which rules out TF32, and split-float32 is a later
//   item.

#pragma once

#include <type_traits>

#include "matvec_block.cuh"

namespace htool_mv {

constexpr int STAGES = 3;
constexpr int CHUNK_BYTES = 1024;           // bytes of a row in a tile of a wide N matrix
constexpr int TILE_BYTES = 128 * (128 + 16);  // 128 padded rows of 128 bytes, or 16 of a chunk
constexpr int XSLOT_BYTES = 16384;          // x rows staged per slot
constexpr int RED_BYTES = 8192;             // T: partial sums across thread groups
constexpr int STREAM_SMEM = STAGES * (TILE_BYTES + XSLOT_BYTES) + RED_BYTES;
// N: rows of A per x vector read.  complex128 at KC = 8 takes one: two rows
// of 8 complex double sums are 64 registers, and with them the kernel needs
// 182 and leaves one CTA on an SM (complex128 flagship at k = 8: 8.9 ms with
// two rows, 6.2 ms with one).
template <typename S, int KC>
constexpr int ROWS_PER_READ = sizeof(S) == 16 && KC == 8 ? 1 : 2;

constexpr int CTAS_PER_SM = 2;  // what the kernels are compiled for: 128 registers a thread

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(BYTES)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The real scalar of S and the reals per scalar: results leave the kernels as
// reals, consecutive lanes on consecutive addresses, so that the k columns of
// an output row reach the L2 as one request per 32-byte sector.  One lane
// adding a row's k values one by one makes k requests, and at k = 8 the
// kernels were bound by the rate of those requests, not by bytes.
template <typename S> struct RealOf { using type = S; };
template <typename R> struct RealOf<cplx<R>> { using type = R; };

// real number idx of a[0 : KC] (a complex scalar is two reals), for idx that
// varies by lane: a chain of selects keeps a[] in registers
template <typename S, int KC>
__device__ __forceinline__ S real_at(const S (&a)[KC], int idx) {
  S v = a[0];
#pragma unroll
  for (int j = 1; j < KC; ++j)
    if (idx == j) v = a[j];
  return v;
}
template <typename R, int KC>
__device__ __forceinline__ R real_at(const cplx<R> (&a)[KC], int idx) {
  R v = a[0].re;
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    if (idx == 2 * j) v = a[j].re;
    if (idx == 2 * j + 1) v = a[j].im;
  }
  return v;
}

// How one launch walks its matrices; computed on the host (make_geom).
struct StreamGeom {
  int R, C;    // rows and columns of a block's matrix (row-major, lda = C)
  int P, cut;  // panels per block along the output dimension; rows (N) or columns (T) of one
  int tc;      // N: columns of a tile (C, or a CHUNK_BYTES chunk of a wide row)
  int nch;     // N: tiles per row group
  int tr;      // rows of a tile
  int srow;    // row stride of a tile in shared memory, in scalars
  int lw;      // N: lanes that share a row (a power of two)
  int cwt;     // T: threads across a slab (a power of two >= cut)
  int xfit;    // N: the whole x window of a panel fits one slot
  int vecA;    // A may be copied 16 bytes at a time
  int mma;     // the inner loop: 0 multiply-adds, else the FP64 tensor cores (mma_wanted)
  int kg;      // mma: warps that split the reduced dimension (their sums meet in shared memory)
};

// FP64 tensor-core loop: mma.sync m16n8k16, a warp holding the sums of
// MMA_M16_T m16 tiles (T: 16 reals across the slab each); N: of one m16 tile
// (16 rows)
constexpr int MMA_KS = 16;
constexpr int MMA_M16_T = 2;

// Which inner loop a launch runs: the FP64 tensor cores for float64 and
// complex128 at KC >= 4, except float64 applied transposed at KC = 4, and
// where a slab of a transposed matrix fits the warps' sums (complex128: 128
// columns); else multiply-adds.  m16n8k16 measured fastest of m16n8k4/8/16
// (m8n8k4, the sm_80 shape, was 1.1 - 8 times slower than multiply-adds);
// float64 transposed launches at KC = 4 lose 1 - 11 % on the tensor cores
// (tools/torch_kernel_probe.py --phases loop at the commit PERF.md section 6
// names).
template <typename S>
inline bool mma_wanted(bool trans, int KC, int tc) {
  using Real = typename RealOf<S>::type;
  constexpr int NC = sizeof(S) / sizeof(Real);
  if (sizeof(Real) != 8 || KC < 4) return false;
  if (!trans) return true;
  return !(NC == 1 && KC == 4) && (tc * NC + 15) / 16 <= MMA_M16_T * NWARP;
}

template <typename S>
inline int make_geom(StreamGeom& g, bool trans, int KC, int R, int C, int P, int cut,
                     const void* A) {
  constexpr int item = sizeof(S), per = 16 / item;
  constexpr int NC = item / sizeof(typename RealOf<S>::type);
  const int RW = item == 16 && KC == 8 ? 1 : 2;  // ROWS_PER_READ<S, KC>
  const int ext = trans ? C : R;
  if (R <= 0 || C <= 0 || P <= 0 || cut <= 0 || (long long)P * cut < ext ||
      (long long)(P - 1) * cut >= ext || (reinterpret_cast<uintptr_t>(A) % item) != 0)
    return (int)cudaErrorInvalidValue;
  g.R = R; g.C = C; g.P = P; g.cut = cut;
  g.vecA = (reinterpret_cast<uintptr_t>(A) % 16 == 0) && ((long long)C * item % 16 == 0) &&
           (!trans || P == 1 || (long long)cut * item % 16 == 0);
  g.mma = mma_wanted<S>(trans, KC, min(cut, C));
  g.kg = 1;
  const int xr = XSLOT_BYTES / (KC * item);  // x rows a slot holds
  if (!trans) {
    // few lanes per row (4 when the panel has rows enough for all sub-warps):
    // a tile is then many short row segments, and a sum crosses few lanes.
    // 32 lanes a row on 224-wide float32 blocks spent 0.6 of 1.03 ms in the
    // shuffles of the sums (PERF.md section 6).
    int lw = 4;
    while (lw > 1 && lw > C) lw >>= 1;
    while (lw < 32 && NWARP * (32 / lw) * RW > cut) lw <<= 1;
    int rp = NWARP * (32 / lw) * RW;  // rows of one pass of the CTA
    if (g.mma) {
      // m16 tiles of rows over mg warps, the row's reals over kg = 8 / mg
      // warps: few rows (stage A's rank rows) still give every warp work
      int mg = 1;
      while (mg < NWARP && mg * 16 < min(cut, R)) mg <<= 1;
      g.kg = NWARP / mg;
      rp = mg * 16;
    }
    const int tcb = min(TILE_BYTES / rp - 16, CHUNK_BYTES) / 16 * 16;
    g.tc = min(C, max(per, tcb / item));
    if (g.mma && g.tc < C)  // chunks of whole 16-real steps
      g.tc = max(16 / NC, g.tc / (16 / NC) * (16 / NC));
    g.nch = (C + g.tc - 1) / g.tc;
    g.srow = (g.tc + per - 1) / per * per + per;
    g.xfit = C <= xr;
    g.lw = lw;
    // a wide row's tile is one pass of the CTA (the sums stay in registers
    // across its chunks); a narrow row's tile is as many whole passes as fit
    const int maxrows = TILE_BYTES / (g.srow * item);
    g.tr = g.nch > 1 || maxrows < rp ? min(rp, maxrows) : maxrows / rp * rp;
    g.cwt = 0;
  } else {
    if (cut > NT) return (int)cudaErrorInvalidValue;
    g.tc = min(cut, C); g.nch = 1; g.lw = 0; g.xfit = 0;
    if (g.mma) {
      // rows 64 bytes apart modulo 128: the 4 rows x 64 bytes of an A
      // fragment fall on distinct banks
      const int unit = 128 / item, half = 64 / item;
      g.srow = half + (max(g.tc - half, 0) + unit - 1) / unit * unit;
      const int mtiles = (g.tc * NC + 15) / 16;  // m16 tiles across the slab
      int mg = 1;
      while (mg < mtiles && mg < NWARP) mg <<= 1;
      g.kg = NWARP / mg;
      g.cwt = 0;
      int tr = min(TILE_BYTES / (g.srow * item), xr);
      const int step = MMA_KS * g.kg;
      if (tr >= step) tr = tr / step * step;
      g.tr = tr;
    } else {
      g.srow = (g.tc + per - 1) / per * per + per;
      int cwt = 1;
      while (cwt < g.tc) cwt <<= 1;
      g.cwt = cwt;
      const int ng = NT / cwt;
      int tr = min(TILE_BYTES / (g.srow * item), xr);
      if (tr >= 4 * ng) tr = tr / (4 * ng) * (4 * ng);
      g.tr = tr;
    }
  }
  return g.tr >= 1 ? 0 : (int)cudaErrorInvalidValue;
}

// Call f(std::integral_constant<bool, MMA>) with the loop the geometry chose:
// the launch of kernel<..., MMA> (MMA only where it is compiled: f64 and
// complex128 at KC >= 4).
template <typename S, int KC, typename F>
inline int with_loop(const StreamGeom& g, F&& f) {
  if constexpr (sizeof(typename RealOf<S>::type) == 8 && KC >= 4)
    if (g.mma) return f(std::true_type{});
  return f(std::false_type{});
}

// Let a streaming kernel use STREAM_SMEM bytes of dynamic shared memory and
// ask for the largest shared-memory carve-out, so that two CTAs fit an SM.
// Does its work once per kernel instantiation; returns a cudaError_t.
template <auto kernel>
inline int configure_stream_kernel() {
  static bool configured = false;  // one per kernel
  if (configured) return 0;
  if (cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, STREAM_SMEM))
    return (int)err;
  if (cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared))
    return (int)err;
  configured = true;
  return 0;
}

// VW scalars of x as one vector of at most 16 bytes
template <typename S, int VW>
struct alignas(VW * sizeof(S)) XPack { S v[VW]; };

template <typename S, int KC>
struct XLayout {
  static constexpr int PER = 16 / sizeof(S);
  static constexpr int VW = KC < PER ? KC : PER;  // scalars per vector
  static constexpr int NQ = KC / VW;              // planes
  static constexpr int XR = XSLOT_BYTES / (KC * sizeof(S));  // rows of a slot
  // x[i, 0:KC] of a slot
  static __device__ __forceinline__ void load(const S* xs, int i, S (&xv)[KC]) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const XPack<S, VW> pk = *reinterpret_cast<const XPack<S, VW>*>(xs + (q * XR + i) * VW);
#pragma unroll
      for (int w = 0; w < VW; ++w) xv[q * VW + w] = pk.v[w];
    }
  }
  // stage rows [row0, row0 + n) x columns [j0, j0 + kc) of X [., ldx] into a slot
  static __device__ __forceinline__ void stage(S* xs, const S* X, long long row0, int n,
                                               int ldx, int j0, int kc) {
    const S* src = X + row0 * ldx + j0;
    const bool vec = kc == KC && ldx % VW == 0 &&
                     (reinterpret_cast<uintptr_t>(src) % (VW * sizeof(S))) == 0;
    if (vec) {
      for (int e = threadIdx.x; e < n * NQ; e += NT) {
        const int i = e / NQ, q = e % NQ;
        cp_async<VW * sizeof(S)>(xs + (q * XR + i) * VW, src + (size_t)i * ldx + q * VW);
      }
    } else {
      for (int e = threadIdx.x; e < n * kc; e += NT) {
        const int i = e / kc, j = e % kc;
        cp_async<sizeof(S)>(xs + ((j / VW) * XR + i) * VW + j % VW, src + (size_t)i * ldx + j);
      }
    }
  }
};

// FP64 tensor cores: D [16 x 8] += A [16 x 16] · B [16 x 8] for a warp, in
// IEEE double multiply-adds (mma.sync m16n8k16).  Lane 4 g + t holds a[i] =
// A[g + 8 (i % 2)][t + 4 (i / 2)], b[i] = B[t + 4 i][g], and d = D[g][2t],
// D[g][2t + 1], D[g + 8][2t], D[g + 8][2t + 1].
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[8],
                                        const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
        "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// B fragment of n-tile nt for op N: B[kr][n], n = nt * 8 + g, from x rows
// xrow0 + .. of a slot.  float64: x[kr][n].  complex128: the tile row is read
// as 2C reals (ar, ai, ..), and B is the real 2C x 2KC matrix of x, rows
// [xr, xi] for ar and [-xi, xr] for ai (signs flipped by conj), so D comes
// out as (re, im) pairs.  Zero past the tile's columns (kv false) and past KC.
template <typename S, int KC>
__device__ __forceinline__ double frag_b_n(const S* xs, int xrow0, int kr, bool kv, int nt,
                                           int g, int cj) {
  using XL = XLayout<S, KC>;
  if constexpr (std::is_same<S, double>::value) {
    const int j = nt * 8 + g;
    if (!kv || j >= KC) return 0.0;
    return xs[((j / XL::VW) * XL::XR + xrow0 + kr) * XL::VW + j % XL::VW];
  } else {
    const int j = nt * 4 + (g >> 1);
    if (!kv || j >= KC) return 0.0;
    // one real of x[kr / 2][j]: p = 0 (ar's row) takes xr for q = 0 and xi
    // for q = 1; p = 1 (ai's row) takes -xi and xr, conj flipping the sign
    const int p = kr & 1, q = g & 1;
    const double v = reinterpret_cast<const double*>(xs + j * XL::XR + xrow0 + (kr >> 1))[p ^ q];
    return p && (q == 0) != (cj != 0) ? -v : v;
  }
}

// B fragment of n-tile nt for op T: x row kr of the slot; complex128: column
// j = nt * 4 + g / 2, its real part for even g, its imaginary part for odd g.
template <typename S, int KC>
__device__ __forceinline__ double frag_b_t(const S* xs, int kr, bool kv, int nt, int g) {
  using XL = XLayout<S, KC>;
  if constexpr (std::is_same<S, double>::value) {
    const int j = nt * 8 + g;
    if (!kv || j >= KC) return 0.0;
    return xs[((j / XL::VW) * XL::XR + kr) * XL::VW + j % XL::VW];
  } else {
    const int j = nt * 4 + (g >> 1);
    if (!kv || j >= KC) return 0.0;
    return reinterpret_cast<const double*>(xs + j * XL::XR + kr)[g & 1];
  }
}

// copy rows [0, nr) x columns [0, nc) of a row-major matrix at src (leading
// dimension lda) into a tile with row stride srow
template <typename S>
__device__ __forceinline__ void stage_tile(S* tile, int srow, const S* src, int lda, int nr,
                                           int nc, int vec) {
  constexpr int PER = 16 / sizeof(S);
  if (vec) {
    const int nu = (nc + PER - 1) / PER;  // 16-byte units per row (nc * item % 16 == 0)
    for (int e = threadIdx.x; e < nr * nu; e += NT) {
      const int i = e / nu, u = e % nu;
      cp_async<16>(tile + (size_t)i * srow + u * PER, src + (size_t)i * lda + u * PER);
    }
  } else {
    for (int e = threadIdx.x; e < nr * nc; e += NT) {
      const int i = e / nc, c = e % nc;
      cp_async<sizeof(S)>(tile + (size_t)i * srow + c, src + (size_t)i * lda + c);
    }
  }
}

// Where the walk stands: slot s of the CTA, the tile inside the slot's panel.
struct Cursor {
  int s;            // slot
  int b;            // block of the slot
  int lo, hi;       // the panel: rows (N) or columns (T) [lo, hi) of the block's matrix
  int row;          // first row of the tile
  int ch;           // N: chunk of the row group
  int xn;           // slots entered so far (the slot's x entry when xfit)
  long long io, oo; // first x row of the block's window; first output row of the panel
  bool done;
};

constexpr int MAX_SLOTS = 32;  // slots of one CTA at most (G of the host's cut)

// The CTA's slots, read once by MAX_SLOTS threads in parallel before the walk
// starts: one round trip to device memory for all of them instead of two
// dependent ones per slot, which cost more than streaming a 14 KB block.
struct SlotTable {
  int v[MAX_SLOTS];         // b * P + p, or -1
  long long io[MAX_SLOTS];  // first x row of the block's input window
  long long oo[MAX_SLOTS];  // first output row of the panel
};

// Addr gives: slot(s) -> b * P + p or -1; in(s, b) -> first x row of block
// b's input window; out(s, b, lo) -> output row of index lo of the block's
// output window; check(...) traps on windows out of range.
template <typename Addr>
__device__ __forceinline__ void load_slots(SlotTable& tab, const StreamGeom& g, const Addr& addr,
                                           int s_begin, int s_end) {
  const int i = threadIdx.x;
  if (i < MAX_SLOTS && s_begin + i < s_end) {
    const int s = s_begin + i, v = addr.slot(s);
    tab.v[i] = v;
    if (v >= 0) {
      tab.io[i] = addr.in(s, v / g.P);
      tab.oo[i] = addr.out(s, v / g.P, (v % g.P) * g.cut);
    }
  }
  __syncthreads();
}

template <bool TRANS, typename Addr>
__device__ __forceinline__ void enter_slot(Cursor& c, const StreamGeom& g, const Addr& addr,
                                           const SlotTable& tab, int s_begin, int s_end) {
  while (c.s < s_end) {
    const int v = tab.v[c.s - s_begin];
    if (v >= 0) {
      c.b = v / g.P;
      c.lo = (v % g.P) * g.cut;
      c.hi = min(c.lo + g.cut, TRANS ? g.C : g.R);
      c.row = TRANS ? 0 : c.lo;
      c.ch = 0;
      c.xn += 1;
      c.io = tab.io[c.s - s_begin];
      c.oo = tab.oo[c.s - s_begin];
      addr.check(c.io, TRANS ? g.R : g.C, c.oo, c.hi - c.lo);
      return;
    }
    ++c.s;
  }
  c.done = true;
}

template <bool TRANS, typename Addr>
__device__ __forceinline__ void advance(Cursor& c, const StreamGeom& g, const Addr& addr,
                                        const SlotTable& tab, int s_begin, int s_end) {
  if (!TRANS) {
    if (++c.ch < g.nch) return;
    c.ch = 0;
    c.row += g.tr;
    if (c.row < c.hi) return;
  } else {
    c.row += g.tr;
    if (c.row < g.R) return;
  }
  ++c.s;
  enter_slot<TRANS>(c, g, addr, tab, s_begin, s_end);
}

// Stream the slots [s_begin, s_end) of one CTA (at most MAX_SLOTS).  X [., ldx] and Y [., ldy]
// are row-major; the CTA handles columns [j0, j0 + kc), kc <= KC.  smem is
// STREAM_SMEM bytes, 16-byte aligned.
template <typename S, int KC, bool TRANS, bool MMA, typename Addr>
__device__ void stream_run(const StreamGeom& g, const S* __restrict__ A, int cj, int store,
                           const Addr& addr, int s_begin, int s_end,
                           const S* __restrict__ X, int ldx, S* Y, int ldy, int j0, int kc,
                           unsigned char* smem) {
  using XL = XLayout<S, KC>;
  constexpr int RW = ROWS_PER_READ<S, KC>;
  using Real = typename RealOf<S>::type;
  constexpr int NC = sizeof(S) / sizeof(Real);  // reals per scalar
  S* tiles = reinterpret_cast<S*>(smem);
  S* xslots = reinterpret_cast<S*>(smem + STAGES * TILE_BYTES);
  S* red = reinterpret_cast<S*>(smem + STAGES * (TILE_BYTES + XSLOT_BYTES));
  constexpr int TILE_S = TILE_BYTES / sizeof(S), XSLOT_S = XSLOT_BYTES / sizeof(S);
  const size_t blk_stride = (size_t)g.R * g.C;

  auto fetch = [&](const Cursor& c, int st) {
    S* tile = tiles + st * TILE_S;
    const S* Ab = A + c.b * blk_stride;
    if (!TRANS) {
      const int nr = min(g.tr, c.hi - c.row);
      const int c0 = c.ch * g.tc, nc = min(g.tc, g.C - c0);
      stage_tile<S>(tile, g.srow, Ab + (size_t)c.row * g.C + c0, g.C, nr, nc, g.vecA);
      if (g.xfit) {
        if (c.row == c.lo && c.ch == 0)
          XL::stage(xslots + (c.xn % STAGES) * XSLOT_S, X, c.io, g.C, ldx, j0, kc);
      } else {
        XL::stage(xslots + st * XSLOT_S, X, c.io + c0, nc, ldx, j0, kc);
      }
    } else {
      const int nr = min(g.tr, g.R - c.row);
      stage_tile<S>(tile, g.srow, Ab + (size_t)c.row * g.C + c.lo, g.C, nr, c.hi - c.lo,
                    g.vecA);
      XL::stage(xslots + st * XSLOT_S, X, c.io + c.row, nr, ldx, j0, kc);
    }
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // N: a sub-warp of lw lanes owns RW rows of a pass, lanes stride over columns
  const int lw = TRANS ? 1 : g.lw, sub_n = 32 / lw;
  const int sl = lane % lw, wsub = warp * sub_n + lane / lw;
  const int rpq = NWARP * sub_n;  // rows of a pass per q
  // T: cwt threads across the slab, NT / cwt groups down the rows
  const int cwt = TRANS && !MMA ? g.cwt : 1;
  const int cl = threadIdx.x % cwt, grp = threadIdx.x / cwt, ng = NT / cwt;

  S acc[RW][KC];  // T uses acc[0]
  // the tensor-core loop's sums: D fragments [m16 tile][n-tile] (N: one m16 tile)
  constexpr int NTL = (KC * NC + 7) / 8;  // n-tiles of 8 reals across the k columns
  constexpr int KS = MMA_KS, KQ = KS / 4;  // K of an mma step; of it per lane
  double macc[MMA ? MMA_M16_T : 1][MMA ? NTL : 1][4];
  const int g8 = lane >> 2, t4 = lane & 3;  // the lane's place in an mma fragment
  // mma: warp w takes k-group w % kg and row (N) or reals (T) group w / kg
  const int kg = MMA ? g.kg : 1, mg = NWARP / kg;
  const int kgi = warp % kg, mgi = warp / kg;

  __shared__ SlotTable tab;
  load_slots(tab, g, addr, s_begin, s_end);
  Cursor prod;
  prod.s = s_begin; prod.xn = -1; prod.done = false;
  enter_slot<TRANS>(prod, g, addr, tab, s_begin, s_end);
  Cursor cons = prod;
  for (int i = 0; i < STAGES - 1; ++i) {
    if (!prod.done) {
      fetch(prod, i);
      advance<TRANS>(prod, g, addr, tab, s_begin, s_end);
    }
    cp_async_commit();
  }
  for (int t = 0; !cons.done; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (!prod.done) {
      fetch(prod, (t + STAGES - 1) % STAGES);
      advance<TRANS>(prod, g, addr, tab, s_begin, s_end);
    }
    cp_async_commit();

    const int st = t % STAGES;
    const S* tile = tiles + st * TILE_S;
    if constexpr (!TRANS) {
      const int nr = min(g.tr, cons.hi - cons.row);
      const int c0 = cons.ch * g.tc, nc = min(g.tc, g.C - c0);
      const S* xs = xslots + (g.xfit ? cons.xn % STAGES : st) * XSLOT_S;
      const int xi0 = g.xfit ? c0 : 0;
      if constexpr (MMA) {
        // M = rows (warp group mgi: an m16 tile of the pass), K = the tile
        // row's reals (k-group kgi: steps kgi, kgi + kg, ..), N = the k
        // columns, as (re, im) pairs for complex128
        const Real* tr_ = reinterpret_cast<const Real*>(tile);
        const int srr = g.srow * NC, kn = nc * NC, rp = mg * 16;
        double* redd = reinterpret_cast<double*>(red);
        for (int pass0 = 0; pass0 < nr; pass0 += rp) {
          const int rb = pass0 + mgi * 16;
          if (cons.ch == 0) {
#pragma unroll
            for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) macc[0][nt][e] = 0.0;
          }
          if (rb < nr) {  // the whole warp
            const Real* a0 = tr_ + (size_t)min(rb + g8, nr - 1) * srr;
            const Real* a1 = tr_ + (size_t)min(rb + 8 + g8, nr - 1) * srr;
#pragma unroll 2
            for (int kk = KS * kgi; kk < kn; kk += KS * kg) {
              double af[2 * KQ], bf[NTL][KQ];
#pragma unroll
              for (int q = 0; q < KQ; ++q) {
                const int kr = kk + t4 + 4 * q;
                const bool kv = kr < kn;
                af[2 * q] = kv ? a0[kr] : 0.0;
                af[2 * q + 1] = kv ? a1[kr] : 0.0;
#pragma unroll
                for (int nt = 0; nt < NTL; ++nt)
                  bf[nt][q] = frag_b_n<S, KC>(xs, xi0, kr, kv, nt, g8, cj);
              }
#pragma unroll
              for (int nt = 0; nt < NTL; ++nt) mma_f64(macc[0][nt], af, bf[nt]);
            }
          }
          if (cons.ch == g.nch - 1) {
            // the k-groups' sums meet in shared memory, one n-tile (8 reals
            // a row) a round; consecutive threads then add consecutive reals
            // of a row into y
#pragma unroll
            for (int nt = 0; nt < NTL; ++nt) {
#pragma unroll
              for (int e = 0; e < 4; ++e)
                redd[(kgi * rp + mgi * 16 + g8 + 8 * (e >> 1)) * 8 + 2 * t4 + (e & 1)] =
                    macc[0][nt][e];
              __syncthreads();
              for (int e = threadIdx.x; e < rp * 8; e += NT) {
                const int r = e >> 3, idx = nt * 8 + (e & 7);
                if (pass0 + r < nr && idx < kc * NC) {
                  double sum = 0.0;
                  for (int gg = 0; gg < kg; ++gg) sum += redd[(gg * rp + r) * 8 + (e & 7)];
                  Real* o = reinterpret_cast<Real*>(
                      Y + (size_t)(cons.oo + (cons.row - cons.lo) + pass0 + r) * ldy + j0);
                  if (store) o[idx] = sum;
                  else atomicAdd(o + idx, sum);
                }
              }
              __syncthreads();
            }
          }
        }
      } else {
        for (int pass0 = 0; pass0 < nr; pass0 += rpq * RW) {
          if (cons.ch == 0) {
#pragma unroll
            for (int q = 0; q < RW; ++q)
#pragma unroll
              for (int j = 0; j < KC; ++j) acc[q][j] = S(0);
          }
          int rq[RW];
#pragma unroll
          for (int q = 0; q < RW; ++q) rq[q] = pass0 + q * rpq + wsub;
          const S* ap[RW];
#pragma unroll
          for (int q = 0; q < RW; ++q) ap[q] = tile + (size_t)min(rq[q], nr - 1) * g.srow;
#pragma unroll 2
          for (int c = sl; c < nc; c += lw) {
            S xv[KC];
            XL::load(xs, xi0 + c, xv);
#pragma unroll
            for (int q = 0; q < RW; ++q) {
              const S av = conj_if(ap[q][c], cj);
#pragma unroll
              for (int j = 0; j < KC; ++j) mul_add(acc[q][j], av, xv[j]);
            }
          }
          if (cons.ch == g.nch - 1) {
            // butterfly over the sub-warp's lanes: they all end with the sums,
            // and lane sl writes the reals sl, sl + lw, .. of each row, so that
            // consecutive lanes write consecutive addresses
#pragma unroll
            for (int q = 0; q < RW; ++q)
#pragma unroll
              for (int j = 0; j < KC; ++j)
                for (int off = lw >> 1; off > 0; off >>= 1)
                  acc[q][j] += shfl_xor(acc[q][j], off);
#pragma unroll
            for (int q = 0; q < RW; ++q)
              if (rq[q] < nr) {
                Real* o = reinterpret_cast<Real*>(
                    Y + (size_t)(cons.oo + (cons.row - cons.lo) + rq[q]) * ldy + j0);
                for (int idx = sl; idx < kc * NC; idx += lw) {
                  const Real v = real_at(acc[q], idx);
                  if (store) o[idx] = v;
                  else atomicAdd(o + idx, v);
                }
              }
          }
        }
      }
    } else {
      const int nr = min(g.tr, g.R - cons.row);
      const int cw = cons.hi - cons.lo;
      const S* xs = xslots + st * XSLOT_S;
      if (cons.row == 0) {
        if constexpr (MMA) {
#pragma unroll
          for (int i = 0; i < MMA_M16_T; ++i)
#pragma unroll
            for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) macc[i][nt][e] = 0.0;
        } else {
#pragma unroll
          for (int j = 0; j < KC; ++j) acc[0][j] = S(0);
        }
      }
      if constexpr (MMA) {
        // M = the slab's reals (warp group mgi: m16 tiles mgi, mgi + mg), K =
        // the tile's rows (k-group kgi), N = the k columns (complex128: x's
        // re and im parts)
        const Real* tr_ = reinterpret_cast<const Real*>(tile);
        const int srr = g.srow * NC, mreal = cw * NC;
#pragma unroll 2
        for (int kk = KS * kgi; kk < nr; kk += KS * kg) {
          int kr[KQ];
          bool kv[KQ];
          double bf[NTL][KQ];
#pragma unroll
          for (int q = 0; q < KQ; ++q) {
            kr[q] = kk + t4 + 4 * q;
            kv[q] = kr[q] < nr;
#pragma unroll
            for (int nt = 0; nt < NTL; ++nt) bf[nt][q] = frag_b_t<S, KC>(xs, kr[q], kv[q], nt, g8);
          }
#pragma unroll
          for (int i = 0; i < MMA_M16_T; ++i) {
            const int m0 = (mgi + i * mg) * 16;
            if (m0 >= mreal) continue;  // the whole warp
            double af[2 * KQ];
#pragma unroll
            for (int q = 0; q < KQ; ++q)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int m = m0 + 8 * h + g8;
                af[2 * q + h] = kv[q] && m < mreal ? tr_[(size_t)kr[q] * srr + m] : 0.0;
              }
#pragma unroll
            for (int nt = 0; nt < NTL; ++nt) mma_f64(macc[i][nt], af, bf[nt]);
          }
        }
      } else if (cl < cw) {
#pragma unroll 4
        for (int i = grp; i < nr; i += ng) {
          const S av = conj_if(tile[(size_t)i * g.srow + cl], cj);
          S xv[KC];
          XL::load(xs, i, xv);
#pragma unroll
          for (int j = 0; j < KC; ++j) mul_add(acc[0][j], av, xv[j]);
        }
      }
      if (cons.row + g.tr >= g.R) {  // last tile of the slab: reduce the groups, write
        // through shared memory, JR columns a round, so that consecutive
        // lanes write consecutive reals of y
        Real* o = reinterpret_cast<Real*>(Y + (size_t)cons.oo * ldy + j0);
        const Real* redr = reinterpret_cast<const Real*>(red);
        constexpr int JR_MAX = RED_BYTES / (NT * (int)sizeof(S));
        constexpr int JR = JR_MAX < KC ? JR_MAX : KC;  // columns per round
        // partial sums of column cc of group gg at red[(gg * stride + cc) * JR]
        const int ngr = MMA ? kg : ng, stride = MMA ? cw : cwt;
        if constexpr (MMA && NC == 2) {
          // lane 4 g + t holds (Ar xr, Ar xi) for even g and (Ai xr, Ai xi) for
          // odd g, of column g / 2 of the m-tile's half and k column t of the
          // n-tile: lanes take their partner's (lane ^ 4) and the even ones
          // form re and im (conj: Ai -> -Ai)
#pragma unroll
          for (int i = 0; i < MMA_M16_T; ++i)
#pragma unroll
            for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const double p0 = shfl_xor(macc[i][nt][2 * h], 4);
                const double p1 = shfl_xor(macc[i][nt][2 * h + 1], 4);
                macc[i][nt][2 * h] += cj ? p1 : -p1;
                macc[i][nt][2 * h + 1] += cj ? -p0 : p0;
              }
        }
#pragma unroll
        for (int jb = 0; jb < KC; jb += JR) {
          if constexpr (MMA) {
#pragma unroll
            for (int i = 0; i < MMA_M16_T; ++i)
#pragma unroll
              for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int m = (mgi + i * mg) * 16 + 8 * h + g8;
                  if constexpr (NC == 1) {
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                      const int j = nt * 8 + 2 * t4 + e;
                      if (m < cw && j >= jb && j < jb + JR)
                        red[(kgi * cw + m) * JR + j - jb] = S(macc[i][nt][2 * h + e]);
                    }
                  } else {
                    const int j = nt * 4 + t4;
                    if (!(g8 & 1) && (m >> 1) < cw && j >= jb && j < jb + JR)
                      red[(kgi * cw + (m >> 1)) * JR + j - jb] =
                          S(macc[i][nt][2 * h], macc[i][nt][2 * h + 1]);
                  }
                }
          } else {
#pragma unroll
            for (int jj = 0; jj < JR; ++jj) red[(grp * cwt + cl) * JR + jj] = acc[0][jb + jj];
          }
          __syncthreads();
          const int nreal = min(JR, kc - jb) * NC;  // reals to write per output row
          for (int e = threadIdx.x; e < cw * JR * NC; e += NT) {
            const int cc = e / (JR * NC), w = e % (JR * NC);
            if (w < nreal) {
              Real sum = Real(0);
              for (int gg = 0; gg < ngr; ++gg) sum += redr[((gg * stride + cc) * JR) * NC + w];
              Real* dst = o + ((size_t)cc * ldy + jb) * NC + w;
              if (store) *dst = sum;
              else atomicAdd(dst, sum);
            }
          }
          __syncthreads();
        }
      }
    }
    advance<TRANS>(cons, g, addr, tab, s_begin, s_end);
  }
  cp_async_wait<0>();
}

}  // namespace htool_mv
