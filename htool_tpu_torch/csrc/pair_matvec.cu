// Pair pass of the symmetric product for NVIDIA Hopper (sm_90a).
//
// Replaces, for every mirror bucket of a global planned 'S' or 'H' operator,
// the stored and the mirror term of htool_tpu/ops/tiled_matvec.py::
// _tiled_kernel (the port's stream_matvec.cu: one launch a dense term) and
// of its split route build_tile_plan_lr_split (two launches a low-rank
// term).  Symmetric storage keeps one block A of each mirrored pair, at
// (t, s), and the product applies it twice:
//
//   y[t :] += g1(A) x[s :]          y[s :] += g2(A)ᵀ x[t :]
//
// with g1, g2 the identity or conj, as linalg._bucket_terms gives them for
// the op and the symmetry.  One launch here applies both for every block of
// the bucket, fetching each live coefficient once:
//
// - a dense bucket: an item is a row panel of a block (a tile that fits a
//   buffer); the CTA stages it, x's window at s and x's rows at t in shared
//   memory, and takes the row sums (into y at t) and the column sums (into
//   y at s) from the same staged tile.  Both are added with atomics; the
//   column sums of a panel meet the other panels' in y.
// - a low-rank bucket A = U V: an item is a whole block.  The rank pass
//   takes t = g1(V) x[s :] and t' = g2(U)ᵀ x[t :] from the staged factors,
//   the expansion pass adds g1(U) t at t and g2(V)ᵀ t' at s from the same
//   staged factors.  A block too large for one CTA's shared memory is spread
//   over a thread-block cluster of cs <= 8 CTAs: CTA q holds rows [q mr,
//   (q + 1) mr) of U and columns [q mc, (q + 1) mc) of V, its partial t and
//   t' (r-long each) are summed through distributed shared memory after a
//   cluster barrier, and each CTA then expands its own rows and columns.
//
// The bound: each live coefficient is read once for 4·k (real) or 16·k
// (complex) flops, so device memory bandwidth bounds the pass, as it bounds
// the per-term walks (matvec_stream.cuh), which read each coefficient twice.
// At k = 1 the per-term walks are paced by the latency of their steps (a
// CTA's entry, a slot's entry, a tile's copies; PERF.md section 6): the pair
// pass halves the steps as it halves the bytes, since each staged tile and
// each entered item serves two outputs.  What the design does about the
// rest:
//
// - Items are grouped G to a CTA by bytes on the host (ops/pair_matvec.py),
//   so every CTA streams about the same bytes, and their rows (block, rows,
//   offsets, live extent) are read once, in parallel, before the walk.
// - One buffer an item (cp.async, 16 bytes a copy where the rows allow), and
//   the smallest cluster that lets two CTAs share an SM at the launch's k:
//   measured on the H100, CTAs resident beside each other hide the walk's
//   latency better than a second buffer of a CTA's own, which halves them,
//   and every CTA of a cluster waits at its barrier each item
//   (ops/pair_matvec.py, _pick).
// - Each item is read at its live extent (true rows, columns and rank):
//   nothing past it is copied but the tail of a 16-byte unit, and no sum
//   reads that tail.
// - Row sums take as few lanes a row as its live width needs (16-byte reads
//   at k = 1), so that a sum crosses few shuffle steps; column sums take a
//   thread a column and split the rows over groups whose sums meet in shared
//   memory.  Accumulation is in the product's own type (no TF32, no
//   bfloat16), as in the per-term walks.
//
// Measured on an H100 80GB HBM3 at 700 W (the benchmark's operator,
// n = 100,000, 'S'; tools/torch_term_probe.py, PERF.md section 5): a
// float32 product at k = 1 0.42 ms against 0.77 - 0.93 ms with the per-term
// walks, every mirror bucket faster as a pair (the 1568-wide low-rank bucket
// 146 against 272 us, the dense one 73 against 154 us); a complex64 product
// at k = 8 2.17 ms against 2.47 ms, where only the 1568-wide bucket is
// slower as a pair (1,002 against 913 us: a cluster of 8 CTAs, which its
// factors and x's eight columns need), which the product's sum outweighs.
// So the pass takes every bucket it fits, whatever the dtype and k.  Where
// it does not fit, the bucket keeps the per-term path (stream_matvec.cu):
// a low-rank bucket whose live factors at k = 8 do not fit a cluster of 8
// CTAs (ops/pair_matvec.py, _pick: the hermitian kernel probe's ranks up to
// 282, or rank 96 on 6272-row blocks), and a dense bucket whose live rows
// are too wide for a tile of 4 rows (complex128 rows of 1568).  So does a
// pair plan cast to a wider dtype of x that no layout fits (PairPlan.astype
// gives None): its two terms then run the unplanned kernels.

#include <cooperative_groups.h>

#include "matvec_stream.cuh"

namespace {

using namespace htool_mv;
namespace cg = cooperative_groups;

constexpr int PAIR_ITEMS = 32;  // items of one CTA at most (G)
constexpr int ITEM_INTS = 8;    // an item: block, lo, hi, t_off, s_off, cols, rank, unused
constexpr int PAIR_SMEM_MAX = 225 * 1024;  // dynamic shared memory a CTA: 227 KB less the static
constexpr int CLUSTER_MAX = 8;

// The launch's geometry, from the host (ops/pair_matvec.py::_geometry);
// sizes and offsets in scalars.
struct PairGeom {
  int R, C, r;         // stored: dense blocks [R, C]; low rank U [R, r], V [r, C]
  int cs, G, n_items;  // CTAs a cluster (low rank); items a CTA walks; items
  int mr, mc;          // rows (tile, U) and columns (tile, V) of a piece at most
  int sa, sv;          // row strides in shared memory: the tile or U; V
  int xrt, xrs, xrr;   // rows of a plane of x at t, of x at s, of the rank vectors
  int offV, offXt, offXs, buf;    // within the item's buffer: V, x at t, x at s; its size
  int offPart, offFull, offRed;   // after it: partial (two) and summed rank vectors, sums
  int vecA, vecV;      // the tile or U, and V, may be copied 16 bytes at a time
  int smem;            // dynamic shared memory, bytes
  int KC;              // the column chunk the layout is made for (the launch's, from k)
};
constexpr int GEOM_INTS = sizeof(PairGeom) / sizeof(int);

// x's rows as planes of VW-scalar vectors [KC / VW][xr][VW] (the layout of
// matvec_stream.cuh's x slots, with the plane's rows given at run time):
// lanes on consecutive rows read consecutive vectors
template <typename S, int KC>
struct XView {
  static constexpr int PER = 16 / sizeof(S);
  static constexpr int VW = KC < PER ? KC : PER;
  static constexpr int NQ = KC / VW;
  const S* p;
  int xr;
  __device__ __forceinline__ void load(int i, S (&xv)[KC]) const {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const XPack<S, VW> pk = *reinterpret_cast<const XPack<S, VW>*>(p + (q * xr + i) * VW);
#pragma unroll
      for (int w = 0; w < VW; ++w) xv[q * VW + w] = pk.v[w];
    }
  }
};

// copy rows [row0, row0 + n) x columns [j0, j0 + kc) of X [., ldx] into planes
template <typename S, int KC>
__device__ __forceinline__ void stage_x(S* xs, int xr, const S* X, long long row0, int n,
                                        int ldx, int j0, int kc) {
  using XV = XView<S, KC>;
  constexpr int VW = XV::VW, NQ = XV::NQ;
  const S* src = X + row0 * ldx + j0;
  const bool vec = kc == KC && ldx % VW == 0 &&
                   (reinterpret_cast<uintptr_t>(src) % (VW * sizeof(S))) == 0;
  if (vec) {
    for (int e = threadIdx.x; e < n * NQ; e += NT) {
      const int i = e / NQ, q = e % NQ;
      cp_async<VW * sizeof(S)>(xs + (q * xr + i) * VW, src + (size_t)i * ldx + q * VW);
    }
  } else {
    for (int e = threadIdx.x; e < n * kc; e += NT) {
      const int i = e / kc, j = e % kc;
      cp_async<sizeof(S)>(xs + ((j / VW) * xr + i) * VW + j % VW, src + (size_t)i * ldx + j);
    }
  }
}

// Where sums go: ToY adds real idx of row i at rows off + i of y (atomics);
// ToPlanes stores it at row i of a plane layout in shared memory.
template <typename S>
struct ToY {
  using Real = typename RealOf<S>::type;
  Real* y;        // y's reals at the CTA's first column
  long long off;  // y's row of index 0
  long long ld;   // reals a row of y
  __device__ __forceinline__ void put(int i, int idx, Real v) const {
    atomicAdd(y + (off + i) * ld + idx, v);
  }
};
template <typename S, int KC>
struct ToPlanes {
  using Real = typename RealOf<S>::type;
  static constexpr int NC = sizeof(S) / sizeof(Real), VW = XView<S, KC>::VW;
  S* p;
  int xr;
  __device__ __forceinline__ void put(int i, int idx, Real v) const {
    const int kk = idx / NC;
    reinterpret_cast<Real*>(p + ((kk / VW) * xr + i) * VW + kk % VW)[idx % NC] = v;
  }
};

// Row sums: for rows i < nr of A (shared memory, row stride sa), the reals
// of sum_{c < nc} g(A[i][c]) x[c][0 : kc] go to out.put(i, .).  A sub-warp of
// lw lanes takes a row, lanes strided over its columns (k = 1: over 16-byte
// units, two a lane where the row has them; k > 1: 16 columns a lane, since
// each shuffle step then moves KC sums), its sum crossing log2(lw) shuffle
// steps; lw widens where the rows are few so that every lane works.
template <typename S, int KC, typename Out>
__device__ __forceinline__ void row_sums(const S* A, int sa, int nr, int nc, int cj,
                                         const XView<S, KC>& x, int kc, S* red, const Out& out) {
  using Real = typename RealOf<S>::type;
  constexpr int NC = sizeof(S) / sizeof(Real), PER = 16 / sizeof(S);
  const int nu = KC == 1 ? (nc + PER - 1) / PER : nc;
  constexpr int PER_LANE = KC == 1 ? 2 : 16;
  int lw = 1;
  while (lw < 32 && (PER_LANE * lw < nu || (NT / lw) > 2 * nr)) lw <<= 1;
  const int lane = threadIdx.x & 31, sl = lane & (lw - 1);
  const int sub = (threadIdx.x >> 5) * (32 / lw) + lane / lw, nsub = NT / lw;
  for (int i0 = 0; i0 < nr; i0 += nsub) {  // the same count on every lane: shuffles are safe
    const int i = i0 + sub;
    const S* a = A + (size_t)min(i, nr - 1) * sa;
    S acc[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j) acc[j] = S(0);
    if constexpr (KC == 1) {
      // 16 bytes of the row and of x a read; entries of a unit past the
      // live columns (a copied tail, or an earlier item's) are left out
      for (int u = sl; u < nu; u += lw) {
        S xv[PER], av[PER];
        Vec16<S>::load(x.p + u * PER, xv);
        Vec16<S>::load(a + u * PER, av);
        const int rem = nc - u * PER;
#pragma unroll
        for (int e = 0; e < PER; ++e)
          if (e < rem) mul_add(acc[0], conj_if(av[e], cj), xv[e]);
      }
    } else {
      for (int c = sl; c < nc; c += lw) {
        S xv[KC];
        x.load(c, xv);
        const S av = conj_if(a[c], cj);
#pragma unroll
        for (int j = 0; j < KC; ++j) mul_add(acc[j], av, xv[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < KC; ++j)
      for (int off = lw >> 1; off > 0; off >>= 1) acc[j] += shfl_xor(acc[j], off);
    if (KC == 1) {
      if (i < nr)
        for (int idx = sl; idx < kc * NC; idx += lw) out.put(i, idx, real_at(acc, idx));
    } else {
      // k > 1: the pass's sums meet in red, and consecutive threads write
      // consecutive reals (a lane writing its row's reals one by one makes a
      // request per real)
      if (sl == 0)
#pragma unroll
        for (int j = 0; j < KC; ++j) red[sub * KC + j] = acc[j];
      __syncthreads();
      const int w = kc * NC, rows = min(nsub, nr - i0);
      for (int e = threadIdx.x; e < rows * w; e += NT) {
        const int r = e / w, idx = e % w;
        out.put(i0 + r, idx, reinterpret_cast<const Real*>(red + r * KC)[idx]);
      }
      __syncthreads();
    }
  }
}

// Column sums: for columns c < nc of A, the reals of sum_{i < nr} g(A[i][c])
// x[i][0 : kc] go to out.put(c, .).  cw threads across the columns (a
// power of two, at most NT), ng groups of them down the rows (at least about
// 4 rows a group); the groups' sums meet in red (NT * KC scalars), from
// which consecutive threads write consecutive reals (at k = 1 one group
// writes its sums itself: consecutive threads hold consecutive columns).
template <typename S, int KC, typename Out>
__device__ __forceinline__ void col_sums(const S* A, int sa, int nr, int nc, int cj,
                                         const XView<S, KC>& x, int kc, S* red, const Out& out) {
  using Real = typename RealOf<S>::type;
  constexpr int NC = sizeof(S) / sizeof(Real);
  int cw = 1;
  while (cw < nc && cw < NT) cw <<= 1;
  int ng = NT / cw;
  while (ng > 1 && 4 * ng > nr) ng >>= 1;
  const int cl = threadIdx.x & (cw - 1), grp = threadIdx.x / cw;
  const int w = kc * NC;
  for (int c0 = 0; c0 < nc; c0 += cw) {
    const int c = c0 + cl;
    S acc[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j) acc[j] = S(0);
    if (c < nc && grp < ng) {
#pragma unroll 4
      for (int i = grp; i < nr; i += ng) {
        S xv[KC];
        x.load(i, xv);
        const S av = conj_if(A[(size_t)i * sa + c], cj);
#pragma unroll
        for (int j = 0; j < KC; ++j) mul_add(acc[j], av, xv[j]);
      }
    }
    if (KC == 1 && ng == 1) {
      if (c < nc && grp == 0)
        for (int idx = 0; idx < w; ++idx) out.put(c, idx, real_at(acc, idx));
    } else {
      if (grp < ng)
#pragma unroll
        for (int j = 0; j < KC; ++j) red[(grp * cw + cl) * KC + j] = acc[j];
      __syncthreads();
      const int ncc = min(cw, nc - c0);
      for (int e = threadIdx.x; e < ncc * w; e += NT) {
        const int cc = e / w, idx = e % w;
        Real s = Real(0);
        for (int gg = 0; gg < ng; ++gg)
          s += reinterpret_cast<const Real*>(red + (gg * cw + cc) * KC)[idx];
        out.put(c0 + cc, idx, s);
      }
      __syncthreads();
    }
  }
}

// what a CTA does with one item
struct Piece {
  int b;          // block, or -1: no work
  int r0, nr;     // rows [r0, r0 + nr) of the block (a dense panel; a piece of U)
  int c0, nc;     // columns [c0, c0 + nc) (dense: all live ones; a piece of V)
  int rk;         // live rank (low rank)
  long long to, so;  // the block's rows t and s in x and y
};

// CTAs an SM the registers allow: four at float32 k = 1 (64 registers),
// whose items' buffers are small enough for four; two elsewhere
template <typename S, int KC>
constexpr int PAIR_CTAS = slim(sizeof(S), KC) ? 4 : 2;

template <typename S, int KC, bool LR>
__global__ void __launch_bounds__(NT, (PAIR_CTAS<S, KC>))
pair_kernel(PairGeom g, const S* __restrict__ A, const S* __restrict__ V,
            const int* __restrict__ items, int cj1, int cj2, const S* __restrict__ X, int k,
            S* Y) {
  using Real = typename RealOf<S>::type;
  constexpr int NC = sizeof(S) / sizeof(Real);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int tab[PAIR_ITEMS * ITEM_INTS];
  S* sm = reinterpret_cast<S*>(smem);
  const int cs = LR ? g.cs : 1;
  int q = 0;
  if (LR && cs > 1) q = (int)cg::this_cluster().block_rank();
  const int it0 = (blockIdx.x / cs) * g.G;
  const int j0 = blockIdx.y * KC, kc = min(KC, k - j0);
  // the CTA's items, read once by all threads in parallel
  for (int e = threadIdx.x; e < g.G * ITEM_INTS; e += NT) {
    const int it = it0 + e / ITEM_INTS;
    tab[e] = it < g.n_items ? items[(size_t)it0 * ITEM_INTS + e] : -1;
  }
  __syncthreads();

  auto piece = [&](int gi) {
    const int* t = tab + gi * ITEM_INTS;
    Piece p;
    p.b = t[0];
    p.to = t[3];
    p.so = t[4];
    if (p.b < 0) {
      p.r0 = p.nr = p.c0 = p.nc = p.rk = 0;
    } else if (LR) {
      p.r0 = q * g.mr;
      p.nr = max(0, min(g.mr, t[2] - p.r0));
      p.c0 = q * g.mc;
      p.nc = max(0, min(g.mc, t[5] - p.c0));
      p.rk = t[6];
    } else {
      p.r0 = t[1];
      p.nr = t[2] - t[1];
      p.c0 = 0;
      p.nc = t[5];
      p.rk = 0;
    }
    return p;
  };
  auto stage = [&](const Piece& p) {
    S* buf = sm;
    if (p.b < 0) return;
    if (LR) {
      if (p.rk > 0 && p.nr > 0) {
        stage_tile<S>(buf, g.sa, A + ((size_t)p.b * g.R + p.r0) * g.r, g.r, p.nr, p.rk, g.vecA);
        stage_x<S, KC>(buf + g.offXt, g.xrt, X, p.to + p.r0, p.nr, k, j0, kc);
      }
      if (p.rk > 0 && p.nc > 0) {
        stage_tile<S>(buf + g.offV, g.sv, V + (size_t)p.b * g.r * g.C + p.c0, g.C, p.rk, p.nc,
                      g.vecV);
        stage_x<S, KC>(buf + g.offXs, g.xrs, X, p.so + p.c0, p.nc, k, j0, kc);
      }
    } else if (p.nr > 0 && p.nc > 0) {
      stage_tile<S>(buf, g.sa, A + ((size_t)p.b * g.R + p.r0) * g.C, g.C, p.nr, p.nc, g.vecA);
      stage_x<S, KC>(buf + g.offXt, g.xrt, X, p.to + p.r0, p.nr, k, j0, kc);
      stage_x<S, KC>(buf + g.offXs, g.xrs, X, p.so, p.nc, k, j0, kc);
    }
  };

  Real* Yr = reinterpret_cast<Real*>(Y) + (size_t)j0 * NC;
  const long long ld = (long long)k * NC;
  S* red = sm + g.offRed;
  for (int gi = 0; gi < g.G; ++gi) {
    const Piece cur = piece(gi);
    stage(cur);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const S* buf = sm;
    if constexpr (!LR) {
      if (cur.b >= 0) {
        row_sums<S, KC>(buf, g.sa, cur.nr, cur.nc, cj1, XView<S, KC>{buf + g.offXs, g.xrs}, kc,
                        red, ToY<S>{Yr, cur.to + cur.r0, ld});
        col_sums<S, KC>(buf, g.sa, cur.nr, cur.nc, cj2, XView<S, KC>{buf + g.offXt, g.xrt}, kc,
                        red, ToY<S>{Yr, cur.so, ld});
      }
    } else {
      // rank pass: t = g1(V) x[s :] and t' = g2(U)ᵀ x[t :] over the piece
      S* part = sm + g.offPart + (gi & 1) * 2 * KC * g.xrr;
      const int rsz = KC * g.xrr;
      const bool work = cur.b >= 0 && cur.rk > 0;
      if (work) {
        row_sums<S, KC>(buf + g.offV, g.sv, cur.rk, cur.nc, cj1,
                        XView<S, KC>{buf + g.offXs, g.xrs}, kc, red, ToPlanes<S, KC>{part, g.xrr});
        col_sums<S, KC>(buf, g.sa, cur.nr, cur.rk, cj2, XView<S, KC>{buf + g.offXt, g.xrt}, kc,
                        red, ToPlanes<S, KC>{part + rsz, g.xrr});
      }
      const S* full = part;
      if (cs > 1) {
        // the cluster's partial sums meet: each CTA reads every CTA's
        cg::cluster_group cluster = cg::this_cluster();
        cluster.sync();
        if (work) {
          S* f = sm + g.offFull;
          for (int e = threadIdx.x; e < 2 * rsz; e += NT) {
            S s = S(0);
            for (int qq = 0; qq < cs; ++qq) s += *cluster.map_shared_rank(part + e, qq);
            f[e] = s;
          }
          full = f;
        }
      }
      __syncthreads();
      // expansion: y[t :] += g1(U) t and y[s :] += g2(V)ᵀ t' over the piece
      if (work) {
        row_sums<S, KC>(buf, g.sa, cur.nr, cur.rk, cj1, XView<S, KC>{full, g.xrr}, kc, red,
                        ToY<S>{Yr, cur.to + cur.r0, ld});
        col_sums<S, KC>(buf + g.offV, g.sv, cur.rk, cur.nc, cj2,
                        XView<S, KC>{full + rsz, g.xrr}, kc, red,
                        ToY<S>{Yr, cur.so + cur.c0, ld});
      }
    }
    __syncthreads();  // the buffer is free for the next item
  }
  // no CTA leaves while another of its cluster may still read its sums
  if (LR && cs > 1) cg::this_cluster().sync();
  cp_async_wait<0>();
}

template <auto kernel>
int configure_pair_kernel() {
  static bool configured = false;  // one per kernel
  if (configured) return 0;
  if (cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PAIR_SMEM_MAX))
    return (int)err;
  if (cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared))
    return (int)err;
  configured = true;
  return 0;
}

template <typename S, int KC, bool LR>
int launch(const PairGeom& g, const void* A, const void* V, const int* items, int cj1, int cj2,
           const void* x, int k, void* y, cudaStream_t stream) {
  constexpr auto kernel = pair_kernel<S, KC, LR>;
  if (int err = configure_pair_kernel<kernel>()) return err;
  const int cs = LR ? g.cs : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((g.n_items + g.G - 1) / g.G) * cs), (unsigned)((k + KC - 1) / KC));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = (size_t)g.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (cs > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return (int)cudaLaunchKernelEx(&cfg, kernel, g, static_cast<const S*>(A),
                                 static_cast<const S*>(V), items, cj1, cj2,
                                 static_cast<const S*>(x), k, static_cast<S*>(y));
}

template <typename S>
int dispatch(int lr, const int* geom, const void* A, const void* V, const int* items, int cj1,
             int cj2, const void* x, int k, void* y, void* stream) {
  PairGeom g;
  int* gi = reinterpret_cast<int*>(&g);
  for (int i = 0; i < GEOM_INTS; ++i) gi[i] = geom[i];
  if (g.n_items <= 0 || k <= 0) return 0;
  if (g.G <= 0 || g.G > PAIR_ITEMS || g.smem <= 0 || g.smem > PAIR_SMEM_MAX ||
      (lr && (g.cs < 1 || g.cs > CLUSTER_MAX)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  // the layout is made for one column chunk: refuse a geometry for another
#define HTOOL_PAIR(CHUNK)                                                                \
  {                                                                                      \
    if (g.KC != CHUNK) return (int)cudaErrorInvalidValue;                                \
    return lr ? launch<S, CHUNK, true>(g, A, V, items, cj1, cj2, x, k, y, st)            \
              : launch<S, CHUNK, false>(g, A, V, items, cj1, cj2, x, k, y, st);          \
  }
  if (k == 1) HTOOL_PAIR(1);
  if (k == 2) HTOOL_PAIR(2);
  if (k <= 4) HTOOL_PAIR(4);
  HTOOL_PAIR(8);
#undef HTOOL_PAIR
}

}  // namespace

// One entry point per scalar type; each returns the cudaError_t of the launch
// (0 on success).  geom: the PairGeom ints the host computed for this k
// (its column chunk KC: 1, 2, 4 or 8); conj_t, conj_s: g1 and g2 conjugate
// (no effect on the real types).
#define HTOOL_PAIR_ENTRY(SUFFIX, S)                                                         \
  int htool_pair_matvec_##SUFFIX(int lr, const int* geom, const void* A, const void* V,     \
                                 const int* items, int conj_t, int conj_s, const void* x,   \
                                 int k, void* y, void* stream) {                            \
    return dispatch<S>(lr, geom, A, V, items, conj_t, conj_s, x, k, y, stream);             \
  }

extern "C" {

HTOOL_PAIR_ENTRY(f32, float)
HTOOL_PAIR_ENTRY(f64, double)
HTOOL_PAIR_ENTRY(c64, cplx<float>)
HTOOL_PAIR_ENTRY(c128, cplx<double>)

int htool_pair_geom_ints() { return GEOM_INTS; }

}  // extern "C"
