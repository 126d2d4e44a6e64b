// Tiled bucket matvec for NVIDIA Hopper (sm_90a).
//
// Replaces htool_tpu/ops/tiled_matvec.py::_tiled_kernel (the Pallas TPU
// kernel behind tiled_bucket_matvec) and its fold.  One launch applies one
// bucket term of an H-matrix product:
//
//   for every plan step s, for every slot i of the step (blk[i] >= 0):
//     y[out_off[i] : out_off[i] + out_w, :] += op(B[blk[i]]) · x[in_off[i] : in_off[i] + in_w, :]
//
// where B is a dense block D (op = D or Dᵀ) or a low-rank block U·V with
// U [bm, r], V [r, bn] (op applied as U (V x) or Vᵀ (Uᵀ x)).  The host plan
// (htool_tpu_torch/ops/tiled_matvec.py::build_tile_plan) sorts the blocks by
// output offset, cuts the output into tiles of T rows and a tile's blocks
// into steps of G slots.  The plan indexes the bucket's own arrays through
// the sort order (blk[i]), so no sorted copy of the block data exists.  The
// reference accumulates each tile in a [T + E] buffer and folds the buffers
// into y afterwards (y[tT : tT+T+E] += tile_t); here each contribution is
// added at its folded row out_off = tT + out_rel directly, which is the same
// sum without the buffers and without the fold's extra passes.  The tiles
// only decide which blocks share a step.
//
// Design: one CTA per (plan step, chunk of up to KC right-hand-side
// columns).  Dense blocks run as row dots (a sub-warp of LW lanes per row,
// RW rows at a time so each x value loaded serves RW rows, x rows read as
// 16-byte vectors) or column sums (consecutive threads on consecutive
// columns); low-rank blocks as two such passes through a shared-memory
// intermediate t (at most RCH rank rows at a time).  Results go to y with
// atomicAdd, which issues as a fire-and-forget reduction, so no warp stalls
// on a read of the output and a warp may start the next dense block while
// others finish; the order of the additions, and so the rounding, varies
// from run to run.  Shared memory holds only t and a reduction buffer, so
// blocks of any width work (nothing is sized by E or by a block width).
//
// What bounds it: every block entry is read once per product, with 2·KC
// flops per entry read, so on the H100 it is bound by device memory
// bandwidth (3.35 TB/s).  What this simple design leaves on the table: no
// tensor cores (wgmma), no TMA or cp.async pipelining of the block stream,
// x windows read through L1 instead of being staged, a fixed number of
// blocks per CTA instead of balancing by bytes, and one launch per bucket
// term.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads per CTA
constexpr int NWARP = NT / 32;
constexpr int RCH = 64;          // rank rows of a low-rank block per pass
// Row-dot shape, chosen by timing variants on an H100 at n = 100k: a row of
// c entries gets about c/8 lanes (16 for the 224-wide dense blocks, 2 for
// rank-16 factor rows), and a sub-warp takes 4 rows at once (2 at k >= 8,
// where 4 rows of 8 accumulators cost occupancy).
constexpr int LANE_COLS = 8;
constexpr int RW_SMALL_K = 4;
constexpr int RW_LARGE_K = 2;

template <typename S>
struct Params {
  int kind;            // 0 = dense, 1 = low rank
  int trans;           // apply blocks transposed
  const S* data;       // dense [nb, bm, bn]
  const S* U;          // low rank [nb, bm, r]
  const S* V;          // low rank [nb, r, bn]
  int bm, bn, r;
  const int* blk;      // [n_steps * G] block id in the bucket, -1 = padding
  const int* in_off;   // [n_steps * G] first x row of the block's input window
  const int* out_off;  // [n_steps * G] first y row of the block's output window
  int G;
  const S* x;          // [L, k] row-major
  int k;
  S* y;                // [out_len, k] row-major, accumulated into
};

__device__ __forceinline__ int pow2_at_least(int v, int cap) {
  int p = 1;
  while (p < v && p < cap) p <<= 1;
  return p;
}

// lanes that share one row of a row dot: a power of two near cols/LANE_COLS
__device__ __forceinline__ int lanes_for(int cols) {
  const int want = max(1, cols / LANE_COLS);
  int p = 1;
  while (p * 2 <= want && p < 32) p <<= 1;
  return p;
}

// x[j] for j < kc from one row; 16-byte loads when the row allows them
template <typename S, int KC>
__device__ __forceinline__ void load_row(const S* p, int kc, bool vec, S (&xv)[KC]) {
  if constexpr (sizeof(S) == 4 && KC % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < KC / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(p + 4 * q);
        xv[4 * q] = v.x; xv[4 * q + 1] = v.y; xv[4 * q + 2] = v.z; xv[4 * q + 3] = v.w;
      }
      return;
    }
  }
  if constexpr (sizeof(S) == 8 && KC % 2 == 0) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < KC / 2; ++q) {
        const double2 v = *reinterpret_cast<const double2*>(p + 2 * q);
        xv[2 * q] = v.x; xv[2 * q + 1] = v.y;
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < KC; ++j) xv[j] = j < kc ? p[j] : S(0);
}

template <typename S, int KC>
__device__ __forceinline__ bool can_vec(const S* X, int ldx, int kc) {
  return kc == KC && (ldx * sizeof(S)) % 16 == 0 &&
         (reinterpret_cast<uintptr_t>(X) & 15) == 0;
}

// out[o*ldo + j] += sum_c A[o*lda + c] * X[c*ldx + j]   (o < rows, c < cols, j < kc)
// A sub-warp of LW lanes owns RW consecutive rows; its lanes stride over c
// (coalesced reads of the rows), load each x value once for the RW rows,
// and reduce with shuffles.  No barrier: the warps run independently.
template <typename S, int KC>
__device__ void rowdot(const S* __restrict__ A, int lda, int rows, int cols,
                       const S* __restrict__ X, int ldx, S* out, int ldo,
                       int kc) {
  constexpr int RW = KC >= 8 ? RW_LARGE_K : RW_SMALL_K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int LW = lanes_for(cols);
  const int SUB = 32 / LW;
  const bool vec = can_vec<S, KC>(X, ldx, kc);
  const int sub = lane / LW, sl = lane % LW;
  for (int base = warp * SUB * RW; base < rows; base += NWARP * SUB * RW) {
    const int o0 = base + sub * RW;
    S acc[RW][KC];
#pragma unroll
    for (int q = 0; q < RW; ++q)
#pragma unroll
      for (int j = 0; j < KC; ++j) acc[q][j] = S(0);
    const int nr = min(RW, rows - o0);  // <= 0 for an idle sub-warp
#pragma unroll 2
    for (int c = sl; c < cols; c += LW) {
      S xv[KC];
      load_row<S, KC>(X + (size_t)c * ldx, kc, vec, xv);
#pragma unroll
      for (int q = 0; q < RW; ++q) {
        if (q < nr) {
          const S av = A[(size_t)(o0 + q) * lda + c];
#pragma unroll
          for (int j = 0; j < KC; ++j) acc[q][j] += av * xv[j];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < RW; ++q)
#pragma unroll
      for (int j = 0; j < KC; ++j)
        for (int off = LW >> 1; off > 0; off >>= 1)
          acc[q][j] += __shfl_xor_sync(0xffffffffu, acc[q][j], off);
    if (sl == 0) {
#pragma unroll
      for (int q = 0; q < RW; ++q)
        if (q < nr) {
#pragma unroll
          for (int j = 0; j < KC; ++j)
            if (j < kc) atomicAdd(out + (size_t)(o0 + q) * ldo + j, acc[q][j]);
        }
    }
  }
}

// out[c*ldo + j] += sum_i A[i*lda + c] * X[i*ldx + j]   (c < cols, i < rows, j < kc)
// CW consecutive threads own consecutive columns (coalesced reads of a row
// of A; the x values are broadcasts); the NT/CW thread groups split the rows
// and their partial sums are reduced through shared memory.  Called by all
// threads of the CTA.
template <typename S, int KC>
__device__ void colsum(const S* __restrict__ A, int lda, int rows, int cols,
                       const S* __restrict__ X, int ldx, S* out, int ldo,
                       int kc, S* red) {
  const int CW = pow2_at_least(cols, NT);
  const int NG = NT / CW;
  const int cl = threadIdx.x % CW, g = threadIdx.x / CW;
  const bool vec = can_vec<S, KC>(X, ldx, kc);
  for (int c0 = 0; c0 < cols; c0 += CW) {
    const int c = c0 + cl;
    S acc[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j) acc[j] = S(0);
    if (c < cols) {
#pragma unroll 4
      for (int i = g; i < rows; i += NG) {
        const S av = A[(size_t)i * lda + c];
        S xv[KC];
        load_row<S, KC>(X + (size_t)i * ldx, kc, vec, xv);
#pragma unroll
        for (int j = 0; j < KC; ++j) acc[j] += av * xv[j];
      }
    }
    if (NG == 1) {
      if (c < cols) {
#pragma unroll
        for (int j = 0; j < KC; ++j)
          if (j < kc) atomicAdd(out + (size_t)c * ldo + j, acc[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < KC; ++j) red[(g * CW + cl) * KC + j] = acc[j];
      __syncthreads();
      for (int e = threadIdx.x; e < CW * kc; e += NT) {
        const int cc = e % CW, j = e / CW;
        if (c0 + cc < cols) {
          S s = S(0);
          for (int gg = 0; gg < NG; ++gg) s += red[(gg * CW + cc) * KC + j];
          atomicAdd(out + (size_t)(c0 + cc) * ldo + j, s);
        }
      }
      __syncthreads();
    }
  }
}

template <typename S, int KC>
__global__ void __launch_bounds__(NT) tiled_matvec_kernel(Params<S> p) {
  __shared__ S red[NT * KC];                  // colsum partial sums
  __shared__ __align__(16) S tbuf[RCH * KC];  // low-rank intermediate t = V x (or Uᵀ x)
  const int step = blockIdx.x;
  const int j0 = blockIdx.y * KC;
  const int kc = min(KC, p.k - j0);

  for (int s = step * p.G; s < (step + 1) * p.G; ++s) {
    const int b = p.blk[s];
    if (b < 0) continue;  // padding slot of the step's last group
    const S* xb = p.x + (size_t)p.in_off[s] * p.k + j0;
    S* yb = p.y + (size_t)p.out_off[s] * p.k + j0;
    if (p.kind == 0) {
      const S* D = p.data + (size_t)b * p.bm * p.bn;
      if (!p.trans)
        rowdot<S, KC>(D, p.bn, p.bm, p.bn, xb, p.k, yb, p.k, kc);
      else
        colsum<S, KC>(D, p.bn, p.bm, p.bn, xb, p.k, yb, p.k, kc, red);
      continue;
    }
    const S* U = p.U + (size_t)b * p.bm * p.r;
    const S* V = p.V + (size_t)b * p.r * p.bn;
    for (int r0 = 0; r0 < p.r; r0 += RCH) {
      const int rc = min(RCH, p.r - r0);
      for (int e = threadIdx.x; e < RCH * KC; e += NT) tbuf[e] = S(0);
      __syncthreads();
      if (!p.trans) {
        // t = V[r0:r0+rc, :] x ; y += U[:, r0:r0+rc] t
        rowdot<S, KC>(V + (size_t)r0 * p.bn, p.bn, rc, p.bn, xb, p.k, tbuf, KC, kc);
        __syncthreads();
        rowdot<S, KC>(U + r0, p.r, p.bm, rc, tbuf, KC, yb, p.k, kc);
      } else {
        // t = U[:, r0:r0+rc]ᵀ x ; y += V[r0:r0+rc, :]ᵀ t
        colsum<S, KC>(U + r0, p.r, p.bm, rc, xb, p.k, tbuf, KC, kc, red);
        __syncthreads();
        colsum<S, KC>(V + (size_t)r0 * p.bn, p.bn, rc, p.bn, tbuf, KC, yb, p.k, kc, red);
      }
      __syncthreads();  // tbuf is reused by the next pass or block
    }
  }
}

template <typename S, int KC>
int launch(const Params<S>& p, int n_steps, cudaStream_t stream) {
  dim3 grid(n_steps, (p.k + KC - 1) / KC);
  tiled_matvec_kernel<S, KC><<<grid, NT, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename S>
int dispatch(int kind, int trans, const S* data, const S* U, const S* V,
             int bm, int bn, int r, const int* blk, const int* in_off,
             const int* out_off, int n_steps, int G, const S* x, int k, S* y,
             void* stream) {
  Params<S> p{kind, trans, data, U, V, bm, bn, r, blk, in_off, out_off, G,
              x, k, y};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (k == 1) return launch<S, 1>(p, n_steps, st);
  if (k == 2) return launch<S, 2>(p, n_steps, st);
  if (k <= 4) return launch<S, 4>(p, n_steps, st);
  return launch<S, 8>(p, n_steps, st);
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).
int htool_tiled_matvec_f32(int kind, int trans, const float* data,
                           const float* U, const float* V, int bm, int bn,
                           int r, const int* blk, const int* in_off,
                           const int* out_off, int n_steps, int G,
                           const float* x, int k, float* y, void* stream) {
  return dispatch<float>(kind, trans, data, U, V, bm, bn, r, blk, in_off,
                         out_off, n_steps, G, x, k, y, stream);
}

int htool_tiled_matvec_f64(int kind, int trans, const double* data,
                           const double* U, const double* V, int bm, int bn,
                           int r, const int* blk, const int* in_off,
                           const int* out_off, int n_steps, int G,
                           const double* x, int k, double* y, void* stream) {
  return dispatch<double>(kind, trans, data, U, V, bm, bn, r, blk, in_off,
                          out_off, n_steps, G, x, k, y, stream);
}

const char* htool_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
