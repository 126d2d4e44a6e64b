// Block-level routines shared by the H-matrix product kernels for NVIDIA
// Hopper (sm_90a): tiled_matvec.cu (planned bucket terms) and
// bucket_matvec.cu (unplanned bucket terms).  Each applies one block of a
// bucket to its input window and adds the result into its output window:
//
//   y[0 : out_w, 0 : kc] += op(B) · x[0 : in_w, 0 : kc]
//
// where B is a dense block D [bm, bn] (op = D or Dᵀ) or a low-rank block
// U [bm, r] · V [r, bn] (op applied as U (V x) or Vᵀ (Uᵀ x)).  x and y are
// row-major with leading dimension k; a CTA handles up to KC of the k
// right-hand-side columns.
//
// Dense blocks run as row dots (a sub-warp of LW lanes per row, RW rows at
// a time so each x value loaded serves RW rows, x rows read as 16-byte
// vectors) or column sums (consecutive threads on consecutive columns);
// low-rank blocks as two such passes through a shared-memory intermediate t
// (at most RCH rank rows at a time).  Results go to y with atomicAdd, which
// issues as a fire-and-forget reduction, so no warp stalls on a read of the
// output; the order of the additions, and so the rounding, varies from run
// to run.  Shared memory holds only t and a reduction buffer, so blocks of
// any width work.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace htool_mv {

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

// yb += op(B) · xb for block b of a bucket: dense (kind 0, data
// [nb, bm, bn]) or low rank (kind 1, U [nb, bm, r], V [nb, r, bn]); op is B,
// or Bᵀ when trans.  Called by all threads of the CTA with the same
// arguments.  red is a [NT * KC] and tbuf a 16-byte aligned [RCH * KC]
// shared buffer.
template <typename S, int KC>
__device__ __forceinline__ void apply_block(int kind, int trans, const S* data,
                                            const S* Ub, const S* Vb, size_t b,
                                            int bm, int bn, int r, const S* xb,
                                            int ldx, S* yb, int ldy, int kc,
                                            S* red, S* tbuf) {
  if (kind == 0) {
    const S* D = data + b * bm * bn;
    if (!trans)
      rowdot<S, KC>(D, bn, bm, bn, xb, ldx, yb, ldy, kc);
    else
      colsum<S, KC>(D, bn, bm, bn, xb, ldx, yb, ldy, kc, red);
    return;
  }
  const S* U = Ub + b * bm * r;
  const S* V = Vb + b * r * bn;
  for (int r0 = 0; r0 < r; r0 += RCH) {
    const int rc = min(RCH, r - r0);
    for (int e = threadIdx.x; e < RCH * KC; e += NT) tbuf[e] = S(0);
    __syncthreads();
    if (!trans) {
      // t = V[r0:r0+rc, :] x ; y += U[:, r0:r0+rc] t
      rowdot<S, KC>(V + (size_t)r0 * bn, bn, rc, bn, xb, ldx, tbuf, KC, kc);
      __syncthreads();
      rowdot<S, KC>(U + r0, r, bm, rc, tbuf, KC, yb, ldy, kc);
    } else {
      // t = U[:, r0:r0+rc]ᵀ x ; y += V[r0:r0+rc, :]ᵀ t
      colsum<S, KC>(U + r0, r, bm, rc, xb, ldx, tbuf, KC, kc, red);
      __syncthreads();
      colsum<S, KC>(V + (size_t)r0 * bn, bn, rc, bn, tbuf, KC, yb, ldy, kc, red);
    }
    __syncthreads();  // tbuf is reused by the next pass or block
  }
}

}  // namespace htool_mv
