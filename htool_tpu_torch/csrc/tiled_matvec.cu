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
// columns).  The step's blocks run one after another through the block
// routines of matvec_block.cuh (row dots, column sums, low-rank passes
// through shared memory), which add into y with atomicAdd; so a warp may
// start the next dense block while others finish, and the order of the
// additions, and so the rounding, varies from run to run.
//
// What bounds it: every block entry is read once per product, with 2·KC
// flops per entry read, so on the H100 it is bound by device memory
// bandwidth (3.35 TB/s).  What this simple design leaves on the table: no
// tensor cores (wgmma), no TMA or cp.async pipelining of the block stream,
// x windows read through L1 instead of being staged, a fixed number of
// blocks per CTA instead of balancing by bytes, and one launch per bucket
// term.

#include "matvec_block.cuh"

namespace {

using namespace htool_mv;

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
    apply_block<S, KC>(p.kind, p.trans, p.data, p.U, p.V, b, p.bm, p.bn, p.r,
                       p.x + (size_t)p.in_off[s] * p.k + j0, p.k,
                       p.y + (size_t)p.out_off[s] * p.k + j0, p.k, kc, red, tbuf);
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
