// One-launch tiled low-rank bucket matvec for NVIDIA Hopper (sm_90a).
//
// Replaces htool_tpu/ops/tiled_matvec.py::_tiled_kernel (the Pallas TPU
// kernel behind tiled_bucket_matvec) and its fold, for the low-rank plans
// that run a whole block in one CTA.  (Dense plans and split two-stage
// low-rank plans run stream_matvec.cu.)  One launch applies one bucket term
// of an H-matrix product:
//
//   for every plan step s, for every slot i of the step (blk[i] >= 0):
//     y[out_off[i] : out_off[i] + out_w, :] += op(B[blk[i]]) · x[in_off[i] : in_off[i] + in_w, :]
//
// where B is a low-rank block U·V with U [bm, r], V [r, bn], and op is
// applied as U (V x) or Vᵀ (Uᵀ x).  The scalar is float, double, or
// interleaved complex (complex64 / complex128 as PyTorch stores them); for
// complex scalars `conj` applies conj(U) and conj(V), so op ranges over B,
// Bᵀ, conj(B) and Bᴴ.  This also replaces the reference's complex route
// (build_tile_plan_complex + apply_complex_plans), which splits every block
// into real and imaginary planes and runs 4 real launches per low-rank term
// because its kernel has no complex type: here a complex entry is read once,
// as it is stored.  The host plan
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
// columns).  The step's blocks run one after another through the low-rank
// routine of matvec_block.cuh (passes of 64 rank rows through a
// shared-memory intermediate t), which adds into y with atomicAdd; the order
// of the additions, and so the rounding, varies from run to run.
//
// What bounds it on the H100: every block entry is read once per product,
// with 2·KC (real) or 8·KC (complex) flops per entry, so device memory
// bandwidth (3.35 TB/s).  It reaches half of that only at k = 1: entries go
// from device memory straight to registers, so at k = 8, where the sums take
// the registers, few bytes are in flight; a CTA takes 4 blocks whatever their
// size; every lane adds its row's k sums to y one request at a time; and a
// rank above 64 walks the x window once per pass.  The streaming kernels
// (matvec_stream.cuh, stream_matvec.cu) are the answer to each of these, at
// the price of a second launch and a round trip of t through device memory.
// ops/cut.py::lr_split_wanted holds the measured rule between the two: this
// kernel keeps the buckets whose whole term is so short that the second
// launch costs more than the streaming saves.

#include "matvec_block.cuh"

namespace {

using namespace htool_mv;

template <typename S>
struct Params {
  int trans;           // apply blocks transposed
  int conj;            // apply blocks conjugated (complex scalars)
  const S* U;          // [nb, bm, r]
  const S* V;          // [nb, r, bn]
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
  __shared__ __align__(16) S tbuf[RCH * KC];  // intermediate t = V x (or Uᵀ x)
  const int step = blockIdx.x;
  const int j0 = blockIdx.y * KC;
  const int kc = min(KC, p.k - j0);

  for (int s = step * p.G; s < (step + 1) * p.G; ++s) {
    const int b = p.blk[s];
    if (b < 0) continue;  // padding slot of the step's last group
    apply_block<S, KC>(p.trans, p.conj, p.U, p.V, b, p.bm, p.bn, p.r,
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
int dispatch(int trans, int conj, const void* U, const void* V, int bm, int bn, int r,
             const int* blk, const int* in_off, const int* out_off, int n_steps, int G,
             const void* x, int k, void* y, void* stream) {
  Params<S> p{trans, conj, static_cast<const S*>(U), static_cast<const S*>(V), bm, bn, r,
              blk, in_off, out_off, G, static_cast<const S*>(x), k, static_cast<S*>(y)};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (k == 1) return launch<S, 1>(p, n_steps, st);
  if (k == 2) return launch<S, 2>(p, n_steps, st);
  if (k <= 4) return launch<S, 4>(p, n_steps, st);
  return launch<S, 8>(p, n_steps, st);
}

}  // namespace

// One entry point per scalar type; each returns the cudaError_t of the launch
// (0 on success).  conj has no effect on the real types.
#define HTOOL_TILED_ENTRY(SUFFIX, S)                                             \
  int htool_tiled_matvec_##SUFFIX(                                               \
      int trans, int conj, const void* U, const void* V, int bm, int bn, int r,  \
      const int* blk, const int* in_off, const int* out_off, int n_steps, int G, \
      const void* x, int k, void* y, void* stream) {                             \
    return dispatch<S>(trans, conj, U, V, bm, bn, r, blk, in_off, out_off,       \
                       n_steps, G, x, k, y, stream);                             \
  }

extern "C" {

HTOOL_TILED_ENTRY(f32, float)
HTOOL_TILED_ENTRY(f64, double)
HTOOL_TILED_ENTRY(c64, cplx<float>)
HTOOL_TILED_ENTRY(c128, cplx<double>)

const char* htool_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
