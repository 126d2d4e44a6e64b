// Unplanned bucket matvec, one block per CTA, for NVIDIA Hopper (sm_90a).
//
// Replaces htool_tpu/ops/bucket_matvec.py::_dense_kernel and ::_lr_kernel
// (the Pallas TPU kernels behind dense_bucket_matvec and lr_bucket_matvec).
// One launch applies one bucket term of an H-matrix product that has no
// tiled plan:
//
//   for every block i of the bucket:
//     y[out_off[i] - out_root : + out_w, :] += op(B_i) · x[in_off[i] - in_root : + in_w, :]
//
// where B_i is a dense block D_i [bm, bn] or a low-rank block U_i [bm, r] ·
// V_i [r, bn], op is B_i or B_iᵀ, and in_w/out_w are bn/bm (bm/bn when
// transposed).  The scalar is float, double, or interleaved complex
// (complex64 / complex128 as PyTorch stores them); for complex scalars
// `conj` applies conj(D_i), or conj(U_i) and conj(V_i), so op ranges over
// B, Bᵀ, conj(B) and Bᴴ (the mirrored terms of hermitian storage).  The
// offsets are the bucket's own int64 t_off/s_off; the root
// offsets are subtracted here, so a partition-restricted block row (whose
// local side is numbered from its root) launches no index arithmetic of its
// own.
//
// Design: the Pallas kernels walk the blocks on a sequential grid and keep
// the whole of x and y resident in VMEM.  Hopper has no such memory and runs
// CTAs in parallel and in no order, so here each CTA takes one block (and a
// chunk of up to KC right-hand-side columns), applies it with the block
// routines of matvec_block.cuh (row dots for op = N, column sums for op = T,
// low-rank blocks as two passes through a shared-memory intermediate of at
// most 64 rank rows), and adds into y in device memory with atomicAdd.  The
// order of the additions, and so the rounding, varies from run to run.
//
// What bounds it on the H100: every block entry is read once per product
// for 2·KC (real) or 8·KC (complex) flops, so device memory bandwidth
// (3.35 TB/s).  This one-block-per-CTA form reaches 44 - 66 % of that at
// k = 1 and 16 - 34 % at k = 8 (entries go from device memory straight to
// registers; one CTA streams a block alone whatever its size; a lane adds
// its row's k sums to y one request at a time).  Low-rank terms therefore
// go to the two-stage streaming kernel (bucket_lr_stream.cu) unless the
// term is so short that the second launch costs more than the streaming
// saves (ops/cut.py::lr_split_wanted: under 4 MB a bucket and 128 KB a
// block, or k = 1 and under 1 MB a block); the dense terms
// still run here, and their move to the streaming core is the next step.
//
// A block whose input or output window falls outside x or y stops the kernel
// with a device fault (__trap) instead of reading or writing out of range;
// the fault surfaces as an error at the next synchronisation.

#include "matvec_block.cuh"

namespace {

using namespace htool_mv;

template <typename S>
struct BucketParams {
  int kind;                  // 0 = dense, 1 = low rank
  int trans;                 // apply blocks transposed
  int conj;                  // apply blocks conjugated (complex scalars)
  const S* data;             // dense [nb, bm, bn]
  const S* U;                // low rank [nb, bm, r]
  const S* V;                // low rank [nb, r, bn]
  int bm, bn, r;
  const long long* in_off;   // [nb] first x row of each block's input window, + in_root
  const long long* out_off;  // [nb] first y row of each block's output window, + out_root
  long long in_root, out_root;
  const S* x;                // [x_rows, k] row-major
  long long x_rows;
  int k;
  S* y;                      // [y_rows, k] row-major, accumulated into
  long long y_rows;
};

template <typename S, int KC>
__global__ void __launch_bounds__(NT) bucket_matvec_kernel(BucketParams<S> p) {
  __shared__ S red[NT * KC];                  // colsum partial sums
  __shared__ __align__(16) S tbuf[RCH * KC];  // low-rank intermediate t = V x (or Uᵀ x)
  const int b = blockIdx.x;
  const int j0 = blockIdx.y * KC;
  const int kc = min(KC, p.k - j0);
  const int in_w = p.trans ? p.bm : p.bn;
  const int out_w = p.trans ? p.bn : p.bm;
  const long long io = p.in_off[b] - p.in_root;
  const long long oo = p.out_off[b] - p.out_root;
  if (io < 0 || io + in_w > p.x_rows || oo < 0 || oo + out_w > p.y_rows) __trap();
  apply_block<S, KC>(p.kind, p.trans, p.conj, p.data, p.U, p.V, b, p.bm, p.bn, p.r,
                     p.x + io * p.k + j0, p.k, p.y + oo * p.k + j0, p.k, kc,
                     red, tbuf);
}

template <typename S, int KC>
int launch(const BucketParams<S>& p, int nb, cudaStream_t stream) {
  dim3 grid(nb, (p.k + KC - 1) / KC);
  bucket_matvec_kernel<S, KC><<<grid, NT, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename S>
int dispatch(const BucketParams<S>& p, int nb, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (p.k == 1) return launch<S, 1>(p, nb, st);
  if (p.k == 2) return launch<S, 2>(p, nb, st);
  if (p.k <= 4) return launch<S, 4>(p, nb, st);
  return launch<S, 8>(p, nb, st);
}

template <typename S>
int dense(int trans, int conj, const void* data, int nb, int bm, int bn,
          const long long* in_off, const long long* out_off, long long in_root,
          long long out_root, const void* x, long long x_rows, int k, void* y,
          long long y_rows, void* stream) {
  BucketParams<S> p{0, trans, conj, static_cast<const S*>(data), nullptr,
                    nullptr, bm, bn, 0, in_off, out_off, in_root, out_root,
                    static_cast<const S*>(x), x_rows, k, static_cast<S*>(y),
                    y_rows};
  return dispatch<S>(p, nb, stream);
}

template <typename S>
int low_rank(int trans, int conj, const void* U, const void* V, int nb, int bm,
             int bn, int r, const long long* in_off, const long long* out_off,
             long long in_root, long long out_root, const void* x,
             long long x_rows, int k, void* y, long long y_rows, void* stream) {
  BucketParams<S> p{1, trans, conj, nullptr, static_cast<const S*>(U),
                    static_cast<const S*>(V), bm, bn, r, in_off, out_off,
                    in_root, out_root, static_cast<const S*>(x), x_rows, k,
                    static_cast<S*>(y), y_rows};
  return dispatch<S>(p, nb, stream);
}

}  // namespace

// One pair of entry points per scalar type; each returns the cudaError_t of
// the launch (0 on success).  conj has no effect on the real types.
#define HTOOL_BUCKET_ENTRIES(SUFFIX, S)                                        \
  int htool_dense_bucket_matvec_##SUFFIX(                                      \
      int trans, int conj, const void* data, int nb, int bm, int bn,           \
      const long long* in_off, const long long* out_off, long long in_root,    \
      long long out_root, const void* x, long long x_rows, int k, void* y,     \
      long long y_rows, void* stream) {                                        \
    return dense<S>(trans, conj, data, nb, bm, bn, in_off, out_off, in_root,   \
                    out_root, x, x_rows, k, y, y_rows, stream);                \
  }                                                                            \
  int htool_lr_bucket_matvec_##SUFFIX(                                         \
      int trans, int conj, const void* U, const void* V, int nb, int bm,       \
      int bn, int r, const long long* in_off, const long long* out_off,        \
      long long in_root, long long out_root, const void* x, long long x_rows,  \
      int k, void* y, long long y_rows, void* stream) {                        \
    return low_rank<S>(trans, conj, U, V, nb, bm, bn, r, in_off, out_off,      \
                       in_root, out_root, x, x_rows, k, y, y_rows, stream);    \
  }

extern "C" {

HTOOL_BUCKET_ENTRIES(f32, float)
HTOOL_BUCKET_ENTRIES(f64, double)
HTOOL_BUCKET_ENTRIES(c64, cplx<float>)
HTOOL_BUCKET_ENTRIES(c128, cplx<double>)

}  // extern "C"
