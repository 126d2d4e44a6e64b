// Unplanned low-rank bucket matvec in one launch, one block per CTA, for
// NVIDIA Hopper (sm_90a).
//
// Replaces htool_tpu/ops/bucket_matvec.py::_lr_kernel (the Pallas TPU kernel
// behind lr_bucket_matvec) for the low-rank terms too short for two launches
// (ops/cut.py::lr_split_wanted: under 4 MB a bucket and 128 KB a block, or k
// = 1 and under 1 MB a block); longer low-rank terms, and every dense term,
// run the streaming kernels of bucket_stream.cu.  One launch applies one
// term of an H-matrix product that has no tiled plan:
//
//   for every block i of the bucket:
//     y[out_off[i] - out_root : + out_w, :] += op(U_i V_i) · x[in_off[i] - in_root : + in_w, :]
//
// with U_i [bm, r], V_i [r, bn], op applied as U (V x) or Vᵀ (Uᵀ x), and
// in_w/out_w bn/bm (bm/bn when transposed).  For complex scalars `conj`
// conjugates U and V, so op ranges over B, Bᵀ, conj(B) and Bᴴ.  The offsets
// are the bucket's own int64 t_off/s_off; the root offsets are subtracted
// here.
//
// Design: each CTA takes one block (and a chunk of up to KC right-hand-side
// columns) and applies it with the low-rank routine of matvec_block.cuh (passes
// of at most 64 rank rows through a shared-memory intermediate), adding into
// y in device memory with atomicAdd; the order of the additions, and so the
// rounding, varies from run to run.  What bounds it on the H100: device
// memory bandwidth (3.35 TB/s) for long terms, which it reaches only at k = 1
// (entries go from device memory straight to registers); the terms it keeps
// are paced by the launch and the host's call, which one launch keeps short.
//
// A block whose input or output window falls outside x or y stops the kernel
// with a device fault (__trap) instead of reading or writing out of range;
// the fault surfaces as an error at the next synchronisation.

#include "matvec_block.cuh"

namespace {

using namespace htool_mv;

template <typename S>
struct BucketParams {
  int trans;                 // apply blocks transposed
  int conj;                  // apply blocks conjugated (complex scalars)
  const S* U;                // [nb, bm, r]
  const S* V;                // [nb, r, bn]
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
  apply_block<S, KC>(p.trans, p.conj, p.U, p.V, b, p.bm, p.bn, p.r,
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
int low_rank(int trans, int conj, const void* U, const void* V, int nb, int bm,
             int bn, int r, const long long* in_off, const long long* out_off,
             long long in_root, long long out_root, const void* x,
             long long x_rows, int k, void* y, long long y_rows, void* stream) {
  BucketParams<S> p{trans, conj, static_cast<const S*>(U), static_cast<const S*>(V),
                    bm, bn, r, in_off, out_off,
                    in_root, out_root, static_cast<const S*>(x), x_rows, k,
                    static_cast<S*>(y), y_rows};
  return dispatch<S>(p, nb, stream);
}

}  // namespace

// One entry point per scalar type; each returns the cudaError_t of the launch
// (0 on success).  conj has no effect on the real types.
#define HTOOL_BUCKET_ENTRY(SUFFIX, S)                                          \
  int htool_lr_bucket_matvec_##SUFFIX(                                         \
      int trans, int conj, const void* U, const void* V, int nb, int bm,       \
      int bn, int r, const long long* in_off, const long long* out_off,        \
      long long in_root, long long out_root, const void* x, long long x_rows,  \
      int k, void* y, long long y_rows, void* stream) {                        \
    return low_rank<S>(trans, conj, U, V, nb, bm, bn, r, in_off, out_off,      \
                       in_root, out_root, x, x_rows, k, y, y_rows, stream);    \
  }

extern "C" {

HTOOL_BUCKET_ENTRY(f32, float)
HTOOL_BUCKET_ENTRY(f64, double)
HTOOL_BUCKET_ENTRY(c64, cplx<float>)
HTOOL_BUCKET_ENTRY(c128, cplx<double>)

}  // extern "C"
