// Unplanned bucket matvec on the streaming core, for NVIDIA Hopper (sm_90a).
//
// Replaces htool_tpu/ops/bucket_matvec.py::_dense_kernel and ::_lr_kernel
// (the Pallas TPU kernels behind dense_bucket_matvec and lr_bucket_matvec).
// One call applies one bucket term of an H-matrix product that has no tiled
// plan,
//
//   y[out_off[i] - out_root : + out_w, :] += op(B_i) · x[in_off[i] - in_root : + in_w, :]
//
// for every block B_i of the bucket, with op = B_i or B_iᵀ, conjugated when
// asked (complex scalars: B, Bᵀ, conj(B), Bᴴ, the mirrored terms of hermitian
// storage).  The offsets are the bucket's own int64 t_off/s_off; the root
// offsets are subtracted here, so a partition-restricted block row launches
// no index arithmetic of its own.
//
// - A dense term (htool_dense_bucket_stream_*) is one launch: the blocks
//   D_i [bm, bn] are the streamed matrices, cut into P panels along the
//   output dimension and grouped G panels to a CTA by the wrapper's byte rule
//   (ops/cut.py::cut_rule), so a bucket of few large blocks spreads over all
//   SMs and one of many small blocks gives every CTA about the same bytes.
// - A low-rank term (htool_lr_bucket_stream_*) is two launches through a
//   staging tensor t [nb * r_pad, k] in device memory that the wrapper
//   allocates (it stays in the 50 MB L2): stage A t_i = op(V_i) x_i (trans:
//   op(U_i)ᵀ x_i), stored, no atomics; stage B y_i += op(U_i) t_i (trans:
//   op(V_i)ᵀ t_i), each stage cut by the same byte rule.
//
// What bounds them on the H100: every block entry is read once per product
// for 2·k (real) or 8·k (complex) flops, so device memory bandwidth
// (3.35 TB/s); at k = 8 the inner loop's instructions and the epilogue's
// requests into y come close behind.  The streaming itself (a ring of tiles
// filled by cp.async, x staged once per panel, sums in registers, results
// leaving as reals on consecutive addresses, float64 and complex128 on the
// FP64 tensor cores at k >= 4) is matvec_stream.cuh; see there.  The Pallas
// kernels keep x and y resident in VMEM and walk the blocks on a sequential
// grid; here CTAs run in no order and add into y with atomicAdd, so the order
// of the additions, and the rounding, varies from run to run.
//
// A block whose input or output window falls outside x or y stops the kernel
// with a device fault (__trap); it surfaces at the next synchronisation.

#include "matvec_stream.cuh"

namespace {

using namespace htool_mv;

struct BucketAddr {
  const long long* in_off;   // [nb] + in_root; nullptr: the block's rows of t
  const long long* out_off;  // [nb] + out_root; nullptr: the block's rows of t
  long long in_root, out_root;
  long long in_rows, out_rows;  // rows of the input and of the output tensor
  int r_pad;                    // rows of t per block
  int total;                    // nb * P
  __device__ __forceinline__ int slot(int s) const { return s < total ? s : -1; }
  __device__ __forceinline__ long long in(int, int b) const {
    return in_off ? in_off[b] - in_root : (long long)b * r_pad;
  }
  __device__ __forceinline__ long long out(int, int b, int lo) const {
    return (out_off ? out_off[b] - out_root : (long long)b * r_pad) + lo;
  }
  __device__ __forceinline__ int rows(int, int R) const { return R; }  // whole blocks
  __device__ __forceinline__ int cols(int, int C) const { return C; }
  __device__ __forceinline__ void check(long long io, int in_w, long long oo, int out_w) const {
    if (io < 0 || io + in_w > in_rows || oo < 0 || oo + out_w > out_rows) __trap();
  }
};

template <typename S, int KC, bool TRANS, bool MMA>
__global__ void __launch_bounds__(NT, (CTAS_PER_SM<S, KC>))
bucket_stream_kernel(StreamGeom g, const S* A, int cj, int store, BucketAddr addr, int G,
                     const S* x, int k, S* y) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int j0 = blockIdx.y * KC;
  stream_run<S, KC, TRANS, MMA>(g, A, cj, store, addr, blockIdx.x * G, (blockIdx.x + 1) * G, x,
                                k, y, k, j0, min(KC, k - j0), smem);
}

// One launch: the nb matrices A [R, C] applied (transposed when TRANS) to the
// windows addr gives, stored into or added to y.
template <typename S, int KC, bool TRANS>
int stage(int cj, int store, const void* A, int nb, int R, int C, int P, int cut, int G,
          BucketAddr addr, const void* x, int k, void* y, cudaStream_t stream) {
  StreamGeom g;
  if (G <= 0 || G > MAX_SLOTS) return (int)cudaErrorInvalidValue;
  if (int err = make_geom<S>(g, TRANS, KC, R, C, P, cut, A)) return err;
  addr.total = nb * P;
  return with_loop<S, KC>(g, [&](auto mma) {
    constexpr auto kernel = bucket_stream_kernel<S, KC, TRANS, decltype(mma)::value>;
    if (int err = configure_stream_kernel<kernel, STREAM_SMEM<S, KC>>()) return err;
    dim3 grid((addr.total + G - 1) / G, (k + KC - 1) / KC);
    kernel<<<grid, NT, STREAM_SMEM<S, KC>, stream>>>(
        g, static_cast<const S*>(A), cj, store, addr, G, static_cast<const S*>(x), k,
        static_cast<S*>(y));
    return (int)cudaGetLastError();
  });
}

template <typename S, int KC>
int dense(int trans, int cj, const void* D, int nb, int bm, int bn, BucketAddr addr,
          const void* x, int k, void* y, int P, int cut, int G, cudaStream_t st) {
  if (trans) return stage<S, KC, true>(cj, 0, D, nb, bm, bn, P, cut, G, addr, x, k, y, st);
  return stage<S, KC, false>(cj, 0, D, nb, bm, bn, P, cut, G, addr, x, k, y, st);
}

template <typename S, int KC>
int two_stages(int trans, int cj, const void* U, const void* V, int nb, int bm, int bn, int r,
               const long long* in_off, const long long* out_off, long long in_root,
               long long out_root, const void* x, long long x_rows, int k, void* y,
               long long y_rows, void* t, int r_pad, int PA, int cutA, int GA, int PB,
               int cutB, int GB, cudaStream_t st) {
  const long long t_rows = (long long)nb * r_pad;
  BucketAddr a{in_off, nullptr, in_root, 0, x_rows, t_rows, r_pad, 0};
  BucketAddr b{nullptr, out_off, 0, out_root, t_rows, y_rows, r_pad, 0};
  if (!trans) {
    if (int err = stage<S, KC, false>(cj, 1, V, nb, r, bn, PA, cutA, GA, a, x, k, t, st))
      return err;
    return stage<S, KC, false>(cj, 0, U, nb, bm, r, PB, cutB, GB, b, t, k, y, st);
  }
  if (int err = stage<S, KC, true>(cj, 1, U, nb, bm, r, PA, cutA, GA, a, x, k, t, st))
    return err;
  return stage<S, KC, true>(cj, 0, V, nb, r, bn, PB, cutB, GB, b, t, k, y, st);
}

template <typename S>
int dense_dispatch(int trans, int cj, const void* D, int nb, int bm, int bn,
                   const long long* in_off, const long long* out_off, long long in_root,
                   long long out_root, const void* x, long long x_rows, int k, void* y,
                   long long y_rows, int P, int cut, int G, void* stream) {
  if (nb <= 0 || k <= 0) return 0;
  BucketAddr addr{in_off, out_off, in_root, out_root, x_rows, y_rows, 0, 0};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define HTOOL_DENSE(KC) \
  return dense<S, KC>(trans, cj, D, nb, bm, bn, addr, x, k, y, P, cut, G, st)
  if (k == 1) HTOOL_DENSE(1);
  if (k == 2) HTOOL_DENSE(2);
  if (k <= 4) HTOOL_DENSE(4);
  HTOOL_DENSE(8);
#undef HTOOL_DENSE
}

template <typename S>
int lr_dispatch(int trans, int cj, const void* U, const void* V, int nb, int bm, int bn, int r,
                const long long* in_off, const long long* out_off, long long in_root,
                long long out_root, const void* x, long long x_rows, int k, void* y,
                long long y_rows, void* t, int r_pad, int PA, int cutA, int GA, int PB,
                int cutB, int GB, void* stream) {
  if (nb <= 0 || k <= 0 || r <= 0) return 0;
  if (r_pad < r) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define HTOOL_TWO(KC)                                                                    \
  return two_stages<S, KC>(trans, cj, U, V, nb, bm, bn, r, in_off, out_off, in_root,     \
                           out_root, x, x_rows, k, y, y_rows, t, r_pad, PA, cutA, GA, PB, \
                           cutB, GB, st)
  if (k == 1) HTOOL_TWO(1);
  if (k == 2) HTOOL_TWO(2);
  if (k <= 4) HTOOL_TWO(4);
  HTOOL_TWO(8);
#undef HTOOL_TWO
}

}  // namespace

// One pair of entry points per scalar type; each returns the first
// cudaError_t of its launches (0 on success).  conj has no effect on the real
// types.  (P, cut, G): the byte rule's cut of the dense blocks; of stage A's
// and stage B's matrices for a low-rank term.
#define HTOOL_BUCKET_STREAM_ENTRIES(SUFFIX, S)                                           \
  int htool_dense_bucket_stream_##SUFFIX(                                                \
      int trans, int conj, const void* data, int nb, int bm, int bn,                     \
      const long long* in_off, const long long* out_off, long long in_root,              \
      long long out_root, const void* x, long long x_rows, int k, void* y,               \
      long long y_rows, int P, int cut, int G, void* stream) {                           \
    return dense_dispatch<S>(trans, conj, data, nb, bm, bn, in_off, out_off, in_root,    \
                             out_root, x, x_rows, k, y, y_rows, P, cut, G, stream);      \
  }                                                                                      \
  int htool_lr_bucket_stream_##SUFFIX(                                                   \
      int trans, int conj, const void* U, const void* V, int nb, int bm, int bn,         \
      int r, const long long* in_off, const long long* out_off, long long in_root,       \
      long long out_root, const void* x, long long x_rows, int k, void* y,               \
      long long y_rows, void* t, int r_pad, int PA, int cutA, int GA, int PB,            \
      int cutB, int GB, void* stream) {                                                  \
    return lr_dispatch<S>(trans, conj, U, V, nb, bm, bn, r, in_off, out_off, in_root,    \
                          out_root, x, x_rows, k, y, y_rows, t, r_pad, PA, cutA, GA, PB, \
                          cutB, GB, stream);                                             \
  }

extern "C" {

HTOOL_BUCKET_STREAM_ENTRIES(f32, float)
HTOOL_BUCKET_STREAM_ENTRIES(f64, double)
HTOOL_BUCKET_STREAM_ENTRIES(c64, cplx<float>)
HTOOL_BUCKET_STREAM_ENTRIES(c128, cplx<double>)

}  // extern "C"
