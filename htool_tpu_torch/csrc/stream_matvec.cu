// Planned streaming matvec for NVIDIA Hopper (sm_90a).
//
// Replaces htool_tpu/ops/tiled_matvec.py::_tiled_kernel (the Pallas TPU
// kernel behind tiled_bucket_matvec) for dense plans and for the two stages
// of every low-rank plan (build_tile_plan_lr_split: stage A t = op(V) x
// into a compact staging tensor, stage B y += op(U) t).  One launch applies
// one plan:
//
//   for every slot s of the plan (slot[s] = b * P + p >= 0):
//     panel p of  out[out_off[s] : , :] (+)= op(A[b]) · x[in_off[s] : , :]
//
// with A [nb, R, C] row-major and op = A or Aᵀ, conjugated when asked.  The
// host plan (htool_tpu_torch/ops/tiled_matvec.py) cuts the work by bytes: P
// panels per block along the output dimension, and CTA c takes the slots
// [c * G, (c + 1) * G), so that every CTA streams about the same bytes.
// The streaming itself (ring of tiles in shared memory filled by cp.async,
// x staged once, registers for the sums) is matvec_stream.cuh; see there for
// what bounds the kernel on the H100 and what the design does about it.
// `store` writes the panel's result instead of adding it (stage A: every
// row of t that stage B reads is produced by exactly one CTA, so t needs no
// zeroing).  `ext` gives each slot's live extent, ext[2 s] rows and
// ext[2 s + 1] columns of its block's matrix as stored (nullptr: whole
// blocks); the walk reads, multiplies and writes nothing past it, and the
// tile's geometry is made for the largest one (lR, lC).

#include "matvec_stream.cuh"

namespace {

using namespace htool_mv;

struct PlanAddr {
  const int* slots;    // [n_slots] b * P + p, -1 = padding
  const int* in_off;   // [n_slots] first x row of the block's input window
  const int* out_off;  // [n_slots] first output row of the panel
  const int* ext;      // [n_slots, 2] live rows and columns, or nullptr
  int n_slots;
  __device__ __forceinline__ int slot(int s) const { return s < n_slots ? slots[s] : -1; }
  __device__ __forceinline__ long long in(int s, int) const { return in_off[s]; }
  __device__ __forceinline__ long long out(int s, int, int) const { return out_off[s]; }
  __device__ __forceinline__ int rows(int s, int R) const { return ext ? ext[2 * s] : R; }
  __device__ __forceinline__ int cols(int s, int C) const { return ext ? ext[2 * s + 1] : C; }
  __device__ __forceinline__ void check(long long, int, long long, int) const {}
};

template <typename S, int KC, bool TRANS, bool MMA>
__global__ void __launch_bounds__(NT, (CTAS_PER_SM<S, KC>))
stream_matvec_kernel(StreamGeom g, const S* A, int cj, int store, PlanAddr addr, int G,
                     const S* x, int k, S* y) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int j0 = blockIdx.y * KC;
  stream_run<S, KC, TRANS, MMA>(g, A, cj, store, addr, blockIdx.x * G, (blockIdx.x + 1) * G, x, k,
                           y, k, j0, min(KC, k - j0), smem);
}

template <typename S, int KC, bool TRANS>
int launch(int cj, int store, const void* A, int R, int C, int P, int cut, int lR, int lC,
           const PlanAddr& addr, int G, const void* x, int k, void* y, cudaStream_t stream) {
  StreamGeom g;
  if (int err = make_geom<S>(g, TRANS, KC, R, C, P, cut, A, lR, lC)) return err;
  return with_loop<S, KC>(g, [&](auto mma) {
    constexpr auto kernel = stream_matvec_kernel<S, KC, TRANS, decltype(mma)::value>;
    if (int err = configure_stream_kernel<kernel, STREAM_SMEM<S, KC>>()) return err;
    dim3 grid((addr.n_slots + G - 1) / G, (k + KC - 1) / KC);
    kernel<<<grid, NT, STREAM_SMEM<S, KC>, stream>>>(
        g, static_cast<const S*>(A), cj, store, addr, G, static_cast<const S*>(x), k,
        static_cast<S*>(y));
    return (int)cudaGetLastError();
  });
}

template <typename S, bool TRANS>
int by_k(int cj, int store, const void* A, int R, int C, int P, int cut, int lR, int lC,
         const PlanAddr& addr, int G, const void* x, int k, void* y, cudaStream_t st) {
#define HTOOL_LAUNCH(KC) \
  return launch<S, KC, TRANS>(cj, store, A, R, C, P, cut, lR, lC, addr, G, x, k, y, st)
  if (k == 1) HTOOL_LAUNCH(1);
  if (k == 2) HTOOL_LAUNCH(2);
  if (k <= 4) HTOOL_LAUNCH(4);
  HTOOL_LAUNCH(8);
#undef HTOOL_LAUNCH
}

template <typename S>
int dispatch(int trans, int cj, int store, const void* A, int R, int C, int P, int cut,
             int lR, int lC, const int* slots, const int* in_off, const int* out_off,
             const int* ext, int n_slots, int G, const void* x, int k, void* y, void* stream) {
  if (n_slots <= 0 || k <= 0) return 0;
  if (G <= 0 || G > MAX_SLOTS) return (int)cudaErrorInvalidValue;
  PlanAddr addr{slots, in_off, out_off, ext, n_slots};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return trans ? by_k<S, true>(cj, store, A, R, C, P, cut, lR, lC, addr, G, x, k, y, st)
               : by_k<S, false>(cj, store, A, R, C, P, cut, lR, lC, addr, G, x, k, y, st);
}

}  // namespace

// One entry point per scalar type; each returns the cudaError_t of the launch
// (0 on success).  conj has no effect on the real types.  lR, lC: the
// largest live extent over the slots (R, C, or 0, without ext).
#define HTOOL_STREAM_ENTRY(SUFFIX, S)                                                      \
  int htool_stream_matvec_##SUFFIX(                                                        \
      int trans, int conj, int store, const void* A, int R, int C, int P, int cut, int lR, \
      int lC, const int* slots, const int* in_off, const int* out_off, const int* ext,     \
      int n_slots, int G, const void* x, int k, void* y, void* stream) {                   \
    return dispatch<S>(trans, conj, store, A, R, C, P, cut, lR, lC, slots, in_off,         \
                       out_off, ext, n_slots, G, x, k, y, stream);                         \
  }

extern "C" {

HTOOL_STREAM_ENTRY(f32, float)
HTOOL_STREAM_ENTRY(f64, double)
HTOOL_STREAM_ENTRY(c64, cplx<float>)
HTOOL_STREAM_ENTRY(c128, cplx<double>)

const char* htool_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
