// Scalar types and thread counts of the H-matrix product kernels for NVIDIA
// Hopper (sm_90a), shared by the streaming core, matvec_stream.cuh.
//
// The scalar S is float, double, or the interleaved complex type
// cplx<float> / cplx<double> (the memory layout of complex64 / complex128
// tensors).  The overloads below give every scalar one multiply-add, one
// conjugation (a sign flip in a register; a real scalar is its own
// conjugate), one warp shuffle and one atomic add into device memory (a
// complex sum goes as two real atomicAdds, on the real and on the imaginary
// part), and Vec16 reads the scalars of one 16-byte vector.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace htool_mv {

constexpr int NT = 256;          // threads per CTA
constexpr int NWARP = NT / 32;

// Interleaved complex scalar: (re, im) as PyTorch and NumPy store it.
template <typename R>
struct alignas(2 * sizeof(R)) cplx {
  R re, im;
  cplx() = default;
  __device__ __forceinline__ explicit cplx(R r, R i = R(0)) : re(r), im(i) {}
  __device__ __forceinline__ cplx& operator+=(const cplx& o) {
    re += o.re;
    im += o.im;
    return *this;
  }
};

// acc += a * x
template <typename S>
__device__ __forceinline__ void mul_add(S& acc, S a, S x) { acc += a * x; }
template <typename R>
__device__ __forceinline__ void mul_add(cplx<R>& acc, cplx<R> a, cplx<R> x) {
  acc.re += a.re * x.re;
  acc.re -= a.im * x.im;
  acc.im += a.re * x.im;
  acc.im += a.im * x.re;
}

// conj(a) when cj (a real scalar is its own conjugate)
template <typename S>
__device__ __forceinline__ S conj_if(S a, int) { return a; }
template <typename R>
__device__ __forceinline__ cplx<R> conj_if(cplx<R> a, int cj) {
  return cplx<R>(a.re, cj ? -a.im : a.im);
}

template <typename S>
__device__ __forceinline__ S shfl_xor(S v, int off) {
  return __shfl_xor_sync(0xffffffffu, v, off);
}
template <typename R>
__device__ __forceinline__ cplx<R> shfl_xor(cplx<R> v, int off) {
  return cplx<R>(__shfl_xor_sync(0xffffffffu, v.re, off),
                 __shfl_xor_sync(0xffffffffu, v.im, off));
}

template <typename S>
__device__ __forceinline__ void atomic_add(S* p, S v) { atomicAdd(p, v); }
template <typename R>
__device__ __forceinline__ void atomic_add(cplx<R>* p, cplx<R> v) {
  atomicAdd(&p->re, v.re);
  atomicAdd(&p->im, v.im);
}

// One 16-byte load: the PER = 16 / sizeof(S) scalars at p (16-byte aligned).
template <typename S> struct Vec16;
template <> struct Vec16<float> {
  static __device__ __forceinline__ void load(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <> struct Vec16<double> {
  static __device__ __forceinline__ void load(const double* p, double* o) {
    const double2 v = *reinterpret_cast<const double2*>(p);
    o[0] = v.x; o[1] = v.y;
  }
};
template <> struct Vec16<cplx<float>> {
  static __device__ __forceinline__ void load(const cplx<float>* p, cplx<float>* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = cplx<float>(v.x, v.y); o[1] = cplx<float>(v.z, v.w);
  }
};
template <> struct Vec16<cplx<double>> {
  static __device__ __forceinline__ void load(const cplx<double>* p, cplx<double>* o) {
    const double2 v = *reinterpret_cast<const double2*>(p);
    o[0] = cplx<double>(v.x, v.y);
  }
};

}  // namespace htool_mv
