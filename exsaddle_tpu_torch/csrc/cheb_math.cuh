// K6's arithmetic, shared by every kernel that computes a Chebyshev update
// or the Dirichlet mask terms in its store or loads (cheb_update.cu, and K1's
// fused node gather in a00_apply.cu), so that they cannot drift apart.
//
//     masked:     y ks + ms x                       (abf.mult_u_tree's terms)
//     cheb_first: scale (d (b - ax0)) + x0          (r = b when ax0 is none)
//     cheb_step:  omega ((scale (d (b - ap)) + p_k) - p_{k-1}) + p_{k-1}
//
// Every operation is an explicitly rounded intrinsic in the plain twin's
// order (kernels/cheb.py, kernels/a00.py), so nvcc contracts nothing into
// an FMA and each kernel gives the bits of the torch ops it replaces.

#pragma once

#include <cuda_runtime.h>

namespace cheb_math {

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }

// (y * ks) + (ms * x): the keep/mask Dirichlet elimination of a raw apply
template <typename T>
__device__ __forceinline__ T masked(T y, T ks, T ms, T x) {
  return add(mul(y, ks), mul(ms, x));
}

// the first Chebyshev iterate from the residual r = b - A x0 (or b)
template <typename T>
__device__ __forceinline__ T first(T r, T d, T x0, T scale) {
  return add(mul(scale, mul(d, r)), x0);
}

// one Chebyshev step from ap = A p_k
template <typename T>
__device__ __forceinline__ T step(T b, T ap, T d, T pk, T pm, T scale,
                                  T omega) {
  const T t = add(mul(scale, mul(d, sub(b, ap))), pk);
  return add(mul(omega, sub(t, pm)), pm);
}

}  // namespace cheb_math
