// K6: the Chebyshev smoother's vector update, one pass per step.
//
//     cheb_first: p1      = scale (d (b - A x0)) + x0     (r = b when A x0
//                                                          is not given)
//     cheb_step:  p_{k+1} = omega ((scale (d (b - A p_k)) + p_k) - p_{k-1})
//                           + p_{k-1}
//     cheb_first_masked / cheb_step_masked: the same with A x = y ks + ms x
//                           formed in the loads from the raw apply y and
//                           the Dirichlet keep / mask vectors (the cart
//                           path's fine level, whose halo exchange sits
//                           between K1's raw output and the mask terms)
//
// Replaces the loop body of exsaddle_tpu/treeops.py:167 cheb_smooth (the
// PETSc Chebyshev recurrence with a Jacobi preconditioner d = 1/diag A),
// which XLA fused, and on the stencil levels unrolled, on the TPU. The
// operator apply A p_k stays outside (K1 or the Mp apply); this kernel
// takes its result. On the stencil levels K4, and on the single-device
// fine level K1's node gather, compute the update in their store instead.
//
// Bound on an H100 SXM: a step reads 5 vectors and writes 1, 7 FLOP per
// entry. On the mx=32 fine level (823,875 entries) that is 19.8 MB in
// float32: ~5.9 us at 3.35 TB/s; the operations take 0.09 us at 67
// TFLOP/s. Bytes bound it; the plain version's 7 elementwise kernels move
// ~69 MB. Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py, phase
// mg_kernels; 50 steps replayed as one graph, so the 19.8 MB stay in the
// 50 MB L2): 3.7 us per fine float32 step, below the HBM bound; 1.5-1.8 us
// at the L-2 and p sizes, where one launch's latency bounds it.
//
// Design: one thread per entry, scalar coalesced loads (vectors here may
// start at any offset: the p-block's right-hand side is a view into the
// saddle vector). Bitwise with its plain twin (kernels/cheb.py): the
// arithmetic is cheb_math.cuh's explicitly rounded intrinsics in the twin's
// order, so nvcc contracts nothing into an FMA, and the host scalars arrive
// rounded to the working dtype as torch rounds a Python scalar. The
// smoother therefore computes the same bits as the plain torch ops and
// cannot move an iteration count.

#include <cuda_runtime.h>

#include "cheb_math.cuh"

namespace {

using cheb_math::sub;

constexpr int THREADS = 256;

template <typename T>
__global__ void cheb_first_kernel(const T* __restrict__ b,
                                  const T* __restrict__ ax0,
                                  const T* __restrict__ d,
                                  const T* __restrict__ x0, T scale,
                                  T* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const T r = ax0 == nullptr ? b[i] : sub(b[i], ax0[i]);
  out[i] = cheb_math::first(r, d[i], x0[i], scale);
}

template <typename T>
__global__ void cheb_step_kernel(const T* __restrict__ b,
                                 const T* __restrict__ ap,
                                 const T* __restrict__ d,
                                 const T* __restrict__ pk,
                                 const T* __restrict__ pkm1, T scale, T omega,
                                 T* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  out[i] = cheb_math::step(b[i], ap[i], d[i], pk[i], pkm1[i], scale, omega);
}

// y: the raw apply of x0 (p_k); ks, ms: the Dirichlet keep and mask
// vectors. A x0 = y ks + ms x0, formed before the update as the twin does.
template <typename T>
__global__ void cheb_first_masked_kernel(
    const T* __restrict__ b, const T* __restrict__ y, const T* __restrict__ ks,
    const T* __restrict__ ms, const T* __restrict__ d,
    const T* __restrict__ x0, T scale, T* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const T x = x0[i];
  const T ax0 = cheb_math::masked(y[i], ks[i], ms[i], x);
  out[i] = cheb_math::first(sub(b[i], ax0), d[i], x, scale);
}

template <typename T>
__global__ void cheb_step_masked_kernel(
    const T* __restrict__ b, const T* __restrict__ y, const T* __restrict__ ks,
    const T* __restrict__ ms, const T* __restrict__ d,
    const T* __restrict__ pk, const T* __restrict__ pkm1, T scale, T omega,
    T* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const T p = pk[i];
  const T ap = cheb_math::masked(y[i], ks[i], ms[i], p);
  out[i] = cheb_math::step(b[i], ap, d[i], p, pkm1[i], scale, omega);
}

unsigned int blocks(long long n) {
  return (unsigned int)((n + THREADS - 1) / THREADS);
}

template <typename T>
int first(const void* b, const void* ax0, const void* d, const void* x0,
          double scale, void* out, long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cheb_first_kernel<T><<<blocks(n), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(b), static_cast<const T*>(ax0),
      static_cast<const T*>(d), static_cast<const T*>(x0),
      static_cast<T>(scale), static_cast<T*>(out), n);
  return (int)cudaGetLastError();
}

template <typename T>
int step(const void* b, const void* ap, const void* d, const void* pk,
         const void* pkm1, double scale, double omega, void* out,
         long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cheb_step_kernel<T><<<blocks(n), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(b), static_cast<const T*>(ap),
      static_cast<const T*>(d), static_cast<const T*>(pk),
      static_cast<const T*>(pkm1), static_cast<T>(scale),
      static_cast<T>(omega), static_cast<T*>(out), n);
  return (int)cudaGetLastError();
}

template <typename T>
int first_masked(const void* b, const void* y, const void* ks,
                 const void* ms, const void* d, const void* x0, double scale,
                 void* out, long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cheb_first_masked_kernel<T><<<blocks(n), THREADS, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(b), static_cast<const T*>(y),
      static_cast<const T*>(ks), static_cast<const T*>(ms),
      static_cast<const T*>(d), static_cast<const T*>(x0),
      static_cast<T>(scale), static_cast<T*>(out), n);
  return (int)cudaGetLastError();
}

template <typename T>
int step_masked(const void* b, const void* y, const void* ks, const void* ms,
                const void* d, const void* pk, const void* pkm1, double scale,
                double omega, void* out, long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cheb_step_masked_kernel<T><<<blocks(n), THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(b), static_cast<const T*>(y),
      static_cast<const T*>(ks), static_cast<const T*>(ms),
      static_cast<const T*>(d), static_cast<const T*>(pk),
      static_cast<const T*>(pkm1), static_cast<T>(scale),
      static_cast<T>(omega), static_cast<T*>(out), n);
  return (int)cudaGetLastError();
}

}  // namespace

// Every vector is a contiguous device array of n entries of one dtype on
// the stream's device (ax0 may be null); out is fully written and aliases
// no input. scale and omega are rounded to the dtype here (round to
// nearest, as torch converts a Python scalar). Returns 0 or the
// cudaError_t of the failed launch.
extern "C" int cheb_first_f32(const void* b, const void* ax0, const void* d,
                              const void* x0, double scale, void* out,
                              long long n, void* stream) {
  return first<float>(b, ax0, d, x0, scale, out, n, stream);
}

extern "C" int cheb_first_f64(const void* b, const void* ax0, const void* d,
                              const void* x0, double scale, void* out,
                              long long n, void* stream) {
  return first<double>(b, ax0, d, x0, scale, out, n, stream);
}

extern "C" int cheb_step_f32(const void* b, const void* ap, const void* d,
                             const void* pk, const void* pkm1, double scale,
                             double omega, void* out, long long n,
                             void* stream) {
  return step<float>(b, ap, d, pk, pkm1, scale, omega, out, n, stream);
}

extern "C" int cheb_step_f64(const void* b, const void* ap, const void* d,
                             const void* pk, const void* pkm1, double scale,
                             double omega, void* out, long long n,
                             void* stream) {
  return step<double>(b, ap, d, pk, pkm1, scale, omega, out, n, stream);
}

// The masked forms: y is the raw apply (K1 with the keep in its loads, the
// halo planes added), ks / ms the keep and mask vectors, all of n entries.
extern "C" int cheb_first_masked_f32(const void* b, const void* y,
                                     const void* ks, const void* ms,
                                     const void* d, const void* x0,
                                     double scale, void* out, long long n,
                                     void* stream) {
  return first_masked<float>(b, y, ks, ms, d, x0, scale, out, n, stream);
}

extern "C" int cheb_first_masked_f64(const void* b, const void* y,
                                     const void* ks, const void* ms,
                                     const void* d, const void* x0,
                                     double scale, void* out, long long n,
                                     void* stream) {
  return first_masked<double>(b, y, ks, ms, d, x0, scale, out, n, stream);
}

extern "C" int cheb_step_masked_f32(const void* b, const void* y,
                                    const void* ks, const void* ms,
                                    const void* d, const void* pk,
                                    const void* pkm1, double scale,
                                    double omega, void* out, long long n,
                                    void* stream) {
  return step_masked<float>(b, y, ks, ms, d, pk, pkm1, scale, omega, out, n,
                            stream);
}

extern "C" int cheb_step_masked_f64(const void* b, const void* y,
                                    const void* ks, const void* ms,
                                    const void* d, const void* pk,
                                    const void* pkm1, double scale,
                                    double omega, void* out, long long n,
                                    void* stream) {
  return step_masked<double>(b, y, ks, ms, d, pk, pkm1, scale, omega, out,
                             n, stream);
}
