// K6: the Chebyshev smoother's vector update, one pass per step.
//
//     cheb_first: p1      = scale (d (b - A x0)) + x0     (r = b when A x0
//                                                          is not given)
//     cheb_step:  p_{k+1} = omega ((scale (d (b - A p_k)) + p_k) - p_{k-1})
//                           + p_{k-1}
//
// Replaces the loop body of exsaddle_tpu/treeops.py:167 cheb_smooth (the
// PETSc Chebyshev recurrence with a Jacobi preconditioner d = 1/diag A),
// which XLA fused, and on the stencil levels unrolled, on the TPU. The
// operator apply A p_k stays outside (K1, K4 or the Mp apply); this
// kernel takes its result.
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
// saddle vector). Bitwise with its plain twin (kernels/cheb.py): every
// operation is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn,
// __fsub_rn and the __d* forms) in the twin's order, so nvcc contracts
// nothing into an FMA, and the host scalars arrive rounded to the working
// dtype as torch rounds a Python scalar. The smoother therefore computes
// the same bits as the plain torch ops and cannot move an iteration count.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }

template <typename T>
__global__ void cheb_first_kernel(const T* __restrict__ b,
                                  const T* __restrict__ ax0,
                                  const T* __restrict__ d,
                                  const T* __restrict__ x0, T scale,
                                  T* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const T r = ax0 == nullptr ? b[i] : sub(b[i], ax0[i]);
  out[i] = add(mul(scale, mul(d[i], r)), x0[i]);
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
  const T z = mul(d[i], sub(b[i], ap[i]));
  const T t = add(mul(scale, z), pk[i]);
  const T pm = pkm1[i];
  out[i] = add(mul(omega, sub(t, pm)), pm);
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
