// K7: classical Gram-Schmidt of a Krylov step against the live rows of its
// fixed-shape window, three launches per orthogonalisation:
//
//     gs_dots:      h[j] = sum_i V[j, i] (w_i t_i)   for j < L, 0 for L <= j < rows
//     gs_combine:   v' = v - sum_{j<L} h_j V_j  (and s' = s - sum_{j<L} h_j S_j)
//                   with sumsq = sum_i (w_i v'_i) v'_i of the same pass
//     gs_normalize: alpha = sqrt(sumsq), v' (and s') scaled by 1 / alpha
//                   (1 where alpha is 0) into the window row V[ix] (S[ix])
//                   and, for GCR, in place
//
// L, the window's live rows, is read on the device: `*live + plus` clamped
// to [0, rows] (GCR: its nv, plus 0; FGMRES: its it, plus 1). The grids are
// sized from n alone and the row loops are bounded inside the kernels, so a
// CUDA graph holds them at one fixed shape and no host read is needed. w is
// the sharded layouts' ownership weight (null on one device); between the
// launches the sharded solvers sum the dots and sumsq over the shards.
//
// Replaces the masked whole-window products of exsaddle_tpu/treeops.py:106
// buf_dots and :128 buf_comb (XLA fusions on the TPU; before this kernel the
// port ran them as torch ops and cuBLAS gemvs over all rows). Bound on an H100
// SXM: the bytes of the live rows. A GCR step with L live rows reads L + 1
// vectors for the dots, 2 L + 2 and writes 2 for the combination, reads 2
// and writes 4 for the normalisation: at the mx=32 fine level (823,875
// entries, 3.3 MB a float32 vector) and L = 2, 56 MB, ~17 us at 3.35 TB/s,
// against the ~300 MB that the whole 30-row windows cost each step.
//
// Design: block b takes the CHUNK entries from b CHUNK, thread t the entries
// b CHUNK + k THREADS + t (k < ITEMS, coalesced). Each thread loads its
// entries of t once and then each live row's; it sums its products in k
// order, a warp folds its lanes by shuffles (offsets 16, 8, 4, 2, 1), the
// block adds its warps in order into one partial per block, and the last
// block to finish (a ticket taken with atomicInc, which wraps back to 0)
// folds the partials: lane l adds partials l, l + 32, ... in order, then the
// warp's shuffle fold. No floating-point atomics: every replay and every
// card gives the same bits, and the plain twin (kernels/gram_schmidt.py)
// repeats that order with the same explicitly rounded operations
// (cheb_math.cuh's __f*_rn / __d*_rn intrinsics: nvcc contracts nothing
// into an FMA), so the kernels are bitwise their twin.

#include <cuda_runtime.h>

#include "cheb_math.cuh"

namespace {

using cheb_math::add;
using cheb_math::mul;
using cheb_math::sub;

constexpr int THREADS = 256;
constexpr int ITEMS = 4;
constexpr int CHUNK = THREADS * ITEMS;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_ROWS = 64;

__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

__device__ __forceinline__ int live_rows(const int* live, int plus, int rows) {
  const int l = *live + plus;
  return l < 0 ? 0 : (l > rows ? rows : l);
}

// lane 0 ends with the fold of the warp's 32 values: v_l + v_{l + off} for
// off = 16, 8, 4, 2, 1
template <typename T>
__device__ __forceinline__ T warp_fold(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = add(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

// the fold of nb per-block partials p[0..nb) by one warp: lane l adds
// p[l], p[l + 32], ... in order from 0, then the warp's fold (lane 0)
template <typename T>
__device__ __forceinline__ T fold_partials(const T* p, int nb, int lane) {
  T acc = T(0);
  for (int b = lane; b < nb; b += 32) acc = add(acc, __ldcg(p + b));
  return warp_fold(acc);
}

// every block's partials written (before the call): true in the last block
// to arrive, whose reads of the partials then see them all
__device__ __forceinline__ bool last_block(unsigned int* ticket) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  return last;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gs_dots_kernel(const T* __restrict__ V, const T* __restrict__ t,
               const T* __restrict__ w, long long n, int rows,
               const int* __restrict__ live, int plus, T* __restrict__ part,
               unsigned int* ticket, T* __restrict__ h,
               long long* __restrict__ count) {
  __shared__ T red[MAX_ROWS][WARPS];
  const int L = live_rows(live, plus, rows);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = (long long)blockIdx.x * CHUNK + threadIdx.x;
  T tv[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = base + (long long)k * THREADS;
    tv[k] = i < n ? (w == nullptr ? t[i] : mul(w[i], t[i])) : T(0);
  }
  for (int j = 0; j < L; ++j) {
    const T* row = V + (long long)j * n;
    T x[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const long long i = base + (long long)k * THREADS;
      x[k] = i < n ? row[i] : T(0);
    }
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k)
      if (base + (long long)k * THREADS < n) acc = add(acc, mul(x[k], tv[k]));
    acc = warp_fold(acc);
    if (lane == 0) red[j][warp] = acc;
  }
  __syncthreads();
  const int nb = gridDim.x;
  for (int j = threadIdx.x; j < L; j += THREADS) {
    T s = T(0);
#pragma unroll
    for (int q = 0; q < WARPS; ++q) s = add(s, red[j][q]);
    part[(long long)j * nb + blockIdx.x] = s;
  }
  if (!last_block(ticket)) return;
  for (int j = warp; j < rows; j += WARPS) {
    const T s = j < L ? fold_partials(part + (long long)j * nb, nb, lane)
                      : T(0);
    if (lane == 0) h[j] = s;
  }
  if (threadIdx.x == 0 && count != nullptr) *count += L;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gs_combine_kernel(const T* __restrict__ V, const T* __restrict__ S,
                  const T* __restrict__ h, const T* __restrict__ v,
                  const T* __restrict__ s, const T* __restrict__ w,
                  long long n, int rows, const int* __restrict__ live,
                  int plus, T* __restrict__ vout, T* __restrict__ sout,
                  T* __restrict__ part, unsigned int* ticket,
                  T* __restrict__ sumsq) {
  __shared__ T red[WARPS];
  const int L = live_rows(live, plus, rows);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = (long long)blockIdx.x * CHUNK + threadIdx.x;
  T av[ITEMS], as[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) av[k] = as[k] = T(0);
  for (int j = 0; j < L; ++j) {
    const T hj = h[j];
    const T* vr = V + (long long)j * n;
    const T* sr = S == nullptr ? nullptr : S + (long long)j * n;
    T x[ITEMS], y[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const long long i = base + (long long)k * THREADS;
      x[k] = i < n ? vr[i] : T(0);
      y[k] = (sr != nullptr && i < n) ? sr[i] : T(0);
    }
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      av[k] = add(av[k], mul(hj, x[k]));
      if (sr != nullptr) as[k] = add(as[k], mul(hj, y[k]));
    }
  }
  T sq = T(0);
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = base + (long long)k * THREADS;
    if (i < n) {
      const T vo = sub(v[i], av[k]);
      vout[i] = vo;
      if (S != nullptr) sout[i] = sub(s[i], as[k]);
      sq = add(sq, w == nullptr ? mul(vo, vo) : mul(mul(w[i], vo), vo));
    }
  }
  sq = warp_fold(sq);
  if (lane == 0) red[warp] = sq;
  __syncthreads();
  if (threadIdx.x == 0) {
    T b = T(0);
#pragma unroll
    for (int q = 0; q < WARPS; ++q) b = add(b, red[q]);
    part[blockIdx.x] = b;
  }
  if (!last_block(ticket)) return;
  if (warp == 0) {
    const T total = fold_partials(part, (int)gridDim.x, lane);
    if (lane == 0) *sumsq = total;
  }
}

// v (and s) scaled by 1 / alpha into row *ix of V (S) and, with in_place,
// into v (s) itself; alpha to *alpha. One thread per entry.
template <typename T>
__global__ void __launch_bounds__(THREADS)
gs_normalize_kernel(T* v, T* s, const T* __restrict__ sumsq, long long n,
                    int rows, const long long* __restrict__ ix,
                    T* __restrict__ V, T* __restrict__ S,
                    T* __restrict__ alpha, int in_place) {
  const T a = sqrt_rn(*sumsq);
  const T inv = div_rn(T(1), a == T(0) ? T(1) : a);
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i == 0) *alpha = a;
  const long long r = *ix;
  if (i >= n || r < 0 || r >= rows) return;
  const T x = mul(inv, v[i]);
  V[r * n + i] = x;
  if (in_place) v[i] = x;
  if (S != nullptr) {
    const T y = mul(inv, s[i]);
    S[r * n + i] = y;
    if (in_place) s[i] = y;
  }
}

unsigned int chunks(long long n) {
  return (unsigned int)((n + CHUNK - 1) / CHUNK);
}

template <typename T>
int dots(const void* V, const void* t, const void* w, long long n, int rows,
         const void* live, int plus, void* part, void* ticket, void* h,
         void* count, void* stream) {
  if (n <= 0 || rows <= 0 || rows > MAX_ROWS)
    return (int)cudaErrorInvalidValue;
  gs_dots_kernel<T><<<chunks(n), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(V), static_cast<const T*>(t),
      static_cast<const T*>(w), n, rows, static_cast<const int*>(live), plus,
      static_cast<T*>(part), static_cast<unsigned int*>(ticket),
      static_cast<T*>(h), static_cast<long long*>(count));
  return (int)cudaGetLastError();
}

template <typename T>
int combine(const void* V, const void* S, const void* h, const void* v,
            const void* s, const void* w, long long n, int rows,
            const void* live, int plus, void* vout, void* sout, void* part,
            void* ticket, void* sumsq, void* stream) {
  if (n <= 0 || rows <= 0 || rows > MAX_ROWS)
    return (int)cudaErrorInvalidValue;
  gs_combine_kernel<T><<<chunks(n), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(V), static_cast<const T*>(S),
      static_cast<const T*>(h), static_cast<const T*>(v),
      static_cast<const T*>(s), static_cast<const T*>(w), n, rows,
      static_cast<const int*>(live), plus, static_cast<T*>(vout),
      static_cast<T*>(sout), static_cast<T*>(part),
      static_cast<unsigned int*>(ticket), static_cast<T*>(sumsq));
  return (int)cudaGetLastError();
}

template <typename T>
int normalize(void* v, void* s, const void* sumsq, long long n, int rows,
              const void* ix, void* V, void* S, void* alpha, int in_place,
              void* stream) {
  if (n <= 0 || rows <= 0) return (int)cudaErrorInvalidValue;
  gs_normalize_kernel<T><<<(unsigned int)((n + THREADS - 1) / THREADS),
                           THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(v), static_cast<T*>(s), static_cast<const T*>(sumsq),
      n, rows, static_cast<const long long*>(ix), static_cast<T*>(V),
      static_cast<T*>(S), static_cast<T*>(alpha), in_place);
  return (int)cudaGetLastError();
}

}  // namespace

// V (rows, n) and S: contiguous windows; t, v, s, w, vout, sout: contiguous
// vectors of n entries, all of one dtype on the stream's device (w, S, s,
// sout and count may be null). live: int32, ix: int64, one entry each, on
// that device. part: rows * ceil(n / 1024) entries of the dtype; ticket: one
// uint32 that is 0 between launches (each launch leaves it 0). h: rows
// entries; sumsq, alpha: one. count (int64), where given, gets L added.
// Returns 0 or the cudaError_t of the failed launch.
extern "C" int gs_dots_f32(const void* V, const void* t, const void* w,
                           long long n, int rows, const void* live, int plus,
                           void* part, void* ticket, void* h, void* count,
                           void* stream) {
  return dots<float>(V, t, w, n, rows, live, plus, part, ticket, h, count,
                     stream);
}

extern "C" int gs_dots_f64(const void* V, const void* t, const void* w,
                           long long n, int rows, const void* live, int plus,
                           void* part, void* ticket, void* h, void* count,
                           void* stream) {
  return dots<double>(V, t, w, n, rows, live, plus, part, ticket, h, count,
                      stream);
}

extern "C" int gs_combine_f32(const void* V, const void* S, const void* h,
                              const void* v, const void* s, const void* w,
                              long long n, int rows, const void* live,
                              int plus, void* vout, void* sout, void* part,
                              void* ticket, void* sumsq, void* stream) {
  return combine<float>(V, S, h, v, s, w, n, rows, live, plus, vout, sout,
                        part, ticket, sumsq, stream);
}

extern "C" int gs_combine_f64(const void* V, const void* S, const void* h,
                              const void* v, const void* s, const void* w,
                              long long n, int rows, const void* live,
                              int plus, void* vout, void* sout, void* part,
                              void* ticket, void* sumsq, void* stream) {
  return combine<double>(V, S, h, v, s, w, n, rows, live, plus, vout, sout,
                         part, ticket, sumsq, stream);
}

extern "C" int gs_normalize_f32(void* v, void* s, const void* sumsq,
                                long long n, int rows, const void* ix,
                                void* V, void* S, void* alpha, int in_place,
                                void* stream) {
  return normalize<float>(v, s, sumsq, n, rows, ix, V, S, alpha, in_place,
                          stream);
}

extern "C" int gs_normalize_f64(void* v, void* s, const void* sumsq,
                                long long n, int rows, const void* ix,
                                void* V, void* S, void* alpha, int in_place,
                                void* stream) {
  return normalize<double>(v, s, sumsq, n, rows, ix, V, S, alpha, in_place,
                           stream);
}
