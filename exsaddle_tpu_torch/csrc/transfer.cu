// K5: the multigrid transfers of the ABF V-cycle, one launch per transfer.
//
//     prolong_parity    coarse node grid -> the fine level's flat parity
//                       layout (its 2^ndim class sub-grids one after
//                       another); fused: + x in the store
//     restrict_parity   its transpose, fine parity layout -> coarse grid;
//                       fused: restricts b - y, formed in the loads
//     prolong_grid      separable multilinear interpolation between node
//                       grids (spatial dims leading, dof trailing), every
//                       axis in one pass; fused: + x in the store
//     restrict_grid     its transpose, every axis in one pass
//
// Replaces exsaddle_tpu/abf.py:110 prolong_parity, :132 restrict_parity,
// :150 prolong_grid (with _prolong_axis :161) and :171 restrict_grid (with
// _restrict_axis :180), which XLA fused on the TPU; their plain twins are
// kernels/transfer.py's *_plain (a Python loop of slices, per-class cats
// and in-place adds: ~28-55 small launches per parity transfer, ~12-15 per
// grid transfer).
//
// Bound on an H100 SXM: bytes. Each input value is read once and each
// output written once: at mx=32 in float32 the fine-level pair moves
// 3.73 MB (0.43 MB coarse + 3.30 MB fine), 7.02 MB with the fused add or
// residual (one more fine vector), 1.1-2.1 us at 3.35 TB/s; float64 twice
// that. The deep grid pair moves ~0.5 MB: one launch's latency bounds it.
// The operations (<= 27 adds and multiplies per output) are nanoseconds.
//
// Design: a gather, one thread per output value, threads along the fastest
// axis (x, the dof trailing), so neighbouring threads touch neighbouring
// class or grid entries; no atomics, so the result is deterministic. Index
// arithmetic is 32-bit (every array holds < 2^31 values): a thread's
// coordinate decode is a few integer divides, and 64-bit ones, which the
// card emulates, made the first version integer-bound (12 us per fine
// transfer against a 1.1-2.1 us byte bound on an H100). Each
// output evaluates the twin's arithmetic in the twin's order with
// explicitly rounded intrinsics (__fadd_rn, __fmul_rn, __fsub_rn and the
// __d* forms; nvcc contracts nothing into an FMA), so every kernel is
// bitwise its twin and cannot move an iteration count:
//   - prolong_parity sums a class's 2^popcount(bits) coarse reads in
//     itertools.product order, then scales by w = 0.5^popcount (exact);
//   - restrict_parity starts from 0 (the twin's zeros, so the sign of a
//     zero matches) and adds w * sub class by class, each class's deltas
//     in product order, for every in-range fine coordinate c - delta;
//   - the grid pair evaluates the twin's per-axis recurrence nested in
//     its axis order (axis 0 innermost): odd prolongation slots are
//     0.5 * (a + b), restriction is (x[2j] + 0.5 x[2j+1]) + 0.5 x[2j-1],
//     the order of _restrict_axis's two in-place adds. Inner values are
//     recomputed per output, not shared: a few redundant reads, no
//     intermediate grid in memory.
// The fused add is one more __fadd_rn in the store (IEEE addition is
// commutative, so p + x and x + p give the same bits).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }

// The fine parity layout of one transfer. Spatial dims are reversed (z, y,
// x in 3D); class p has parity bit (p >> (NDIM - 1 - dim)) & 1 along dim.
struct Parity {
  int cshape[3];       // coarse nodes per dim
  int shp[8][3];       // class p's nodes per dim
  unsigned off[9];     // class p's first value in the flat vector
};

// Node grids of a grid transfer: nc coarse and nf = 2 nc - 1 fine nodes
// per dim.
struct Grid {
  int nc[3];
  int nf[3];
};

// Values per array stay below 2^31 (the launchers refuse more).
constexpr long long MAX_VALUES = 1LL << 31;

template <int NDIM>
__device__ __forceinline__ int class_bit(int p, int dim) {
  return (p >> (NDIM - 1 - dim)) & 1;
}

// The weight 0.5^popcount of a class with pc parity bits set (exact).
template <typename T>
__device__ __forceinline__ T class_weight(int pc) {
  return pc == 0 ? T(1) : pc == 1 ? T(0.5) : pc == 2 ? T(0.25) : T(0.125);
}

// Term t of class p's itertools.product(*[range(b + 1) for b in bits])
// (bits x-first, the last factor fastest): the set bits of t go to the
// set parity bits from dim 0 (the last spatial factor) upwards.
template <int NDIM>
__device__ __forceinline__ void class_delta(int p, int t, int (&delta)[NDIM]) {
#pragma unroll
  for (int dim = 0; dim < NDIM; ++dim) {
    if (class_bit<NDIM>(p, dim)) {
      delta[dim] = t & 1;
      t >>= 1;
    } else {
      delta[dim] = 0;
    }
  }
}

template <int NDIM>
__device__ __forceinline__ int popcount_class(int p) {
  int pc = 0;
#pragma unroll
  for (int dim = 0; dim < NDIM; ++dim) pc += class_bit<NDIM>(p, dim);
  return pc;
}

template <typename T, int NDIM, int ND, bool ADD>
__global__ void prolong_parity_kernel(const T* __restrict__ xc,
                                      const T* __restrict__ xadd,
                                      T* __restrict__ out, Parity P,
                                      unsigned n) {
  const unsigned i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  int p = 0;
  while (p + 1 < (1 << NDIM) && i >= P.off[p + 1]) ++p;
  const unsigned e = i - P.off[p];
  const unsigned d = e % ND;
  unsigned node = e / ND;
  unsigned f[NDIM];
#pragma unroll
  for (int dim = NDIM - 1; dim >= 0; --dim) {
    const unsigned s = P.shp[p][dim];
    f[dim] = node % s;
    node /= s;
  }
  const int pc = popcount_class<NDIM>(p);
  T acc = T(0);
  for (int t = 0; t < (1 << pc); ++t) {
    int delta[NDIM];
    class_delta<NDIM>(p, t, delta);
    unsigned lin = 0;
#pragma unroll
    for (int dim = 0; dim < NDIM; ++dim)
      lin = lin * P.cshape[dim] + f[dim] + delta[dim];
    const T v = xc[lin * ND + d];
    acc = t == 0 ? v : add(acc, v);
  }
  T y = mul(class_weight<T>(pc), acc);
  if (ADD) y = add(y, xadd[i]);
  out[i] = y;
}

template <typename T, int NDIM, int ND, bool RES>
__global__ void restrict_parity_kernel(const T* __restrict__ b,
                                       const T* __restrict__ y,
                                       T* __restrict__ out, Parity P,
                                       unsigned n) {
  const unsigned i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const unsigned d = i % ND;
  unsigned node = i / ND;
  int c[NDIM];
#pragma unroll
  for (int dim = NDIM - 1; dim >= 0; --dim) {
    const unsigned s = P.cshape[dim];
    c[dim] = (int)(node % s);
    node /= s;
  }
  T acc = T(0);
  for (int p = 0; p < (1 << NDIM); ++p) {
    const int pc = popcount_class<NDIM>(p);
    const T w = class_weight<T>(pc);
    for (int t = 0; t < (1 << pc); ++t) {
      int delta[NDIM];
      class_delta<NDIM>(p, t, delta);
      unsigned lin = 0;
      bool in = true;
#pragma unroll
      for (int dim = 0; dim < NDIM; ++dim) {
        const int fd = c[dim] - delta[dim];
        in = in && fd >= 0 && fd < P.shp[p][dim];
        lin = lin * P.shp[p][dim] + fd;
      }
      if (!in) continue;
      const unsigned k = P.off[p] + lin * ND + d;
      const T v = RES ? sub(b[k], y[k]) : b[k];
      acc = add(acc, mul(w, v));
    }
  }
  out[i] = acc;
}

// prolong_grid's value at c after axes 0..A (fine along dims 0..A, coarse
// along the rest): the twin's _prolong_axis along A over the value after
// axes 0..A-1.
template <typename T, int A, int NDIM, int ND>
__device__ __forceinline__ T prolong_at(const T* __restrict__ x,
                                        const Grid& g, int (&c)[NDIM],
                                        unsigned d) {
  if constexpr (A < 0) {
    unsigned lin = 0;
#pragma unroll
    for (int dim = 0; dim < NDIM; ++dim) lin = lin * g.nc[dim] + c[dim];
    return x[lin * ND + d];
  } else {
    const int f = c[A];
    c[A] = f >> 1;
    T v = prolong_at<T, A - 1, NDIM, ND>(x, g, c, d);
    if (f & 1) {
      c[A] = (f >> 1) + 1;
      v = mul(T(0.5), add(v, prolong_at<T, A - 1, NDIM, ND>(x, g, c, d)));
    }
    c[A] = f;
    return v;
  }
}

// restrict_grid's value at c after axes 0..A (coarse along dims 0..A, fine
// along the rest): the twin's _restrict_axis along A,
// (x[2j] + 0.5 x[2j+1]) + 0.5 x[2j-1], over the value after axes 0..A-1.
template <typename T, int A, int NDIM, int ND>
__device__ __forceinline__ T restrict_at(const T* __restrict__ x,
                                         const Grid& g, int (&c)[NDIM],
                                         unsigned d) {
  if constexpr (A < 0) {
    unsigned lin = 0;
#pragma unroll
    for (int dim = 0; dim < NDIM; ++dim) lin = lin * g.nf[dim] + c[dim];
    return x[lin * ND + d];
  } else {
    const int j = c[A];
    c[A] = 2 * j;
    T v = restrict_at<T, A - 1, NDIM, ND>(x, g, c, d);
    if (j + 1 < g.nc[A]) {
      c[A] = 2 * j + 1;
      v = add(v, mul(T(0.5), restrict_at<T, A - 1, NDIM, ND>(x, g, c, d)));
    }
    if (j > 0) {
      c[A] = 2 * j - 1;
      v = add(v, mul(T(0.5), restrict_at<T, A - 1, NDIM, ND>(x, g, c, d)));
    }
    c[A] = j;
    return v;
  }
}

template <typename T, int NDIM, int ND, bool ADD>
__global__ void prolong_grid_kernel(const T* __restrict__ xc,
                                    const T* __restrict__ xadd,
                                    T* __restrict__ out, Grid g,
                                    unsigned n) {
  const unsigned i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const unsigned d = i % ND;
  unsigned node = i / ND;
  int c[NDIM];
#pragma unroll
  for (int dim = NDIM - 1; dim >= 0; --dim) {
    const unsigned s = g.nf[dim];
    c[dim] = (int)(node % s);
    node /= s;
  }
  T v = prolong_at<T, NDIM - 1, NDIM, ND>(xc, g, c, d);
  if (ADD) v = add(v, xadd[i]);
  out[i] = v;
}

template <typename T, int NDIM, int ND>
__global__ void restrict_grid_kernel(const T* __restrict__ x,
                                     T* __restrict__ out, Grid g,
                                     unsigned n) {
  const unsigned i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const unsigned d = i % ND;
  unsigned node = i / ND;
  int c[NDIM];
#pragma unroll
  for (int dim = NDIM - 1; dim >= 0; --dim) {
    const unsigned s = g.nc[dim];
    c[dim] = (int)(node % s);
    node /= s;
  }
  out[i] = restrict_at<T, NDIM - 1, NDIM, ND>(x, g, c, d);
}

unsigned int blocks(unsigned n) { return (n + THREADS - 1) / THREADS; }

bool supported(int ndim, int nd) {
  return (ndim == 2 || ndim == 3) && (nd == 2 || nd == 3);
}

// shapes: the coarse grid's ndim node counts, then each class's (2^ndim
// of them), reversed dims. Returns the flat fine length, or -1.
long long parity_layout(const int* shapes, int ndim, int nd, Parity* P) {
  long long off = 0, coarse = nd;
  for (int dim = 0; dim < ndim; ++dim) {
    P->cshape[dim] = shapes[dim];
    coarse *= shapes[dim];
  }
  for (int p = 0; p < (1 << ndim); ++p) {
    long long cnt = nd;
    for (int dim = 0; dim < ndim; ++dim) {
      const int s = shapes[ndim * (p + 1) + dim];
      const int bit = (p >> (ndim - 1 - dim)) & 1;
      if (s < 1 || s + bit > P->cshape[dim]) return -1;
      P->shp[p][dim] = s;
      cnt *= s;
    }
    P->off[p] = (unsigned)off;
    off += cnt;
    if (off >= MAX_VALUES) return -1;
  }
  if (coarse >= MAX_VALUES) return -1;
  P->off[1 << ndim] = (unsigned)off;
  return off;
}

long long grid_layout(const int* nc, int ndim, int nd, Grid* g,
                      bool fine_out) {
  long long fine = nd, coarse = nd;
  for (int dim = 0; dim < ndim; ++dim) {
    if (nc[dim] < 1) return -1;
    g->nc[dim] = nc[dim];
    g->nf[dim] = 2 * nc[dim] - 1;
    fine *= g->nf[dim];
    coarse *= g->nc[dim];
  }
  if (fine >= MAX_VALUES) return -1;
  return fine_out ? fine : coarse;
}

// Calls F::template run<NDIM, ND>() for the runtime (ndim, nd).
template <typename F>
int dispatch(int ndim, int nd, F f) {
  if (ndim == 2 && nd == 2) return f.template run<2, 2>();
  if (ndim == 2 && nd == 3) return f.template run<2, 3>();
  if (ndim == 3 && nd == 2) return f.template run<3, 2>();
  if (ndim == 3 && nd == 3) return f.template run<3, 3>();
  return (int)cudaErrorInvalidValue;
}

template <typename T>
struct ProlongParity {
  const T* xc;
  const T* xadd;
  T* out;
  Parity P;
  unsigned n;
  cudaStream_t s;
  template <int NDIM, int ND>
  int run() const {
    if (xadd != nullptr)
      prolong_parity_kernel<T, NDIM, ND, true>
          <<<blocks(n), THREADS, 0, s>>>(xc, xadd, out, P, n);
    else
      prolong_parity_kernel<T, NDIM, ND, false>
          <<<blocks(n), THREADS, 0, s>>>(xc, xadd, out, P, n);
    return (int)cudaGetLastError();
  }
};

template <typename T>
struct RestrictParity {
  const T* b;
  const T* y;
  T* out;
  Parity P;
  unsigned n;
  cudaStream_t s;
  template <int NDIM, int ND>
  int run() const {
    if (y != nullptr)
      restrict_parity_kernel<T, NDIM, ND, true>
          <<<blocks(n), THREADS, 0, s>>>(b, y, out, P, n);
    else
      restrict_parity_kernel<T, NDIM, ND, false>
          <<<blocks(n), THREADS, 0, s>>>(b, y, out, P, n);
    return (int)cudaGetLastError();
  }
};

template <typename T>
struct ProlongGrid {
  const T* xc;
  const T* xadd;
  T* out;
  Grid g;
  unsigned n;
  cudaStream_t s;
  template <int NDIM, int ND>
  int run() const {
    if (xadd != nullptr)
      prolong_grid_kernel<T, NDIM, ND, true>
          <<<blocks(n), THREADS, 0, s>>>(xc, xadd, out, g, n);
    else
      prolong_grid_kernel<T, NDIM, ND, false>
          <<<blocks(n), THREADS, 0, s>>>(xc, xadd, out, g, n);
    return (int)cudaGetLastError();
  }
};

template <typename T>
struct RestrictGrid {
  const T* x;
  T* out;
  Grid g;
  unsigned n;
  cudaStream_t s;
  template <int NDIM, int ND>
  int run() const {
    restrict_grid_kernel<T, NDIM, ND><<<blocks(n), THREADS, 0, s>>>(x, out,
                                                                     g, n);
    return (int)cudaGetLastError();
  }
};

template <typename T>
int prolong_parity(const void* xc, const void* xadd, void* out,
                   const int* shapes, int ndim, int nd, void* stream) {
  if (!supported(ndim, nd)) return (int)cudaErrorInvalidValue;
  Parity P = {};
  const long long n = parity_layout(shapes, ndim, nd, &P);
  if (n <= 0) return (int)cudaErrorInvalidValue;
  return dispatch(ndim, nd, ProlongParity<T>{
      static_cast<const T*>(xc), static_cast<const T*>(xadd),
      static_cast<T*>(out), P, (unsigned)n,
      static_cast<cudaStream_t>(stream)});
}

template <typename T>
int restrict_parity(const void* b, const void* y, void* out,
                    const int* shapes, int ndim, int nd, void* stream) {
  if (!supported(ndim, nd)) return (int)cudaErrorInvalidValue;
  Parity P = {};
  if (parity_layout(shapes, ndim, nd, &P) <= 0)
    return (int)cudaErrorInvalidValue;
  long long n = nd;
  for (int dim = 0; dim < ndim; ++dim) n *= P.cshape[dim];
  return dispatch(ndim, nd, RestrictParity<T>{
      static_cast<const T*>(b), static_cast<const T*>(y),
      static_cast<T*>(out), P, (unsigned)n,
      static_cast<cudaStream_t>(stream)});
}

template <typename T>
int prolong_grid(const void* xc, const void* xadd, void* out, const int* nc,
                 int ndim, int nd, void* stream) {
  if (!supported(ndim, nd)) return (int)cudaErrorInvalidValue;
  Grid g = {};
  const long long n = grid_layout(nc, ndim, nd, &g, true);
  if (n <= 0) return (int)cudaErrorInvalidValue;
  return dispatch(ndim, nd, ProlongGrid<T>{
      static_cast<const T*>(xc), static_cast<const T*>(xadd),
      static_cast<T*>(out), g, (unsigned)n,
      static_cast<cudaStream_t>(stream)});
}

template <typename T>
int restrict_grid(const void* x, void* out, const int* nc, int ndim, int nd,
                  void* stream) {
  if (!supported(ndim, nd)) return (int)cudaErrorInvalidValue;
  Grid g = {};
  const long long n = grid_layout(nc, ndim, nd, &g, false);
  if (n <= 0) return (int)cudaErrorInvalidValue;
  return dispatch(ndim, nd, RestrictGrid<T>{
      static_cast<const T*>(x), static_cast<T*>(out), g, (unsigned)n,
      static_cast<cudaStream_t>(stream)});
}

}  // namespace

// Every array is a contiguous device array of one dtype on the stream's
// device; out is fully written and aliases no input. The host int arrays:
// parity shapes = the coarse grid's ndim node counts (reversed dims), then
// each of the 2^ndim classes' ndim node counts; nc = the coarse grid's
// ndim node counts (the fine grid has 2 nc - 1). xadd (prolongations) and
// y (restrict_parity) may be null: the unfused form. Returns 0 or the
// cudaError_t of the failed launch (cudaErrorInvalidValue for a shape or
// (ndim, nd) the kernels do not take).
extern "C" int k5_prolong_parity_f32(const void* xc, const void* xadd,
                                     void* out, const int* shapes, int ndim,
                                     int nd, void* stream) {
  return prolong_parity<float>(xc, xadd, out, shapes, ndim, nd, stream);
}

extern "C" int k5_prolong_parity_f64(const void* xc, const void* xadd,
                                     void* out, const int* shapes, int ndim,
                                     int nd, void* stream) {
  return prolong_parity<double>(xc, xadd, out, shapes, ndim, nd, stream);
}

extern "C" int k5_restrict_parity_f32(const void* b, const void* y,
                                      void* out, const int* shapes, int ndim,
                                      int nd, void* stream) {
  return restrict_parity<float>(b, y, out, shapes, ndim, nd, stream);
}

extern "C" int k5_restrict_parity_f64(const void* b, const void* y,
                                      void* out, const int* shapes, int ndim,
                                      int nd, void* stream) {
  return restrict_parity<double>(b, y, out, shapes, ndim, nd, stream);
}

extern "C" int k5_prolong_grid_f32(const void* xc, const void* xadd,
                                   void* out, const int* nc, int ndim, int nd,
                                   void* stream) {
  return prolong_grid<float>(xc, xadd, out, nc, ndim, nd, stream);
}

extern "C" int k5_prolong_grid_f64(const void* xc, const void* xadd,
                                   void* out, const int* nc, int ndim, int nd,
                                   void* stream) {
  return prolong_grid<double>(xc, xadd, out, nc, ndim, nd, stream);
}

extern "C" int k5_restrict_grid_f32(const void* x, void* out, const int* nc,
                                    int ndim, int nd, void* stream) {
  return restrict_grid<float>(x, out, nc, ndim, nd, stream);
}

extern "C" int k5_restrict_grid_f64(const void* x, void* out, const int* nc,
                                    int ndim, int nd, void* stream) {
  return restrict_grid<double>(x, out, nc, ndim, nd, stream);
}
