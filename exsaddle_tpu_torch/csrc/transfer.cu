// K5: the multigrid transfers of the ABF V-cycle, one launch per transfer.
//
//     prolong_parity    coarse node grid -> the fine level's flat parity
//                       layout (its 2^ndim class sub-grids one after
//                       another); fused: + x in the store
//     restrict_parity   its transpose, fine parity layout -> coarse grid;
//                       fused: restricts b - y (the residual form) or
//                       w * (b - y) (the weighted residual form, the cart
//                       V-cycle's ownership-weighted residual), formed in
//                       the loads; the residual form also computes L-2's
//                       zero-guess first Chebyshev iterate scale (d b) + 0
//                       in its store (restrict_parity_residual_cheb_first)
//     prolong_grid      separable multilinear interpolation between node
//                       grids (spatial dims leading, dof trailing), every
//                       axis in one pass; fused: + x in the store
//     restrict_grid     its transpose, every axis in one pass; fused
//                       (restrict_grid_cheb_first): also the next level's
//                       zero-guess first Chebyshev iterate scale (d b) + 0
//                       in the store
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
// arithmetic is 32-bit (every array holds < 2^31 values). Every kernel
// runs row by row (below): a block's class or plane and rows come from its
// block index, a thread's value from its thread index, so no thread decodes
// a coordinate with runtime divides (a per-value decode made the first
// versions integer-bound), and every term is a compile-time entry of a
// table, so each thread issues all of its loads (the parity pair <= 8
// coarse reads or <= 27 fine ones, each of them two or three in the fused
// forms; the grid pair <= 8 or 27) before the first add. On grids with two
// blocks per SM or more the parity prolongation stages its coarse rows in
// shared memory and a block writes every class's rows of its plane (each
// coarse value leaves L2 about once per block); a cart shard's box keeps a
// block per class as well. Staging the restriction's fine rows the same way
// (cp.async, double-buffered by class), or taking its dx = 1 terms from
// lane - ND by shuffle, measured slower on an H100 (PERF.md). Each output
// evaluates the twin's arithmetic in the twin's order with explicitly
// rounded intrinsics (__fadd_rn, __fmul_rn, __fsub_rn and the __d* forms;
// nvcc contracts nothing into an FMA), so every kernel is bitwise its twin
// and cannot move an iteration count:
//   - prolong_parity sums a class's 2^popcount(bits) coarse reads in
//     itertools.product order, then scales by w = 0.5^popcount (exact);
//   - restrict_parity starts from 0 (the twin's zeros, so the sign of a
//     zero matches) and adds w * sub class by class, each class's deltas
//     in product order, for every in-range fine coordinate c - delta;
//   - the grid pair evaluates the twin's per-axis recurrence nested in
//     its axis order (axis 0 innermost): odd prolongation slots are
//     0.5 * (a + b), restriction is (x[2j] + 0.5 x[2j+1]) + 0.5 x[2j-1],
//     the order of _restrict_axis's two in-place adds, a term out of range
//     skipped. Inner values are recomputed per output, not shared: a few
//     redundant reads, all from L2 (~3.4 per fine value), no intermediate
//     grid in memory.
// The fused add is one more __fadd_rn in the store (IEEE addition is
// commutative, so p + x and x + p give the same bits); the residual forms
// are one __fsub_rn (and one __fmul_rn by the weight) per loaded term; the
// Chebyshev forms are cheb_update.cu's cheb_first arithmetic on the stored
// value with x0 = +0, so they read no x0 and each replaces that K6 launch
// (the parity restriction's through cheb_math.cuh, shared with K6).

#include <cuda_runtime.h>

#include "cheb_math.cuh"

namespace {

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

__host__ __device__ constexpr int class_bit(int ndim, int p, int dim) {
  return (p >> (ndim - 1 - dim)) & 1;
}

__host__ __device__ constexpr int popcount_class(int ndim, int p) {
  int pc = 0;
  for (int dim = 0; dim < ndim; ++dim) pc += class_bit(ndim, p, dim);
  return pc;
}

// The delta along dim of term t of class p's
// itertools.product(*[range(b + 1) for b in bits]) (bits x-first, the
// last factor fastest): the set bits of t go to the set parity bits from
// dim 0 (the last spatial factor) upwards.
__host__ __device__ constexpr int class_delta(int ndim, int p, int t,
                                              int dim) {
  for (int d = 0; d < ndim; ++d) {
    if (class_bit(ndim, p, d)) {
      if (d == dim) return t & 1;
      t >>= 1;
    } else if (d == dim) {
      return 0;
    }
  }
  return 0;
}

// The weight 0.5^popcount of a class with pc parity bits set (exact).
template <typename T>
__device__ __forceinline__ T class_weight(int pc) {
  return pc == 0 ? T(1) : pc == 1 ? T(0.5) : pc == 2 ? T(0.25) : T(0.125);
}

// The parity pair, row by row. A block takes a few consecutive rows of one
// class (prolong_parity: blockIdx.z is the class, blockIdx.y the z plane,
// blockIdx.x the group of y rows) or of the coarse grid (restrict_parity:
// blockIdx.y the z plane, blockIdx.x the group of y rows); its threads run
// along each row's x * ND values (threadIdx.x) and its rows (threadIdx.y),
// so a warp may span two rows, which lie next to each other in memory. A
// class row and the coarse row it reads (or a coarse row and the class
// rows it reads) line up value for value, shifted by dx * ND: no thread
// decodes a coordinate or divides.
constexpr int ROW_THREADS = 320;

// The compile-time table of the restriction's terms: term i is class
// term_class(i)'s term term_index(i), the classes in order, each class's
// terms in product order (the twin's order of in-place adds).
__host__ __device__ constexpr int nterms(int ndim) {
  return ndim == 3 ? 27 : 9;
}

__host__ __device__ constexpr int term_class(int ndim, int i) {
  int p = 0;
  while (i >= (1 << popcount_class(ndim, p))) {
    i -= 1 << popcount_class(ndim, p);
    ++p;
  }
  return p;
}

__host__ __device__ constexpr int term_index(int ndim, int i) {
  int p = 0;
  while (i >= (1 << popcount_class(ndim, p))) {
    i -= 1 << popcount_class(ndim, p);
    ++p;
  }
  return i;
}

template <int NDIM, int I>
struct Term {
  static constexpr int p = term_class(NDIM, I);
  static constexpr int pc = popcount_class(NDIM, p);
  static constexpr int t = term_index(NDIM, I);
  static constexpr int dz = NDIM == 3 ? class_delta(NDIM, p, t, 0) : 0;
  static constexpr int dy = class_delta(NDIM, p, t, NDIM - 2);
  static constexpr int dx = class_delta(NDIM, p, t, NDIM - 1);
};

// What the restriction sums: b, b - y (the residual form), or w * (b - y)
// (the weighted residual form), formed as it is loaded.
enum { PLAIN = 0, RESIDUAL = 1, WEIGHTED = 2 };

template <typename T, int MODE>
__device__ __forceinline__ T term_value(const T* __restrict__ b,
                                        const T* __restrict__ y,
                                        const T* __restrict__ w, int k) {
  if constexpr (MODE == PLAIN) {
    return b[k];
  } else if constexpr (MODE == RESIDUAL) {
    return sub(b[k], y[k]);
  } else {
    return mul(w[k], sub(b[k], y[k]));
  }
}

// Term I onwards of the coarse value j of row (z, yy): load every term,
// an out-of-range one from index 0 (a valid address; the sum skips it), so
// no load waits on a branch and all of them are in flight before the sum.
// Its class's fine row is (z - dz, yy - dy), its value in that row
// j - dx * ND.
template <typename T, int NDIM, int ND, int MODE, int I = 0>
__device__ __forceinline__ void restrict_loads(
    const T* __restrict__ b, const T* __restrict__ y,
    const T* __restrict__ w, const Parity& P, int z, int yy, int j,
    T (&v)[nterms(NDIM)], bool (&ok)[nterms(NDIM)]) {
  if constexpr (I < nterms(NDIM)) {
    using Q = Term<NDIM, I>;
    const int shy = P.shp[Q::p][NDIM - 2];
    const int lx = P.shp[Q::p][NDIM - 1] * ND;
    const int fz = z - Q::dz, fy = yy - Q::dy, jx = j - Q::dx * ND;
    bool in = fy >= 0 && fy < shy && jx >= 0 && jx < lx;
    int frow = fy;
    if constexpr (NDIM == 3) {
      in = in && fz >= 0 && fz < P.shp[Q::p][0];
      frow = fz * shy + fy;
    }
    ok[I] = in;
    v[I] = term_value<T, MODE>(b, y, w,
                               in ? (int)P.off[Q::p] + frow * lx + jx : 0);
    restrict_loads<T, NDIM, ND, MODE, I + 1>(b, y, w, P, z, yy, j, v, ok);
  }
}

// The ordered sum from +0: acc + w_p * v for every in-range term in table
// order. An out-of-range term is skipped, not added as a zero: the twin
// never adds it, and +0 + (-0) would turn a -0 sum into +0.
template <typename T, int NDIM, int I = 0>
__device__ __forceinline__ T restrict_sum(T acc, const T (&v)[nterms(NDIM)],
                                          const bool (&ok)[nterms(NDIM)]) {
  if constexpr (I < nterms(NDIM)) {
    if (ok[I]) acc = add(acc, mul(class_weight<T>(Term<NDIM, I>::pc), v[I]));
    return restrict_sum<T, NDIM, I + 1>(acc, v, ok);
  } else {
    return acc;
  }
}

// CHEB: also p1 = scale (d r) + 0, r the restricted value (K6's
// cheb_first with x0 = +0: L-2's zero-guess first Chebyshev iterate), into
// p1; d is read with the terms, before the sum.
template <typename T, int NDIM, int ND, int MODE, bool CHEB>
__global__ void __launch_bounds__(ROW_THREADS)
restrict_parity_kernel(const T* __restrict__ b, const T* __restrict__ y,
                       const T* __restrict__ w, const T* __restrict__ dinv,
                       T scale, T* __restrict__ out, T* __restrict__ p1,
                       Parity P) {
  const int cy = P.cshape[NDIM - 2];
  const int yy = blockIdx.x * blockDim.y + threadIdx.y;
  if (yy >= cy) return;
  const int z = NDIM == 3 ? (int)blockIdx.y : 0;
  const int L = P.cshape[NDIM - 1] * ND;
  const int o = (z * cy + yy) * L;
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    T v[nterms(NDIM)];
    bool ok[nterms(NDIM)];
    restrict_loads<T, NDIM, ND, MODE>(b, y, w, P, z, yy, j, v, ok);
    const T dv = CHEB ? dinv[o + j] : T(0);
    const T r = restrict_sum<T, NDIM>(T(0), v, ok);
    out[o + j] = r;
    if (CHEB) p1[o + j] = cheb_math::first(r, dv, T(0), scale);
  }
}

// Class PC's rows: each value loads its 2^popcount coarse reads, then sums
// them in product order, scales by the exact weight and adds x.
template <typename T, int NDIM, int ND, bool ADD, int PC>
__device__ __forceinline__ void prolong_rows(const T* __restrict__ xc,
                                             const T* __restrict__ xadd,
                                             T* __restrict__ out,
                                             const Parity& P) {
  constexpr int pc = popcount_class(NDIM, PC);
  const int shy = P.shp[PC][NDIM - 2];
  const int yy = blockIdx.x * blockDim.y + threadIdx.y;
  const int z = NDIM == 3 ? (int)blockIdx.y : 0;
  if (yy >= shy || (NDIM == 3 && z >= P.shp[PC][0])) return;
  const int L = P.shp[PC][NDIM - 1] * ND;
  const int cy = P.cshape[NDIM - 2], cl = P.cshape[NDIM - 1] * ND;
  const int orow = (int)P.off[PC] + (z * shy + yy) * L;
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    T v[1 << pc];
#pragma unroll
    for (int t = 0; t < (1 << pc); ++t) {
      const int dz = NDIM == 3 ? class_delta(NDIM, PC, t, 0) : 0;
      const int dy = class_delta(NDIM, PC, t, NDIM - 2);
      const int dx = class_delta(NDIM, PC, t, NDIM - 1);
      v[t] = xc[((z + dz) * cy + yy + dy) * cl + dx * ND + j];
    }
    const T a = ADD ? xadd[orow + j] : T(0);
    T acc = v[0];
#pragma unroll
    for (int t = 1; t < (1 << pc); ++t) acc = add(acc, v[t]);
    T r = mul(class_weight<T>(pc), acc);
    if (ADD) r = add(r, a);
    out[orow + j] = r;
  }
}

template <typename T, int NDIM, int ND, bool ADD, int PC = 0>
__device__ __forceinline__ void prolong_class(int p, const T* __restrict__ xc,
                                              const T* __restrict__ xadd,
                                              T* __restrict__ out,
                                              const Parity& P) {
  if constexpr (PC < (1 << NDIM)) {
    if (p == PC)
      prolong_rows<T, NDIM, ND, ADD, PC>(xc, xadd, out, P);
    else
      prolong_class<T, NDIM, ND, ADD, PC + 1>(p, xc, xadd, out, P);
  }
}

template <typename T, int NDIM, int ND, bool ADD>
__global__ void __launch_bounds__(ROW_THREADS)
prolong_parity_kernel(const T* __restrict__ xc, const T* __restrict__ xadd,
                      T* __restrict__ out, Parity P) {
  prolong_class<T, NDIM, ND, ADD>(blockIdx.z, xc, xadd, out, P);
}

// The prolongation staged through shared memory, for grids with blocks
// enough to fill the card: a block owns one z plane and blockDim.y y rows
// of every class. It stages the 2 x (rows + 1) coarse rows they read
// (plain loads, one __syncthreads), loads its x values of every class (the
// add form), then writes its value of every class in turn, its terms read
// from shared memory. Each coarse value leaves L2 about once per block,
// not once per class value that reads it.

// Class PC's output index of value j in row (z, y0 + threadIdx.y), or -1.
template <int NDIM, int ND, int PC>
__device__ __forceinline__ int staged_index(const Parity& P, int z, int y0,
                                            int j) {
  const int shy = P.shp[PC][NDIM - 2];
  const int yy = y0 + threadIdx.y;
  const int L = P.shp[PC][NDIM - 1] * ND;
  if (yy >= shy || j >= L || (NDIM == 3 && z >= P.shp[PC][0])) return -1;
  return (int)P.off[PC] + (z * shy + yy) * L + j;
}

template <typename T, int NDIM, int ND, int PC = 0>
__device__ __forceinline__ void staged_adds(const T* __restrict__ xadd,
                                            const Parity& P, int z, int y0,
                                            int j, T (&a)[1 << NDIM]) {
  if constexpr (PC < (1 << NDIM)) {
    const int o = staged_index<NDIM, ND, PC>(P, z, y0, j);
    a[PC] = xadd[o >= 0 ? o : 0];
    staged_adds<T, NDIM, ND, PC + 1>(xadd, P, z, y0, j, a);
  }
}

template <typename T, int NDIM, int ND, bool ADD, int PC = 0>
__device__ __forceinline__ void staged_classes(T* __restrict__ out,
                                               const Parity& P, const T* s,
                                               int z, int y0, int j, int cl,
                                               const T (&a)[1 << NDIM]) {
  if constexpr (PC < (1 << NDIM)) {
    constexpr int pc = popcount_class(NDIM, PC);
    const int rows = blockDim.y + 1;
    const int o = staged_index<NDIM, ND, PC>(P, z, y0, j);
    if (o >= 0) {
      T v[1 << pc];
#pragma unroll
      for (int t = 0; t < (1 << pc); ++t) {
        const int dz = NDIM == 3 ? class_delta(NDIM, PC, t, 0) : 0;
        const int dy = class_delta(NDIM, PC, t, NDIM - 2);
        const int dx = class_delta(NDIM, PC, t, NDIM - 1);
        v[t] = s[(dz * rows + threadIdx.y + dy) * cl + dx * ND + j];
      }
      T acc = v[0];
#pragma unroll
      for (int t = 1; t < (1 << pc); ++t) acc = add(acc, v[t]);
      T r = mul(class_weight<T>(pc), acc);
      if (ADD) r = add(r, a[PC]);
      out[o] = r;
    }
    staged_classes<T, NDIM, ND, ADD, PC + 1>(out, P, s, z, y0, j, cl, a);
  }
}

template <typename T, int NDIM, int ND, bool ADD>
__global__ void __launch_bounds__(ROW_THREADS)
prolong_parity_staged_kernel(const T* __restrict__ xc,
                             const T* __restrict__ xadd,
                             T* __restrict__ out, Parity P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int cz = NDIM == 3 ? P.cshape[0] : 1, cy = P.cshape[NDIM - 2];
  const int cl = P.cshape[NDIM - 1] * ND;
  const int z = NDIM == 3 ? (int)blockIdx.y : 0;
  const int y0 = blockIdx.x * blockDim.y;
  const int rows = blockDim.y + 1;
  // stage row r is plane z + r / rows, row y0 + r % rows: 2 x rows of
  // them in 3D, at most 4 per thread row; each thread loads its values of
  // every row it stages, then stores them
  const int nrow = (NDIM == 3 ? 2 : 1) * rows;
  for (int j = threadIdx.x; j < cl; j += blockDim.x) {
    T tmp[4];
    bool ok[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = threadIdx.y + k * blockDim.y;
      const int q = r >= rows ? 1 : 0;
      const int zz = z + q, yy = y0 + r - q * rows;
      ok[k] = r < nrow && zz < cz && yy < cy;
      tmp[k] = xc[ok[k] ? (zz * cy + yy) * cl + j : 0];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (ok[k]) s[(threadIdx.y + k * blockDim.y) * cl + j] = tmp[k];
  }
  __syncthreads();
  // cl >= every class's row length
  for (int j = threadIdx.x; j < cl; j += blockDim.x) {
    T a[1 << NDIM];
    if (ADD) staged_adds<T, NDIM, ND>(xadd, P, z, y0, j, a);
    staged_classes<T, NDIM, ND, ADD>(out, P, s, z, y0, j, cl, a);
  }
}

// The grid pair, row by row as the parity pair: a block takes blockDim.y
// consecutive output rows of one z plane (blockIdx.y; 0 in 2D) from row
// blockIdx.x * blockDim.y on, its threads run along each row's x * ND
// values. An output's terms are compile-time entries along each axis (the
// restriction's 3: fine 2c, 2c + 1 and 2c - 1; the prolongation's 2: coarse
// f >> 1 and (f + 1) >> 1), so a thread computes its rows' offsets once,
// issues every leaf load (27, 2D 9, for the restriction; 8, 2D 4, for the
// prolongation) before the first add, then evaluates the twin's nested
// per-axis tree in registers, axis 0 innermost.

// The restriction's terms along one axis at coarse coordinate c of nc: the
// fine coordinates 2c, 2c + 1, 2c - 1 (one out of range replaced by 2c, a
// valid address whose value the sum skips) and whether each is in range.
struct Terms {
  int f[3];
  bool ok[3];
};

__device__ __forceinline__ Terms restrict_terms(int c, int nc) {
  Terms t;
  t.ok[0] = true;
  t.ok[1] = c + 1 < nc;
  t.ok[2] = c > 0;
  t.f[0] = 2 * c;
  t.f[1] = t.ok[1] ? 2 * c + 1 : 2 * c;
  t.f[2] = t.ok[2] ? 2 * c - 1 : 2 * c;
  return t;
}

// _restrict_axis at one coarse coordinate, (v0 + 0.5 v1) + 0.5 v2: a term
// out of range is skipped, not added as a zero (+0 + -0 would be +0).
template <typename T>
__device__ __forceinline__ T restrict_axis(T v0, T v1, T v2,
                                           const Terms& t) {
  T r = v0;
  if (t.ok[1]) r = add(r, mul(T(0.5), v1));
  if (t.ok[2]) r = add(r, mul(T(0.5), v2));
  return r;
}

// _prolong_axis at one fine coordinate f: v0 at an even one, 0.5 (v0 + v1)
// at an odd one.
template <typename T>
__device__ __forceinline__ T prolong_axis(T v0, T v1, int f) {
  return (f & 1) ? mul(T(0.5), add(v0, v1)) : v0;
}

template <typename T, int NDIM, int ND, bool ADD>
__global__ void __launch_bounds__(ROW_THREADS)
prolong_grid_kernel(const T* __restrict__ xc, const T* __restrict__ xadd,
                    T* __restrict__ out, Grid g) {
  constexpr int NZ = NDIM == 3 ? 2 : 1;
  const int nfy = g.nf[NDIM - 2];
  const int fy = blockIdx.x * blockDim.y + threadIdx.y;
  if (fy >= nfy) return;
  const int fz = NDIM == 3 ? (int)blockIdx.y : 0;
  const int ncy = g.nc[NDIM - 2];
  const int L = g.nf[NDIM - 1] * ND, cl = g.nc[NDIM - 1] * ND;
  const int zc[2] = {fz >> 1, (fz + 1) >> 1};
  const int yc[2] = {fy >> 1, (fy + 1) >> 1};
  int rows[NZ][2];
#pragma unroll
  for (int a = 0; a < NZ; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) rows[a][b] = (zc[a] * ncy + yc[b]) * cl;
  const int o = (fz * nfy + fy) * L;
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    const int fx = j / ND, d = j - fx * ND;
    const int xo[2] = {(fx >> 1) * ND + d, ((fx + 1) >> 1) * ND + d};
    T v[NZ][2][2];
#pragma unroll
    for (int a = 0; a < NZ; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int c = 0; c < 2; ++c) v[a][b][c] = xc[rows[a][b] + xo[c]];
    const T x = ADD ? xadd[o + j] : T(0);
    T vx[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      T vy[2];
#pragma unroll
      for (int b = 0; b < 2; ++b)
        vy[b] = NDIM == 3 ? prolong_axis(v[0][b][c], v[NZ - 1][b][c], fz)
                          : v[0][b][c];
      vx[c] = prolong_axis(vy[0], vy[1], fy);
    }
    T r = prolong_axis(vx[0], vx[1], fx);
    if (ADD) r = add(r, x);
    out[o + j] = r;
  }
}

// CHEB: also p1 = scale (d b) + 0, b the restricted value (K6's
// cheb_first_kernel with x0 = +0: the next level's zero-guess first
// Chebyshev iterate), into p1.
template <typename T, int NDIM, int ND, bool CHEB>
__global__ void __launch_bounds__(ROW_THREADS)
restrict_grid_kernel(const T* __restrict__ x, const T* __restrict__ dinv,
                     T scale, T* __restrict__ out, T* __restrict__ p1,
                     Grid g) {
  constexpr int NZ = NDIM == 3 ? 3 : 1;
  const int ncy = g.nc[NDIM - 2];
  const int cy = blockIdx.x * blockDim.y + threadIdx.y;
  if (cy >= ncy) return;
  const int cz = NDIM == 3 ? (int)blockIdx.y : 0;
  const int nfy = g.nf[NDIM - 2];
  const int L = g.nc[NDIM - 1] * ND, fl = g.nf[NDIM - 1] * ND;
  const Terms ty = restrict_terms(cy, ncy);
  const Terms tz = restrict_terms(cz, g.nc[0]);   // unused in 2D
  int rows[NZ][3];
#pragma unroll
  for (int a = 0; a < NZ; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      rows[a][b] = ((NDIM == 3 ? tz.f[a] : 0) * nfy + ty.f[b]) * fl;
  const int o = (cz * ncy + cy) * L;
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    const int cx = j / ND, d = j - cx * ND;
    const Terms tx = restrict_terms(cx, g.nc[NDIM - 1]);
    T v[NZ][3][3];
#pragma unroll
    for (int a = 0; a < NZ; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          v[a][b][c] = x[rows[a][b] + tx.f[c] * ND + d];
    const T dv = CHEB ? dinv[o + j] : T(0);
    T vx[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      T vy[3];
#pragma unroll
      for (int b = 0; b < 3; ++b)
        vy[b] = NDIM == 3 ? restrict_axis(v[0][b][c], v[1 % NZ][b][c],
                                          v[2 % NZ][b][c], tz)
                          : v[0][b][c];
      vx[c] = restrict_axis(vy[0], vy[1], vy[2], ty);
    }
    const T r = restrict_axis(vx[0], vx[1], vx[2], tx);
    out[o + j] = r;
    if (CHEB) p1[o + j] = add(mul(scale, mul(dv, r)), T(0));
  }
}

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

// The grid pair's node counts; returns the fine grid's value count, or -1.
long long grid_layout(const int* nc, int ndim, int nd, Grid* g) {
  long long fine = nd;
  for (int dim = 0; dim < ndim; ++dim) {
    if (nc[dim] < 1) return -1;
    g->nc[dim] = nc[dim];
    g->nf[dim] = 2 * nc[dim] - 1;
    fine *= g->nf[dim];
  }
  return fine < MAX_VALUES ? fine : -1;
}

// The row launch of a K5 kernel: rows of len values (the longest row), ny
// rows per plane, nz planes, nclass classes. Threads along a row up to
// ROW_THREADS (a longer row loops), then as many rows per block as fit.
struct RowLaunch {
  dim3 grid, block;
  bool ok;
};

RowLaunch row_launch(int len, int ny, int nz, int nclass) {
  const int tx = len < ROW_THREADS ? len : ROW_THREADS;
  int rows = ROW_THREADS / tx;
  if (rows > ny) rows = ny;
  return {dim3((ny + rows - 1) / rows, nz, nclass), dim3(tx, rows),
          nz <= 65535};
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

// The current device's SM count, or 0 where it cannot be read (the
// prolongation then takes its unstaged form).
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

template <typename T>
struct ProlongParity {
  const T* xc;
  const T* xadd;
  T* out;
  Parity P;
  cudaStream_t s;

  template <bool ADD, int NDIM, int ND>
  int staged(const RowLaunch& l, int cl) const {
    const int smem = (int)sizeof(T) * (NDIM == 3 ? 2 : 1) *
                     ((int)l.block.y + 1) * cl;
    auto kernel = prolong_parity_staged_kernel<T, NDIM, ND, ADD>;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    kernel<<<l.grid, l.block, smem, s>>>(xc, xadd, out, P);
    return (int)cudaGetLastError();
  }

  // The staged form where its blocks (one per plane and group of rows, all
  // classes) are at least two per SM; else one block per class as well,
  // for more blocks in flight (a cart shard's box).
  template <int NDIM, int ND>
  int run() const {
    int len = 0, ny = 0, nz = 1;
    for (int p = 0; p < (1 << NDIM); ++p) {
      if (P.shp[p][NDIM - 1] * ND > len) len = P.shp[p][NDIM - 1] * ND;
      if (P.shp[p][NDIM - 2] > ny) ny = P.shp[p][NDIM - 2];
      if (NDIM == 3 && P.shp[p][0] > nz) nz = P.shp[p][0];
    }
    const int cl = P.cshape[NDIM - 1] * ND;
    const RowLaunch st = row_launch(cl, ny, nz, 1);
    const int sms = sm_count();
    if (st.ok && sms > 0 && (long long)st.grid.x * st.grid.y >= 2LL * sms &&
        (long long)sizeof(T) * 2 * (st.block.y + 1) * cl <= 200 * 1024)
      return xadd != nullptr ? staged<true, NDIM, ND>(st, cl)
                             : staged<false, NDIM, ND>(st, cl);
    const RowLaunch l = row_launch(len, ny, nz, 1 << NDIM);
    if (!l.ok) return (int)cudaErrorInvalidValue;
    if (xadd != nullptr)
      prolong_parity_kernel<T, NDIM, ND, true>
          <<<l.grid, l.block, 0, s>>>(xc, xadd, out, P);
    else
      prolong_parity_kernel<T, NDIM, ND, false>
          <<<l.grid, l.block, 0, s>>>(xc, xadd, out, P);
    return (int)cudaGetLastError();
  }
};

// p1 non-null: the residual form with the Chebyshev store (y and dinv
// non-null, w null).
template <typename T>
struct RestrictParity {
  const T* b;
  const T* y;
  const T* w;
  const T* dinv;
  T scale;
  T* out;
  T* p1;
  Parity P;
  cudaStream_t s;
  template <int NDIM, int ND>
  int run() const {
    const RowLaunch l = row_launch(P.cshape[NDIM - 1] * ND,
                                   P.cshape[NDIM - 2],
                                   NDIM == 3 ? P.cshape[0] : 1, 1);
    if (!l.ok) return (int)cudaErrorInvalidValue;
    if (p1 != nullptr)
      restrict_parity_kernel<T, NDIM, ND, RESIDUAL, true>
          <<<l.grid, l.block, 0, s>>>(b, y, w, dinv, scale, out, p1, P);
    else if (w != nullptr)
      restrict_parity_kernel<T, NDIM, ND, WEIGHTED, false>
          <<<l.grid, l.block, 0, s>>>(b, y, w, dinv, scale, out, p1, P);
    else if (y != nullptr)
      restrict_parity_kernel<T, NDIM, ND, RESIDUAL, false>
          <<<l.grid, l.block, 0, s>>>(b, y, w, dinv, scale, out, p1, P);
    else
      restrict_parity_kernel<T, NDIM, ND, PLAIN, false>
          <<<l.grid, l.block, 0, s>>>(b, y, w, dinv, scale, out, p1, P);
    return (int)cudaGetLastError();
  }
};

template <typename T>
struct ProlongGrid {
  const T* xc;
  const T* xadd;
  T* out;
  Grid g;
  cudaStream_t s;
  template <int NDIM, int ND>
  int run() const {
    const RowLaunch l = row_launch(g.nf[NDIM - 1] * ND, g.nf[NDIM - 2],
                                   NDIM == 3 ? g.nf[0] : 1, 1);
    if (!l.ok) return (int)cudaErrorInvalidValue;
    if (xadd != nullptr)
      prolong_grid_kernel<T, NDIM, ND, true>
          <<<l.grid, l.block, 0, s>>>(xc, xadd, out, g);
    else
      prolong_grid_kernel<T, NDIM, ND, false>
          <<<l.grid, l.block, 0, s>>>(xc, xadd, out, g);
    return (int)cudaGetLastError();
  }
};

template <typename T>
struct RestrictGrid {
  const T* x;
  const T* dinv;
  T scale;
  T* out;
  T* p1;
  Grid g;
  cudaStream_t s;
  template <int NDIM, int ND>
  int run() const {
    const RowLaunch l = row_launch(g.nc[NDIM - 1] * ND, g.nc[NDIM - 2],
                                   NDIM == 3 ? g.nc[0] : 1, 1);
    if (!l.ok) return (int)cudaErrorInvalidValue;
    if (p1 != nullptr)
      restrict_grid_kernel<T, NDIM, ND, true>
          <<<l.grid, l.block, 0, s>>>(x, dinv, scale, out, p1, g);
    else
      restrict_grid_kernel<T, NDIM, ND, false>
          <<<l.grid, l.block, 0, s>>>(x, dinv, scale, out, p1, g);
    return (int)cudaGetLastError();
  }
};

template <typename T>
int prolong_parity(const void* xc, const void* xadd, void* out,
                   const int* shapes, int ndim, int nd, void* stream) {
  if (!supported(ndim, nd)) return (int)cudaErrorInvalidValue;
  Parity P = {};
  if (parity_layout(shapes, ndim, nd, &P) <= 0)
    return (int)cudaErrorInvalidValue;
  return dispatch(ndim, nd, ProlongParity<T>{
      static_cast<const T*>(xc), static_cast<const T*>(xadd),
      static_cast<T*>(out), P, static_cast<cudaStream_t>(stream)});
}

template <typename T>
int restrict_parity(const void* b, const void* y, const void* w,
                    const void* dinv, double scale, void* out, void* p1,
                    const int* shapes, int ndim, int nd, void* stream) {
  if (!supported(ndim, nd)) return (int)cudaErrorInvalidValue;
  Parity P = {};
  if (parity_layout(shapes, ndim, nd, &P) <= 0)
    return (int)cudaErrorInvalidValue;
  return dispatch(ndim, nd, RestrictParity<T>{
      static_cast<const T*>(b), static_cast<const T*>(y),
      static_cast<const T*>(w), static_cast<const T*>(dinv),
      static_cast<T>(scale), static_cast<T*>(out), static_cast<T*>(p1), P,
      static_cast<cudaStream_t>(stream)});
}

template <typename T>
int prolong_grid(const void* xc, const void* xadd, void* out, const int* nc,
                 int ndim, int nd, void* stream) {
  if (!supported(ndim, nd)) return (int)cudaErrorInvalidValue;
  Grid g = {};
  if (grid_layout(nc, ndim, nd, &g) <= 0) return (int)cudaErrorInvalidValue;
  return dispatch(ndim, nd, ProlongGrid<T>{
      static_cast<const T*>(xc), static_cast<const T*>(xadd),
      static_cast<T*>(out), g, static_cast<cudaStream_t>(stream)});
}

// p1 null: the plain restriction (dinv and scale unread).
template <typename T>
int restrict_grid(const void* x, const void* dinv, double scale, void* out,
                  void* p1, const int* nc, int ndim, int nd, void* stream) {
  if (!supported(ndim, nd)) return (int)cudaErrorInvalidValue;
  Grid g = {};
  if (grid_layout(nc, ndim, nd, &g) <= 0) return (int)cudaErrorInvalidValue;
  return dispatch(ndim, nd, RestrictGrid<T>{
      static_cast<const T*>(x), static_cast<const T*>(dinv),
      static_cast<T>(scale), static_cast<T*>(out), static_cast<T*>(p1), g,
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
  return restrict_parity<float>(b, y, nullptr, nullptr, 0.0, out, nullptr,
                                shapes, ndim, nd, stream);
}

extern "C" int k5_restrict_parity_f64(const void* b, const void* y,
                                      void* out, const int* shapes, int ndim,
                                      int nd, void* stream) {
  return restrict_parity<double>(b, y, nullptr, nullptr, 0.0, out, nullptr,
                                 shapes, ndim, nd, stream);
}

// restrict_parity of w * (b - y); no pointer may be null.
extern "C" int k5_restrict_parity_weighted_residual_f32(
    const void* b, const void* y, const void* w, void* out,
    const int* shapes, int ndim, int nd, void* stream) {
  if (b == nullptr || y == nullptr || w == nullptr)
    return (int)cudaErrorInvalidValue;
  return restrict_parity<float>(b, y, w, nullptr, 0.0, out, nullptr, shapes,
                                ndim, nd, stream);
}

extern "C" int k5_restrict_parity_weighted_residual_f64(
    const void* b, const void* y, const void* w, void* out,
    const int* shapes, int ndim, int nd, void* stream) {
  if (b == nullptr || y == nullptr || w == nullptr)
    return (int)cudaErrorInvalidValue;
  return restrict_parity<double>(b, y, w, nullptr, 0.0, out, nullptr, shapes,
                                 ndim, nd, stream);
}

// restrict_parity of b - y into out, and into p1 L-2's zero-guess first
// Chebyshev iterate scale (d out) + 0 (d: L-2's Jacobi inverse diagonal, of
// out's shape; scale rounded to the dtype here, as K6 rounds it); no
// pointer may be null.
extern "C" int k5_restrict_parity_residual_cheb_first_f32(
    const void* b, const void* y, const void* d, double scale, void* out,
    void* p1, const int* shapes, int ndim, int nd, void* stream) {
  if (b == nullptr || y == nullptr || d == nullptr || p1 == nullptr)
    return (int)cudaErrorInvalidValue;
  return restrict_parity<float>(b, y, nullptr, d, scale, out, p1, shapes,
                                ndim, nd, stream);
}

extern "C" int k5_restrict_parity_residual_cheb_first_f64(
    const void* b, const void* y, const void* d, double scale, void* out,
    void* p1, const int* shapes, int ndim, int nd, void* stream) {
  if (b == nullptr || y == nullptr || d == nullptr || p1 == nullptr)
    return (int)cudaErrorInvalidValue;
  return restrict_parity<double>(b, y, nullptr, d, scale, out, p1, shapes,
                                 ndim, nd, stream);
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
  return restrict_grid<float>(x, nullptr, 0.0, out, nullptr, nc, ndim, nd,
                              stream);
}

extern "C" int k5_restrict_grid_f64(const void* x, void* out, const int* nc,
                                    int ndim, int nd, void* stream) {
  return restrict_grid<double>(x, nullptr, 0.0, out, nullptr, nc, ndim, nd,
                               stream);
}

// restrict_grid into out, and into p1 the next level's zero-guess first
// Chebyshev iterate scale (d out) + 0 (d: that level's Jacobi inverse
// diagonal, of out's shape; scale rounded to the dtype here, as K6 rounds
// it); no pointer may be null.
extern "C" int k5_restrict_grid_cheb_first_f32(const void* x, const void* d,
                                               double scale, void* out,
                                               void* p1, const int* nc,
                                               int ndim, int nd,
                                               void* stream) {
  if (x == nullptr || d == nullptr || p1 == nullptr)
    return (int)cudaErrorInvalidValue;
  return restrict_grid<float>(x, d, scale, out, p1, nc, ndim, nd, stream);
}

extern "C" int k5_restrict_grid_cheb_first_f64(const void* x, const void* d,
                                               double scale, void* out,
                                               void* p1, const int* nc,
                                               int ndim, int nd,
                                               void* stream) {
  if (x == nullptr || d == nullptr || p1 == nullptr)
    return (int)cudaErrorInvalidValue;
  return restrict_grid<double>(x, d, scale, out, p1, nc, ndim, nd, stream);
}
