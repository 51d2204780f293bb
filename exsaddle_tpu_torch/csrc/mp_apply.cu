// K3: the p-block's Mpscaled apply (the viscosity-scaled pressure mass
// matrix in factored form), one launch per apply, with the p-block's
// Chebyshev update in its store.
//
//     y_p = sum_e G_e^T Np^T diag(pscale_e) Np G_e x_p
//
// G_e gathers element e's 2^ndim Q1 corners from the pressure node grid,
// Np (3^ndim quadrature points x 2^ndim corners) is shared by every element
// and pscale (nel x 3^ndim) holds each element's quadrature weights.
// Replaces exsaddle_tpu/abf.py:92 mp_apply with exsaddle_tpu/grid_ops.py:86
// _gather_q1 and :104 _scatter_q1 (an XLA fusion on the TPU); its plain
// version, kernels/mp.py:mp_apply_plain, is the port's earlier torch body:
// a stack of 2^ndim strided slices, two GEMMs and a multiply, then a zero
// fill and 2^ndim strided slice adds, ~13 launches. The step form also
// replaces the loop body of exsaddle_tpu/treeops.py:167 cheb_smooth on the
// single-device p-block (K6's update after each apply):
//
//     plain:      y = Mp x
//     cheb_step:  omega ((scale (d (b - Mp p_k)) + p_k) - p_{k-1}) + p_{k-1}
//
// The update is cheb_math.cuh's arithmetic, shared with K6
// (cheb_update.cu), applied to the node sum in the store.
//
// Bound on an H100 SXM (data-sheet peaks). At mx=32 (33^3 = 35,937 nodes,
// 32,768 elements) one apply reads pscale once, 3.54 MB in float32, and
// the node vectors (x and y, and b, d, p_{k-1} in the step form: 0.72 MB):
// ~4.3 MB, 1.3 us at 3.35 TB/s; its operations, 891 per element (two
// 27 x 8 products and the scaling) and the node sums, are 29.5 MFLOP,
// 0.44 us at 67 TFLOP/s. Bytes bound it, and at this size one launch's
// latency (~2 us inside a graph) more than either.
//
// Design: a block owns a tile of output nodes (up to 7 per axis, the
// tiles of an axis balanced: 33 nodes are 5 tiles of 7 or fewer, 125
// blocks at mx=32, about one per SM) and computes every element that
// touches the tile (at most (t + 1)^3, clipped to the grid: at mx=32 each
// axis's 32 elements are computed 36 times, 1.42x the element work of one
// pass), so no element contribution leaves
// the block and one launch does the apply and the update without atomics.
//   1. Staging: Np, the tile's pressure values and its elements' pscale
//      rows (each x run of elements is one contiguous stretch of pscale)
//      go to shared memory with cp.async, every copy in flight before the
//      first wait; the update's b, d and p_{k-1} are loaded into registers
//      meanwhile (each thread owns at most one node).
//   2. Elements, one thread each: per quadrature point q (Np's row read
//      from shared memory 16 bytes at a time) u_q = sum_c Np[q][c] x_c,
//      t_q = u_q pscale_q, y_c += Np[q][c] t_q (2^nd chains over q),
//      every step an explicitly rounded fma / multiply, so
//      nvcc cannot contract them differently in two instantiations: the
//      plain and the fused forms compute the same element values.
//   3. Nodes, one thread each: the node sums its up-to-2^nd element
//      contributions in _scatter_q1's order (local corner li = la + 2 lb
//      + 4 lc ascending, from +0), so the node sum equals the plain
//      version's scatter for the same element values, then stores y or
//      the update (cheb_math.cuh, in the twin's order).
// The element products are GEMMs in the plain version, so the kernel's
// sums differ from cuBLAS's or MKL's in the last bits: the plain form is
// held against kernels/mp.py:mp_apply_plain by a stated tolerance, and the
// step form bitwise against its twin (the plain kernel, then K6).

#include <cuda_runtime.h>

#include "cheb_math.cuh"

namespace {

constexpr int imin(int a, int b) { return a < b ? a : b; }

// The most nodes a tile takes per axis in 3D (2D: three times as many).
// Any tile gives the same bits (each element's products and each node's
// sum are fixed); 7 was the fastest of 4-8 at the flagship's p size.
constexpr int kTile = 7;
constexpr int kMaxDevices = 64;
template <int NDIM>
__host__ __device__ constexpr int tile_nodes() {
  return NDIM == 3 ? kTile : 3 * kTile;
}

// A block's threads: one per element of a full tile ((t + 1)^ndim), in
// whole warps, so each thread computes at most one element and sums at
// most one node, with no loop (a loop over elements let nvcc hoist Np's
// 216 shared reads into registers and spill them)
template <int NDIM>
__host__ __device__ constexpr int threads() {
  const int e = tile_nodes<NDIM>() + 1;
  return ((NDIM == 3 ? e * e * e : e * e) + 31) / 32 * 32;
}

enum { EPI_NONE = 0, EPI_STEP = 1 };

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// a row of N values from 16-byte aligned shared memory, 16 bytes a load
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* p, T (&r)[N]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      r[i] = v.x, r[i + 1] = v.y, r[i + 2] = v.z, r[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const double2 v = *reinterpret_cast<const double2*>(p + i);
      r[i] = v.x, r[i + 1] = v.y;
    }
  }
}

template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(sizeof(T)));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// The grids: m elements and nn = m + 1 nodes per axis (x, y, z; z = 1 node
// and 1 element layer in 2D), t the tile's nodes per axis, e the most
// elements a tile touches per axis (its shared arrays' extents).
struct Box {
  int m[3], nn[3], t[3], e[3];
};

template <typename T>
struct Epi {
  const T *b, *d, *pkm1;
  T scale, omega;
};

template <typename T, int NDIM, int EPI>
__global__ void __launch_bounds__(threads<NDIM>())
mp_apply_kernel(const T* __restrict__ x, const T* __restrict__ pscale,
                const T* __restrict__ Np, T* __restrict__ out, Box g,
                Epi<T> f) {
  constexpr int NC = 1 << NDIM;             // corners per element
  constexpr int NQ = NDIM == 3 ? 27 : 9;    // quadrature points
  constexpr int Z1 = NDIM == 3 ? 1 : 0;     // node layers beyond elements
  constexpr int YS = NC + 1;                // ye_s row stride (odd: no bank
                                            // conflicts along a warp)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* np_s = reinterpret_cast<T*>(smem_raw);
  // the tile's nodes [n0, n0 + tn) and the elements touching them
  // [e0, e0 + en) per axis; their nodes are [e0, e0 + en + 1)
  int n0[3], tn[3], e0[3], en[3];
  const int bid[3] = {(int)blockIdx.x, (int)blockIdx.y, (int)blockIdx.z};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    n0[a] = bid[a] * g.t[a];
    tn[a] = min(g.t[a], g.nn[a] - n0[a]);
    e0[a] = max(n0[a] - 1, 0);
    en[a] = min(n0[a] + tn[a], g.m[a]) - e0[a];
  }
  const int px = en[0] + 1, py = en[1] + 1, pz = en[2] + Z1;
  const int nel = en[0] * en[1] * en[2];
  T* p_s = np_s + NQ * NC;
  T* ps_s = p_s + (g.e[0] + 1) * (g.e[1] + 1) * (g.e[2] + Z1);
  T* ye_s = ps_s + NQ * g.e[0] * g.e[1] * g.e[2];
  const int tid = threadIdx.x;
  constexpr int THREADS = threads<NDIM>();

  // 1. staging: every copy issued, then one wait
  for (int i = tid; i < NQ * NC; i += THREADS) cp_async(np_s + i, Np + i);
  for (int i = tid; i < px * py * pz; i += THREADS) {
    const int lx = i % px, r = i / px, ly = r % py, lz = r / py;
    cp_async(p_s + i,
             x + ((e0[2] + lz) * g.nn[1] + e0[1] + ly) * g.nn[0] + e0[0] + lx);
  }
  {
    const int warp = tid >> 5, lane = tid & 31, len = en[0] * NQ;
    for (int r = warp; r < en[1] * en[2]; r += THREADS / 32) {
      const int ly = r % en[1], lz = r / en[1];
      const T* src = pscale + (size_t)(((e0[2] + lz) * g.m[1] + e0[1] + ly) *
                                       g.m[0] + e0[0]) * NQ;
      for (int j = lane; j < len; j += 32)
        cp_async(ps_s + r * len + j, src + j);
    }
  }
  // this thread's node (at most one) and the update's operands
  const bool mine = tid < tn[0] * tn[1] * tn[2];
  int nx = 0, ny = 0, nz = 0, node = 0;
  T b = T(0), d = T(0), pm = T(0);
  if (mine) {
    nx = n0[0] + tid % tn[0];
    ny = n0[1] + (tid / tn[0]) % tn[1];
    nz = n0[2] + tid / (tn[0] * tn[1]);
    node = (nz * g.nn[1] + ny) * g.nn[0] + nx;
    if (EPI == EPI_STEP) {
      b = f.b[node];
      d = f.d[node];
      pm = f.pkm1[node];
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. the element products, one element per thread: per quadrature point
  // Np's row (16-byte shared loads, the same address across the warp),
  // u = sum_c Np[q][c] x_c, u pscale_q, then y_c += Np[q][c] (u pscale_q)
  if (tid < nel) {
    const int el = tid;
    const int lx = el % en[0], r = el / en[0], ly = r % en[1], lz = r / en[1];
    T pe[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c)
      pe[c] = p_s[((lz + (c >> 2)) * py + ly + ((c >> 1) & 1)) * px + lx +
                  (c & 1)];
    const T* ps = ps_s + el * NQ;
    T ye[NC];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      T nq[NC];
      load_row<T, NC>(np_s + q * NC, nq);
      T u = cheb_math::mul(nq[0], pe[0]);
#pragma unroll
      for (int c = 1; c < NC; ++c) u = fma_rn(nq[c], pe[c], u);
      u = cheb_math::mul(u, ps[q]);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        ye[c] = q == 0 ? cheb_math::mul(u, nq[c]) : fma_rn(u, nq[c], ye[c]);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) ye_s[el * YS + c] = ye[c];
  }
  __syncthreads();

  // 3. the node sums in _scatter_q1's order, then the store
  if (!mine) return;
  T acc = T(0);
#pragma unroll
  for (int li = 0; li < NC; ++li) {
    const int ex = nx - (li & 1), ey = ny - ((li >> 1) & 1), ez = nz - (li >> 2);
    if (ex >= 0 && ex < g.m[0] && ey >= 0 && ey < g.m[1] && ez >= 0 &&
        ez < g.m[2])
      acc = cheb_math::add(
          acc, ye_s[(((ez - e0[2]) * en[1] + ey - e0[1]) * en[0] + ex - e0[0]) *
                        YS + li]);
  }
  if (EPI == EPI_NONE) {
    out[node] = acc;
    return;
  }
  const T pk = p_s[((nz - e0[2]) * py + ny - e0[1]) * px + nx - e0[0]];
  out[node] = cheb_math::step(b, acc, d, pk, pm, f.scale, f.omega);
}

// The tiles of an axis of n nodes: as few as hold at most tgt nodes each,
// balanced; returns their count and sets t to their (largest) size.
int tiles(int n, int tgt, int* t) {
  const int nt = (n + tgt - 1) / tgt;
  *t = (n + nt - 1) / nt;
  return (n + *t - 1) / *t;
}

// The shared memory of a block whose tile touches e[a] elements per axis:
// Np, the tile's pressure values, its elements' pscale rows and their
// corner values (ye_s, rows of 2^ndim + 1)
template <typename T, int NDIM>
constexpr size_t smem_bytes(int ex, int ey, int ez) {
  constexpr int NC = 1 << NDIM, NQ = NDIM == 3 ? 27 : 9;
  return sizeof(T) * ((size_t)NQ * NC +
                      (size_t)(ex + 1) * (ey + 1) * (ez + (NDIM == 3)) +
                      (size_t)(NQ + NC + 1) * ex * ey * ez);
}

template <typename T, int NDIM, int EPI>
int launch(const T* x, const T* pscale, const T* Np, T* out, const Box& g,
           const dim3& grid, const Epi<T>& f, cudaStream_t s) {
  auto kernel = mp_apply_kernel<T, NDIM, EPI>;
  // the limit of a full tile's shared memory (a tile clipped by the grid
  // needs less), set once per instantiation and device
  static bool opted[kMaxDevices] = {false};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted[dev]) {
    constexpr int n = tile_nodes<NDIM>() + 1;
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<T, NDIM>(n, n, NDIM == 3 ? n : 1));
    if (e != cudaSuccess) return (int)e;
    opted[dev] = true;
  }
  kernel<<<grid, threads<NDIM>(), smem_bytes<T, NDIM>(g.e[0], g.e[1], g.e[2]),
           s>>>(x, pscale, Np, out, g, f);
  return (int)cudaGetLastError();
}

template <typename T, int NDIM>
int launch_epi(int epi, const T* x, const T* pscale, const T* Np, T* out,
               const Box& g, const dim3& grid, const Epi<T>& f,
               cudaStream_t s) {
  switch (epi) {
    case EPI_NONE:
      return launch<T, NDIM, EPI_NONE>(x, pscale, Np, out, g, grid, f, s);
    case EPI_STEP:
      return launch<T, NDIM, EPI_STEP>(x, pscale, Np, out, g, grid, f, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int mp_apply(const void* x, const void* pscale, const void* Np,
             const void* b, const void* d, const void* pkm1, double scale,
             double omega, void* out, int epi, int ndim, int mx, int my,
             int mz, void* stream) {
  if ((ndim != 2 && ndim != 3) || mx < 1 || my < 1 || (ndim == 3 && mz < 1))
    return (int)cudaErrorInvalidValue;
  if (epi == EPI_STEP && (b == nullptr || d == nullptr || pkm1 == nullptr))
    return (int)cudaErrorInvalidValue;
  Box g{};
  const int m[3] = {mx, my, ndim == 3 ? mz : 1};
  dim3 grid;
  unsigned* gd[3] = {&grid.x, &grid.y, &grid.z};
  long long nodes = 1;
  for (int a = 0; a < 3; ++a) {
    g.m[a] = m[a];
    g.nn[a] = a < ndim ? m[a] + 1 : 1;
    nodes *= g.nn[a];
    *gd[a] = (unsigned)tiles(
        g.nn[a], ndim == 3 ? tile_nodes<3>() : tile_nodes<2>(), &g.t[a]);
    g.e[a] = a < ndim ? imin(g.t[a] + 1, g.m[a]) : 1;
  }
  if (g.e[0] * g.e[1] * g.e[2] > (ndim == 3 ? threads<3>() : threads<2>()))
    return (int)cudaErrorInvalidValue;
  if (nodes >= (1LL << 31) || (long long)mx * my * m[2] * 27 >= (1LL << 31) ||
      grid.y > 65535 || grid.z > 65535)
    return (int)cudaErrorInvalidValue;
  const Epi<T> f{static_cast<const T*>(b), static_cast<const T*>(d),
                 static_cast<const T*>(pkm1), static_cast<T>(scale),
                 static_cast<T>(omega)};
  const T* xt = static_cast<const T*>(x);
  const T* st = static_cast<const T*>(pscale);
  const T* nt = static_cast<const T*>(Np);
  T* ot = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ndim == 3) return launch_epi<T, 3>(epi, xt, st, nt, ot, g, grid, f, s);
  return launch_epi<T, 2>(epi, xt, st, nt, ot, g, grid, f, s);
}

}  // namespace

// x and out: the pressure node grid, (mz + 1) x (my + 1) x (mx + 1) values
// (2D: (my + 1) x (mx + 1)), x fastest; pscale: nel x 3^ndim, the elements
// x fastest; Np: 3^ndim x 2^ndim; b, d, pkm1: node grids as x (null where
// the form does not read them). Every array is a contiguous device array
// of one dtype on the stream's device; out is fully written and aliases no
// input. epi: 0 the plain apply, 1 a Chebyshev step from x = p_k; scale and
// omega are rounded to the dtype
// here (round to nearest, as torch converts a Python scalar). Returns 0 or
// the cudaError_t of the failed launch (cudaErrorInvalidValue for a shape,
// form or pointer the kernel does not take).
extern "C" int k3_mp_apply_f32(const void* x, const void* pscale,
                               const void* Np, const void* b, const void* d,
                               const void* pkm1, double scale, double omega,
                               void* out, int epi, int ndim, int mx, int my,
                               int mz, void* stream) {
  return mp_apply<float>(x, pscale, Np, b, d, pkm1, scale, omega, out, epi,
                         ndim, mx, my, mz, stream);
}

extern "C" int k3_mp_apply_f64(const void* x, const void* pscale,
                               const void* Np, const void* b, const void* d,
                               const void* pkm1, double scale, double omega,
                               void* out, int epi, int ndim, int mx, int my,
                               int mz, void* stream) {
  return mp_apply<double>(x, pscale, Np, b, d, pkm1, scale, omega, out, epi,
                          ndim, mx, my, mz, stream);
}
