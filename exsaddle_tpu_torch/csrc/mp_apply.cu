// K3: the p-block's Mpscaled apply (the viscosity-scaled pressure mass
// matrix) as its 3^ndim-point node stencil, one launch per apply, with the
// p-block's Chebyshev update in its store.
//
//     y[n] = sum_s W[s, n] x[n + off(s)]
//
//     plain:      y = Mp x
//     cheb_step:  omega ((scale (d (b - Mp p_k)) + p_k) - p_{k-1}) + p_{k-1}
//
// Replaces exsaddle_tpu/abf.py:92 mp_apply with exsaddle_tpu/grid_ops.py:86
// _gather_q1 and :104 _scatter_q1 (an XLA fusion on the TPU), which apply
// Mpscaled in factored form, sum_e G_e^T Np^T diag(pscale_e) Np G_e x, at
// every call; the step form also replaces the loop body of
// exsaddle_tpu/treeops.py:167 cheb_smooth on the single-device p-block
// (K6's update after each apply). Mpscaled is fixed for a setup, so the
// setup assembles it once and extracts its stencil (abf.mp_stencil): W
// is (3^ndim, nodes), slot-major, W[s] the coupling of every node to its
// neighbour at offset s (slots x-fastest over the offsets -1..1, as
// kernels/stencil.py stencil_offsets), zero where the neighbour is off the
// grid; summed in float64 and rounded once to the working dtype. Its
// plain version, kernels/mp.py:mp_apply_plain, is the factored torch
// body, so the kernel is held against it by a stated tolerance; the step
// form is bitwise its twin (this kernel's plain form, then K6).
//
// Bound on an H100 SXM (data-sheet peaks). The same work in its least
// bytes is the factored form's: at mx=32 (33^3 = 35,937 nodes, 32,768
// elements) pscale 3.54 MB in float32 and the node vectors (x and y, and
// b, d, p_{k-1} in the step form: 0.72 MB), 1.3 us at 3.35 TB/s. The
// stencil reads 3.88 MB of W instead of pscale (1.1x), and 27 fmas a node
// (1.9 MFLOP) instead of the factored form's ~890 operations an element;
// over one p-block solve's steps W stays in the 50 MB L2.
//
// Design: one thread per node, 128 a block, the nodes in the grid's order
// (x fastest). A thread issues all of its loads before it sums: its
// 3^ndim W values (slot-major, so each slot's load is one coalesced run
// across the warp), its neighbours' x values (off-grid neighbours read as
// 0 by predicate) and the update's b, d and p_{k-1}. The sum runs slot by
// slot in stencil_offsets order in double, sum = fma(W[s], x_s, sum) from
// 0, explicitly rounded, and is rounded once to the working dtype. In
// float32 every product W[s] x_s is exact in double (24 + 24 bits) and the
// double sum's own error (~2^-48 of the terms) sits far below float32's
// rounding, so the result is W x rounded once, all but independent of the
// summation order. A float32 fma chain took ~0.8 us less at the flagship
// (likely the 54 float-to-double conversions a node, which issue at a
// quarter of the fma rate; not profiled), but its order moved the
// flagship's chaotic float32 solve counts (PERF.md section 6).
// The store applies cheb_math.cuh's update in the twin's order. No shared memory, no atomics: deterministic. The first
// version computed the factored form per call (a block per tile of 7^3
// nodes, every touching element's two 27 x 8 products recomputed, the
// node sums through shared memory) and ran at ~20% of the bound at the
// flagship.

#include <cuda_runtime.h>

#include "cheb_math.cuh"

namespace {

constexpr int kThreads = 128;

enum { EPI_NONE = 0, EPI_STEP = 1 };

template <typename T>
struct Epi {
  const T *b, *d, *pkm1;
  T scale, omega;
};

template <typename T, int NDIM, int EPI>
__global__ void __launch_bounds__(kThreads)
    mp_stencil_kernel(const T* __restrict__ W, const T* __restrict__ x,
                      T* __restrict__ out, Epi<T> f, int nx, int ny,
                      int nz) {
  constexpr int S = NDIM == 3 ? 27 : 9;
  const int nodes = nx * ny * nz;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= nodes) return;
  const int ix = n % nx, r = n / nx, iy = r % ny, iz = r / ny;
  // which of the offsets -1, 0, 1 stay inside the grid, per axis
  const bool okx[3] = {ix > 0, true, ix < nx - 1};
  const bool oky[3] = {iy > 0, true, iy < ny - 1};
  const bool okz[3] = {iz > 0, true, iz < nz - 1};
  T w[S], v[S];
#pragma unroll
  for (int s = 0; s < S; ++s) w[s] = __ldg(W + (size_t)s * nodes + n);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int dx = s % 3 - 1, dy = (s / 3) % 3 - 1;
    const int dz = NDIM == 3 ? s / 9 - 1 : 0;
    const bool ok = okx[dx + 1] && oky[dy + 1] && (NDIM == 2 || okz[dz + 1]);
    v[s] = ok ? __ldg(x + n + (dz * ny + dy) * nx + dx) : T(0);
  }
  T b = T(0), d = T(0), pm = T(0);
  if (EPI == EPI_STEP) {
    b = __ldg(f.b + n);
    d = __ldg(f.d + n);
    pm = __ldg(f.pkm1 + n);
  }
  // in double (see the header), rounded once to T
  double sum = 0.0;
#pragma unroll
  for (int s = 0; s < S; ++s)
    sum = __fma_rn((double)w[s], (double)v[s], sum);
  const T acc = (T)sum;
  // p_k is the centre slot's value
  out[n] = EPI == EPI_NONE
               ? acc
               : cheb_math::step(b, acc, d, v[S / 2], pm, f.scale, f.omega);
}

template <typename T, int NDIM>
int launch(int epi, const T* W, const T* x, T* out, const Epi<T>& f, int nx,
           int ny, int nz, cudaStream_t s) {
  const int blocks = (nx * ny * nz + kThreads - 1) / kThreads;
  if (epi == EPI_NONE)
    mp_stencil_kernel<T, NDIM, EPI_NONE>
        <<<blocks, kThreads, 0, s>>>(W, x, out, f, nx, ny, nz);
  else
    mp_stencil_kernel<T, NDIM, EPI_STEP>
        <<<blocks, kThreads, 0, s>>>(W, x, out, f, nx, ny, nz);
  return (int)cudaGetLastError();
}

template <typename T>
int mp_apply(const void* W, const void* x, const void* b, const void* d,
             const void* pkm1, double scale, double omega, void* out,
             int epi, int ndim, int nx, int ny, int nz, void* stream) {
  if ((ndim != 2 && ndim != 3) || nx < 1 || ny < 1 ||
      (ndim == 3 && nz < 1) || (epi != EPI_NONE && epi != EPI_STEP))
    return (int)cudaErrorInvalidValue;
  if (epi == EPI_STEP && (b == nullptr || d == nullptr || pkm1 == nullptr))
    return (int)cudaErrorInvalidValue;
  if (ndim == 2) nz = 1;
  if ((long long)nx * ny * nz * (ndim == 3 ? 27 : 9) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const Epi<T> f{static_cast<const T*>(b), static_cast<const T*>(d),
                 static_cast<const T*>(pkm1), static_cast<T>(scale),
                 static_cast<T>(omega)};
  const T* wt = static_cast<const T*>(W);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ndim == 3) return launch<T, 3>(epi, wt, xt, ot, f, nx, ny, nz, s);
  return launch<T, 2>(epi, wt, xt, ot, f, nx, ny, nz, s);
}

}  // namespace

// W: 3^ndim x nodes, slot-major (slots x-fastest over the offsets -1..1);
// x and out: the pressure node grid, nz x ny x nx values (2D: ny x nx, nz
// ignored), x fastest; b, d, pkm1: node grids as x (null where the form
// does not read them). Every array is a contiguous device array of one
// dtype on the stream's device; out is fully written and aliases no input.
// epi: 0 the plain apply, 1 a Chebyshev step from x = p_k; scale and omega
// are rounded to the dtype here (round to nearest, as torch converts a
// Python scalar). Returns 0 or the cudaError_t of the failed launch
// (cudaErrorInvalidValue for a shape, form or pointer the kernel does not
// take).
extern "C" int k3_mp_apply_f32(const void* W, const void* x, const void* b,
                               const void* d, const void* pkm1, double scale,
                               double omega, void* out, int epi, int ndim,
                               int nx, int ny, int nz, void* stream) {
  return mp_apply<float>(W, x, b, d, pkm1, scale, omega, out, epi, ndim, nx,
                         ny, nz, stream);
}

extern "C" int k3_mp_apply_f64(const void* W, const void* x, const void* b,
                               const void* d, const void* pkm1, double scale,
                               double omega, void* out, int epi, int ndim,
                               int nx, int ny, int nz, void* stream) {
  return mp_apply<double>(W, x, b, d, pkm1, scale, omega, out, epi, ndim, nx,
                          ny, nz, stream);
}
