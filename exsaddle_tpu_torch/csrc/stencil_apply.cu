// K4: the 3^ndim-point block stencil apply of the deep multigrid levels,
// with the operations that follow it on those levels fused into its store.
//
//     y[n, i] = sum_s sum_j W[n, s, i, j] * x[n + off(s), j]
//
//     epilogue none        out = y
//              residual    out = b - y
//              cheb_first  out = scale (d (b - y)) + x0
//              cheb_step   out = omega ((scale (d (b - y)) + p_k) - p_km1)
//                                + p_km1
//
// Replaces exsaddle_tpu/abf.py:240 stencil_accum (its TPU production form
// stencil_apply_merged, :295), which XLA fused into one loop on the TPU,
// and on the stencil levels the loop body of exsaddle_tpu/treeops.py:167
// cheb_smooth (K6, csrc/cheb_update.cu, elsewhere) and the V-cycle's
// residual. W is (*grid, 3^ndim, nd, nd), contiguous, grid reversed
// (z, y, x); slots s run x-fastest over the offsets -1..1
// (kernels/stencil.py stencil_offsets). x is either the padded form xp
// (*grid + 2, nd), one ghost layer per side (the sharded path's ghost
// planes hold the neighbours' planes), or the zero-boundary form (*grid,
// nd), whose out-of-range neighbours read as 0 by predicate; the
// arithmetic is the same, so the two forms give the same bits when the
// ghosts are zero. x0 and p_k are x itself (the centre slot's gathered
// values); b, d, p_km1 and out are (*grid, nd).
//
// Bound on an H100 SXM (data-sheet peaks): each W entry is used once, so
// the apply streams W and does 2 FLOP per entry. At the mx=32 flagship's
// L-2 level (33^3 = 35,937 nodes, nd = 3) W is 34.9 MB in float32 (69.9 MB
// in float64) against 0.4-0.5 MB for each vector: ~10.7 us (21.4 us) at
// 3.35 TB/s, against 17.5 MFLOP (0.3 us at 67 TFLOP/s). Bytes bound it.
//
// Design, a streaming kernel with no tensor-core work (no matmul to give
// them):
// - Persistent CTAs of `warps` warps; every warp is its own pipeline over
//   the tiles g, g + G, g + 2G, ... (g its index among the G warps of the
//   grid). A tile is TN consecutive nodes, one per lane; its W run
//   (TN * 3^ndim * nd * nd values) is contiguous and lands in one of the
//   warp's `stages` shared-memory stages by ONE 1-D bulk TMA copy
//   (cp.async.bulk ... mbarrier::complete_tx::bytes), issued by the warp's
//   lane 0; no tensor map, no per-value index arithmetic: the shared
//   layout is the run itself. The lanes issue their gathers, wait on the
//   stage's mbarrier, read W from it, and once every lane has read it
//   (__syncwarp) lane 0 refills the stage with the warp's tile `stages`
//   ahead, so that copy overlaps the sums of this tile and the next.
//   1-D TMA needs a 16-byte multiple: a full tile is one (TN * K * 4 is a
//   multiple of 128), and the last tile of the grid copies its last <= 15
//   bytes with plain loads before lane 0 arrives on the barrier.
// - A lane gathers each neighbour's nd values once, all 3^ndim of them
//   before it waits for W (their latencies overlap each other and the
//   copy), and sums all nd rows from registers; the first version ran a
//   thread per (node, row), gathered every neighbour nd times and staged
//   W with an integer divide and modulo per value. Per-lane shared reads
//   stride K values: conflict-free for odd K (nd = 3) in either
//   precision; for nd = 2 (K = 36, 108) the float32 stride shares banks
//   4- and 8-way.
// - The sum of each (node, row) keeps the first version's order and
//   contraction bit for bit: slot by slot, t = fma(w0, x0, w1 * x1),
//   then (nd = 3) t = fma(w2, x2, t), then acc = acc + t from acc = 0,
//   which is what nvcc made of `t = w0 * x0; t += wj * xj; acc += t`.
//   Every operation is an explicitly rounded intrinsic, so no build can
//   contract it otherwise; the epilogues are cheb_update.cu's intrinsics
//   in its order (the residual b - y is one __fsub_rn / __dsub_rn), with
//   the scalars rounded to the working dtype as there. The epilogue is a
//   template parameter: each is its own kernel, loading only what it
//   reads. No atomics: the result is deterministic.
//
// The pipeline shape (kernels/stencil.py CONFIG) came from a sweep on an
// H100 80GB HBM3 at 700 W (k4_tune.py): float32 tiles of 32 nodes, one
// warp per CTA, 2 stages, 3 CTAs per SM (186 KB of shared memory); float64
// tiles of 16 nodes (half the lanes idle, so 3 warps of 2 stages fit), the
// same otherwise. Measured there (chip_smoke.py, phase mg_kernels; 50
// applies replayed as one graph; cold: inputs cycled out of the L2): mx=32
// L-2 float32 15.7-15.9 us cold, 9.8-10.1 us hot (the first version: 18.5
// / 12.8); float64 28.1-28.7 us either way, 75% of its bound (first
// version 48.2 us, cuSPARSE CSR SpMV 44-47 us); L-3 float32 4.7-4.9 /
// 3.5-3.8 us. Loading the next
// tile's operands during this tile's sums, or taking the dx = +-1
// neighbours by warp shuffle, measured no faster (or slower) and is not
// done.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

enum Epilogue { EPI_NONE = 0, EPI_RESIDUAL = 1, EPI_CHEB_FIRST = 2,
                EPI_CHEB_STEP = 3 };

constexpr int MAX_WARPS = 8;
constexpr int SMEM_MAX = 232448;   // the 227 KB a block may opt in to
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float fma_(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

template <typename T>
struct Params {
  const T* W;
  const T* x;      // xp (padded) or x (zero boundary)
  T* out;
  const T* b;      // residual, cheb_first, cheb_step
  const T* d;      // cheb_first, cheb_step
  const T* pkm1;   // cheb_step
  T scale, omega;
  int padded;
  int nx, ny, nz, nnodes, ntiles, stages;
};

// Lane 0 of a warp: copy tile `tile`'s W run into `dst` and arm `bar`
// for its bytes (the <= 15 bytes past the last 16-byte multiple of the
// grid's last tile by plain loads, visible to the lanes through the
// barrier's release / acquire).
template <typename T, int TN, int K>
__device__ __forceinline__ void issue(const Params<T>& p, int tile, T* dst,
                                      uint64_t* bar) {
  const int n0 = tile * TN;
  const int nt = min(TN, p.nnodes - n0);
  const T* src = p.W + (size_t)n0 * K;
  const uint32_t count = (uint32_t)nt * K;
  const uint32_t bulk = (count * (uint32_t)sizeof(T)) & ~15u;
  for (uint32_t e = bulk / sizeof(T); e < count; ++e) dst[e] = src[e];
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bulk)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bulk), "r"(smem_addr(bar))
      : "memory");
}

// What a lane reads besides W for its node: the neighbours' values slot
// by slot, and the epilogue's operands.
template <typename T, int NDIM, int ND>
struct Operands {
  static constexpr int S = NDIM == 3 ? 27 : 9;
  T x[S][ND], b[ND], d[ND], q[ND];
};

// Issue every load of node n's operands; none waits for W, so their
// latencies overlap one another and the stage's copy.
template <typename T, int NDIM, int ND, int EPI>
__device__ __forceinline__ void load_operands(const Params<T>& p, int n,
                                              int px, int py,
                                              Operands<T, NDIM, ND>& o) {
  constexpr int S = Operands<T, NDIM, ND>::S;
  const int ix = n % p.nx;
  const int iy = NDIM == 3 ? (n / p.nx) % p.ny : n / p.nx;
  const int iz = NDIM == 3 ? n / (p.nx * p.ny) : 0;
  // which of the offsets -1, 0, 1 stay inside the grid, per axis
  const bool pad = p.padded;
  const bool okx[3] = {pad || ix > 0, true, pad || ix < p.nx - 1};
  const bool oky[3] = {pad || iy > 0, true, pad || iy < p.ny - 1};
  const bool okz[3] = {pad || iz > 0, true, pad || iz < p.nz - 1};
  const int c = pad ? (NDIM == 3 ? ((iz + 1) * py + iy + 1) * px
                                 : (iy + 1) * px) + ix + 1
                    : n;
#pragma unroll
  for (int sl = 0; sl < S; ++sl) {
    const int dx = sl % 3 - 1, dy = (sl / 3) % 3 - 1, dz = sl / 9 - 1;
    const bool ok = okx[dx + 1] && oky[dy + 1] && (NDIM == 2 || okz[dz + 1]);
    const int nb = c + (NDIM == 3 ? dz * py * px : 0) + dy * px + dx;
#pragma unroll
    for (int jj = 0; jj < ND; ++jj)
      o.x[sl][jj] = ok ? __ldg(p.x + (size_t)nb * ND + jj) : T(0);
  }
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    const size_t e = (size_t)n * ND + i;
    if (EPI != EPI_NONE) o.b[i] = __ldg(p.b + e);
    if (EPI >= EPI_CHEB_FIRST) o.d[i] = __ldg(p.d + e);
    if (EPI == EPI_CHEB_STEP) o.q[i] = __ldg(p.pkm1 + e);
  }
}

template <typename T, int NDIM, int ND, int TN, int EPI>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    stencil_k4_kernel(const Params<T> p) {
  constexpr int S = NDIM == 3 ? 27 : 9;
  constexpr int K = S * ND * ND;           // W values per node
  constexpr int TILE = TN * K;             // W values per tile
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int P = p.stages;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem) + warp * P;
  T* stage0 = reinterpret_cast<T*>(
                  smem + ((warps * P * 8 + 127) & ~127)) +
              (size_t)warp * P * TILE;
  const int G = gridDim.x * warps;
  const int g = blockIdx.x * warps + warp;

  if (lane == 0) {
    for (int s = 0; s < P; ++s) mbar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int j = 0; j < P && g + j * G < p.ntiles; ++j)
      issue<T, TN, K>(p, g + j * G, stage0 + (size_t)j * TILE, bars + j);
  }
  __syncwarp();

  const int px = p.padded ? p.nx + 2 : p.nx;
  const int py = p.padded ? p.ny + 2 : p.ny;
  for (int j = 0;; ++j) {
    const int tile = g + j * G;
    if (tile >= p.ntiles) break;
    const int s = j % P;
    const int n = tile * TN + lane;
    const bool active = lane < TN && n < p.nnodes;
    Operands<T, NDIM, ND> o;
    if (active) load_operands<T, NDIM, ND, EPI>(p, n, px, py, o);
    mbar_wait(bars + s, (uint32_t)((j / P) & 1));
    T acc[ND];
    if (active) {
      const T* w = stage0 + (size_t)s * TILE + lane * K;
#pragma unroll
      for (int i = 0; i < ND; ++i) acc[i] = T(0);
#pragma unroll
      for (int sl = 0; sl < S; ++sl) {
#pragma unroll
        for (int i = 0; i < ND; ++i) {
          const T* ws = w + sl * ND * ND + i * ND;
          T t = fma_(ws[0], o.x[sl][0], mul(ws[1], o.x[sl][1]));
          if (ND == 3) t = fma_(ws[2], o.x[sl][2], t);
          acc[i] = add(acc[i], t);
        }
      }
    }
    __syncwarp();
    const int jn = j + P;
    if (lane == 0 && g + jn * G < p.ntiles) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue<T, TN, K>(p, g + jn * G, stage0 + (size_t)s * TILE, bars + s);
    }
    if (active) {
      // x0 and p_k are the centre slot's values, o.x[S / 2]
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        const T y = acc[i];
        T r;
        if (EPI == EPI_NONE) {
          r = y;
        } else if (EPI == EPI_RESIDUAL) {
          r = sub(o.b[i], y);
        } else if (EPI == EPI_CHEB_FIRST) {
          r = add(mul(p.scale, mul(o.d[i], sub(o.b[i], y))),
                  o.x[S / 2][i]);
        } else {
          const T z = mul(o.d[i], sub(o.b[i], y));
          const T t = add(mul(p.scale, z), o.x[S / 2][i]);
          r = add(mul(p.omega, sub(t, o.q[i])), o.q[i]);
        }
        p.out[(size_t)n * ND + i] = r;
      }
    }
  }
}

int sm_count() {
  static int count[MAX_DEVICES] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= MAX_DEVICES) return 0;
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 0;
  return count[dev];
}

template <typename T, int NDIM, int ND, int TN, int EPI>
int launch(const Params<T>& prm, int warps, int stages, int ctas,
           cudaStream_t stream) {
  constexpr int S = NDIM == 3 ? 27 : 9;
  constexpr size_t TILE_BYTES = (size_t)TN * S * ND * ND * sizeof(T);
  static bool opted[MAX_DEVICES] = {false};
  Params<T> p = prm;
  if (p.nnodes <= 0 || warps < 1 || warps > MAX_WARPS || stages < 1 ||
      ctas < 1)
    return (int)cudaErrorInvalidValue;
  const int nsm = sm_count();
  if (nsm <= 0) return (int)cudaErrorInvalidDevice;
  p.ntiles = (p.nnodes + TN - 1) / TN;
  p.stages = stages;
  // fewer warps per CTA when the tiles would not cover every SM
  warps = std::max(1, std::min(warps, p.ntiles / nsm));
  const size_t smem =
      ((warps * stages * 8 + 127) & ~(size_t)127) + warps * stages * TILE_BYTES;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < MAX_DEVICES && !opted[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        stencil_k4_kernel<T, NDIM, ND, TN, EPI>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    opted[dev] = true;
  }
  const int fit = (int)std::min((size_t)ctas, (size_t)SMEM_MAX / smem);
  const int grid =
      std::min((p.ntiles + warps - 1) / warps, nsm * std::max(1, fit));
  stencil_k4_kernel<T, NDIM, ND, TN, EPI>
      <<<grid, warps * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int TN, int EPI>
int dispatch_shape(const Params<T>& p, int ndim, int nd, int warps,
                   int stages, int ctas, cudaStream_t s) {
  if (ndim == 3 && nd == 3)
    return launch<T, 3, 3, TN, EPI>(p, warps, stages, ctas, s);
  if (ndim == 3 && nd == 2)
    return launch<T, 3, 2, TN, EPI>(p, warps, stages, ctas, s);
  if (ndim == 2 && nd == 3)
    return launch<T, 2, 3, TN, EPI>(p, warps, stages, ctas, s);
  if (ndim == 2 && nd == 2)
    return launch<T, 2, 2, TN, EPI>(p, warps, stages, ctas, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int TN>
int dispatch_epi(const Params<T>& p, int epi, int ndim, int nd, int warps,
                 int stages, int ctas, cudaStream_t s) {
  switch (epi) {
    case EPI_NONE:
      return dispatch_shape<T, TN, EPI_NONE>(p, ndim, nd, warps, stages,
                                             ctas, s);
    case EPI_RESIDUAL:
      return dispatch_shape<T, TN, EPI_RESIDUAL>(p, ndim, nd, warps, stages,
                                                 ctas, s);
    case EPI_CHEB_FIRST:
      return dispatch_shape<T, TN, EPI_CHEB_FIRST>(p, ndim, nd, warps,
                                                   stages, ctas, s);
    case EPI_CHEB_STEP:
      return dispatch_shape<T, TN, EPI_CHEB_STEP>(p, ndim, nd, warps, stages,
                                                  ctas, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch(const void* W, const void* x, void* out, const void* b,
             const void* d, const void* pkm1, double scale, double omega,
             int epi, int padded, int ndim, int nd, int nx, int ny, int nz,
             int tn, int warps, int stages, int ctas, void* stream) {
  if (epi < EPI_NONE || epi > EPI_CHEB_STEP) return (int)cudaErrorInvalidValue;
  if (epi != EPI_NONE && b == nullptr) return (int)cudaErrorInvalidValue;
  if (epi >= EPI_CHEB_FIRST && d == nullptr) return (int)cudaErrorInvalidValue;
  if (epi == EPI_CHEB_STEP && pkm1 == nullptr)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(W) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  Params<T> p;
  p.W = static_cast<const T*>(W);
  p.x = static_cast<const T*>(x);
  p.out = static_cast<T*>(out);
  p.b = static_cast<const T*>(b);
  p.d = static_cast<const T*>(d);
  p.pkm1 = static_cast<const T*>(pkm1);
  p.scale = static_cast<T>(scale);
  p.omega = static_cast<T>(omega);
  p.padded = padded != 0;
  p.nx = nx;
  p.ny = ny;
  p.nz = ndim == 3 ? nz : 1;
  p.nnodes = nx * ny * p.nz;
  p.ntiles = 0;
  p.stages = stages;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tn == 32)
    return dispatch_epi<T, 32>(p, epi, ndim, nd, warps, stages, ctas, s);
  if (tn == 16)
    return dispatch_epi<T, 16>(p, epi, ndim, nd, warps, stages, ctas, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// W (nz x ny x nx x 3^ndim x nd x nd; nz absent in 2D), 16-byte aligned;
// x ((nz+2) x (ny+2) x (nx+2) x nd when padded, else nz x ny x nx x nd),
// out, b, d and pkm1 (nz x ny x nx x nd; b, d, pkm1 may be null where the
// epilogue does not read them) are contiguous device arrays of one dtype
// on the stream's device; out is fully written and aliases no input. epi:
// 0 none, 1 residual, 2 cheb_first, 3 cheb_step. scale and omega are
// rounded to the dtype here (round to nearest, as torch converts a Python
// scalar). tn (16 or 32 nodes per tile), warps (per CTA, 1-8), stages (per
// warp) and ctas (per SM, at most what fits in shared memory) set the
// pipeline. Returns 0 or the cudaError_t of the refused or failed launch.
extern "C" int stencil_k4_f32(const void* W, const void* x, void* out,
                              const void* b, const void* d, const void* pkm1,
                              double scale, double omega, int epi, int padded,
                              int ndim, int nd, int nx, int ny, int nz, int tn,
                              int warps, int stages, int ctas, void* stream) {
  return dispatch<float>(W, x, out, b, d, pkm1, scale, omega, epi, padded,
                         ndim, nd, nx, ny, nz, tn, warps, stages, ctas,
                         stream);
}

extern "C" int stencil_k4_f64(const void* W, const void* x, void* out,
                              const void* b, const void* d, const void* pkm1,
                              double scale, double omega, int epi, int padded,
                              int ndim, int nd, int nx, int ny, int nz, int tn,
                              int warps, int stages, int ctas, void* stream) {
  return dispatch<double>(W, x, out, b, d, pkm1, scale, omega, epi, padded,
                          ndim, nd, nx, ny, nz, tn, warps, stages, ctas,
                          stream);
}
