// K4: the 3^ndim-point block stencil apply of the deep multigrid levels.
//
//     y[n, i] = sum_s sum_j W[n, s, i, j] * xp[n + off(s), j]
//
// Replaces exsaddle_tpu/abf.py:240 stencil_accum (and its TPU production
// form stencil_apply_merged, :295): XLA fused it into one loop on the TPU.
// W is (*grid, 3^ndim, nd, nd), contiguous, grid reversed (z, y, x); xp is
// (*grid + 2, nd) with one ghost layer per side (zeros at domain edges,
// the neighbours' planes on the sharded path); y is (*grid, nd). Slots s
// run x-fastest over the offsets -1..1 (kernels/stencil.py stencil_offsets).
//
// Bound on an H100 SXM (data-sheet peaks): each W entry is used once, so
// the apply streams W and does 2 FLOP per entry. At the mx=32 flagship's
// L-2 level (33^3 = 35,937 nodes, nd = 3) W is 34.9 MB in float32 (69.9 MB
// in float64) against 0.5 MB of xp and 0.4 MB of y: ~10.7 us (21.4 us) at
// 3.35 TB/s, against 17.5 MFLOP (0.3 us at 67 TFLOP/s). Bytes bound it.
// The float32 L-2 W fits in the 50 MB L2, so back-to-back applies (the
// smoother's) may read it from L2 and beat the HBM bound.
//
// Design, a streaming kernel with no tensor-core work (no matmul to give
// them): a block owns TN consecutive nodes (32 in float32, 16 in float64),
// whose W entries are one contiguous run of TN * 3^ndim * nd * nd values.
// All threads copy that run into shared memory with 16-byte coalesced
// loads, LOADS of them in flight per thread (scalar loads where W is not
// 16-byte aligned), at a per-node stride padded to an odd count so the
// compute phase's reads of neighbouring nodes spread over the banks. Then each thread owns one
// (node, row) pair: it gathers the 3^ndim neighbours' nd values from xp
// (a few hundred KB, L1/L2-resident) and sums in the JAX package's order,
// slot by slot and within a slot over j. No atomics: the result is
// deterministic. Tile bytes stay under 48 KB (31,104 B at ndim = nd = 3 in
// either precision), so no opt-in for large shared memory is needed and
// several blocks per SM keep loads in flight.
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py, phase
// mg_kernels; 50 applies replayed as one graph): 12.5 us per float32 L-2
// apply (86% of the HBM bound, W L2-resident across the replays), 48.9 us
// in float64 (44%); with one 16-byte load in flight per thread the float32
// apply took 21.0 us and the float64 70.6 us.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> struct Tile;
template <> struct Tile<float> { static constexpr int nodes = 32; };
template <> struct Tile<double> { static constexpr int nodes = 16; };

template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; };
template <> struct Vec<double> { using type = double2; };

// 16-byte loads each thread has in flight while it stages W
constexpr int LOADS = 8;

template <typename T, int NDIM, int ND>
__global__ void stencil_accum_kernel(const T* __restrict__ W,
                                     const T* __restrict__ xp,
                                     T* __restrict__ y, int nx, int ny,
                                     int nnodes, bool vec_ok) {
  constexpr int S = NDIM == 3 ? 27 : 9;
  constexpr int K = S * ND * ND;           // W values per node
  constexpr int KP = K | 1;                // odd shared-memory stride
  constexpr int TN = Tile<T>::nodes;
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sw = reinterpret_cast<T*>(smem_raw);

  const int n0 = blockIdx.x * TN;
  const int nt = min(TN, nnodes - n0);
  const int count = nt * K;
  const T* src = W + (size_t)n0 * K;
  int done = 0;
  if (vec_ok) {
    // n0 * K * sizeof(T) is a multiple of 128 B: the run stays aligned.
    // Each thread issues LOADS independent 16-byte loads before it stores
    // any, so a block keeps LOADS * blockDim.x * 16 B in flight.
    using V = typename Vec<T>::type;
    const V* src_v = reinterpret_cast<const V*>(src);
    const int nvec = count / VEC;
    for (int v0 = threadIdx.x; v0 < nvec; v0 += LOADS * blockDim.x) {
      V q[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int v = v0 + u * blockDim.x;
        if (v < nvec) q[u] = src_v[v];
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int v = v0 + u * blockDim.x;
        if (v < nvec) {
          const T* vals = reinterpret_cast<const T*>(&q[u]);
#pragma unroll
          for (int c = 0; c < VEC; ++c) {
            const int e = v * VEC + c;
            sw[(e / K) * KP + e % K] = vals[c];
          }
        }
      }
    }
    done = nvec * VEC;
  }
  for (int e = done + threadIdx.x; e < count; e += blockDim.x)
    sw[(e / K) * KP + e % K] = src[e];
  __syncthreads();

  const int ln = threadIdx.x / ND;
  const int row = threadIdx.x % ND;
  if (ln >= nt) return;
  const int n = n0 + ln;
  const int px = nx + 2, py = ny + 2;
  const int ix = n % nx;
  int center;
  if (NDIM == 3) {
    const int iy = (n / nx) % ny, iz = n / (nx * ny);
    center = ((iz + 1) * py + (iy + 1)) * px + (ix + 1);
  } else {
    center = (n / nx + 1) * px + (ix + 1);
  }
  const T* w = sw + ln * KP + row * ND;
  T acc = T(0);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int dx = s % 3 - 1, dy = (s / 3) % 3 - 1, dz = s / 9 - 1;
    const int nb = center + (NDIM == 3 ? dz * py * px : 0) + dy * px + dx;
    const T* xs = xp + (size_t)nb * ND;
    const T* ws = w + s * ND * ND;
    T t = ws[0] * __ldg(xs);
#pragma unroll
    for (int j = 1; j < ND; ++j) t += ws[j] * __ldg(xs + j);
    acc += t;
  }
  y[(size_t)n * ND + row] = acc;
}

template <typename T, int NDIM, int ND>
int launch(const T* W, const T* xp, T* y, int nx, int ny, int nz,
           cudaStream_t stream) {
  constexpr int S = NDIM == 3 ? 27 : 9;
  constexpr int KP = (S * ND * ND) | 1;
  constexpr int TN = Tile<T>::nodes;
  const int nnodes = nx * ny * nz;
  if (nnodes <= 0) return (int)cudaErrorInvalidValue;
  const bool vec_ok = (reinterpret_cast<uintptr_t>(W) % 16) == 0;
  const size_t smem = (size_t)TN * KP * sizeof(T);
  stencil_accum_kernel<T, NDIM, ND>
      <<<(nnodes + TN - 1) / TN, TN * ND, smem, stream>>>(W, xp, y, nx, ny,
                                                          nnodes, vec_ok);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* W, const void* xp, void* y, int ndim, int nd,
             int nx, int ny, int nz, void* stream) {
  const T* wt = static_cast<const T*>(W);
  const T* xt = static_cast<const T*>(xp);
  T* yt = static_cast<T*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ndim == 3 && nd == 3) return launch<T, 3, 3>(wt, xt, yt, nx, ny, nz, s);
  if (ndim == 3 && nd == 2) return launch<T, 3, 2>(wt, xt, yt, nx, ny, nz, s);
  if (ndim == 2 && nd == 3) return launch<T, 2, 3>(wt, xt, yt, nx, ny, 1, s);
  if (ndim == 2 && nd == 2) return launch<T, 2, 2>(wt, xt, yt, nx, ny, 1, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// W (nz x ny x nx x 3^ndim x nd x nd; nz absent in 2D), xp ((nz+2) x (ny+2)
// x (nx+2) x nd) and y (nz x ny x nx x nd) are contiguous device arrays of
// one dtype on the stream's device; y is fully written. Returns 0 or the
// cudaError_t of the failed launch.
extern "C" int stencil_accum_f32(const void* W, const void* xp, void* y,
                                 int ndim, int nd, int nx, int ny, int nz,
                                 void* stream) {
  return dispatch<float>(W, xp, y, ndim, nd, nx, ny, nz, stream);
}

extern "C" int stencil_accum_f64(const void* W, const void* xp, void* y,
                                 int ndim, int nd, int nx, int ny, int nz,
                                 void* stream) {
  return dispatch<double>(W, xp, y, ndim, nd, nx, ny, nz, stream);
}
