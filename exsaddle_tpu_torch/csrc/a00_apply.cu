// K1: fused velocity-block (A00) apply of the Q2-Q1 saddle operator.
//
//     y_u = sum_e G_e^T Bs^T diag(s_e) Bs G_e x_u          (no Dirichlet masks)
//
// Replaces exsaddle_tpu/pallas_apply.py:make_pallas_mult_u. Per element:
// gather 3^nd nodes x nd dofs from the parity-permuted vector, strain =
// Bs (nrow x ncol) x_e, scale by s_e, y_e = Bs^T strain, scatter-add. Bs is
// shared by every element (uniform box geometry); only s_e varies.
//
// Layout (matfree.parity_permutation): x is ONE flat vector holding the 2^nd
// parity classes of the Q2 node grid one after another; class p (bit a of p
// = parity of the node index along axis a) is a (z, y, x, nd) grid with
// nx_p = mx + 1 - (p & 1) nodes along x, and so on. Element
// e = ex + mx * (ey + my * ez); its local node (la, lb, lc) is global node
// (2ex+la, 2ey+lb, 2ez+lc), i.e. class (la&1 | (lb&1)<<1 | (lc&1)<<2) at
// (ex + la/2, ey + lb/2, ez + lc/2). Bs column nd*(la + 3 lb + 9 lc) + a.
//
// Determinism without atomics: elements are swept in 2^nd colours
// (ex&1, ey&1, ez&1), one launch per colour. Two elements of one colour are
// two apart along some axis and share no node, so each launch adds into y
// with plain read-modify-writes, and the result does not depend on the
// schedule (iteration counts of the solves that use it are reproducible).
//
// Bound on an H100 SXM (data-sheet figures, not measured): at mx=32 one
// apply is 32768 elements x 2 products x 2*162*81 FLOP = 1.72 GFLOP against
// >= ~28 MB moved in float32 (x, y, scale_visc). TF32 is not allowed
// (precision policy), so the products run on the FP32 CUDA cores (67
// TFLOP/s) and the kernel is compute bound: >= 26 us at peak vs >= 8 us for
// the bytes. This first version keeps Bs in shared memory (52,488 B float32,
// 104,976 B float64; dynamic shared memory above the 48 KB static limit),
// stages a few elements' x_e and strain in shared memory, and computes each
// output row as a dot product in one thread. Its shared-memory traffic (one
// Bs load per FMA) bounds it well below the FP32 peak; register tiling and
// tensor-core float64 (DMMA) are later work.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

template <int ND> struct Shape;
template <> struct Shape<3> {
  static constexpr int NCLS = 8, NROW = 162, NCOL = 81;
  static constexpr int THREADS = 324, ELEMS = 8;   // 2 threads per row
};
template <> struct Shape<2> {
  static constexpr int NCLS = 4, NROW = 27, NCOL = 18;
  static constexpr int THREADS = 216, ELEMS = 16;
};

struct Classes {
  long long off[8];   // start of class p in the flat vector (in values)
  int nx[8], ny[8];   // node counts of class p along x and y
};

template <int ND>
__device__ __forceinline__ long long dof_index(const Classes& c, int ex,
                                               int ey, int ez, int col) {
  const int node = col / ND, a = col - node * ND;
  const int la = node % 3, lb = (node / 3) % 3, lc = node / 9;
  const int p = (la & 1) | ((lb & 1) << 1) | ((lc & 1) << 2);
  const long long ii = ex + (la >> 1), jj = ey + (lb >> 1), kk = ez + (lc >> 1);
  return c.off[p] + ((kk * c.ny[p] + jj) * c.nx[p] + ii) * ND + a;
}

template <typename T, int ND>
__global__ void __launch_bounds__(Shape<ND>::THREADS)
a00_colour_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                  const T* __restrict__ Bs, T* __restrict__ y, int mx, int my,
                  int cx, int cy, int cz, int ncx, int ncy, int ncol_el,
                  Classes cls) {
  using S = Shape<ND>;
  constexpr int R = S::NROW, C = S::NCOL, E = S::ELEMS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bs = reinterpret_cast<T*>(smem_raw);   // R x C
  T* xs = bs + R * C;                       // E x C
  T* ss = xs + E * C;                       // E x R
  __shared__ int eidx[E][4];                // ex, ey, ez, linear element

  for (int i = threadIdx.x; i < R * C; i += blockDim.x) bs[i] = Bs[i];

  for (int first = blockIdx.x * E; first < ncol_el; first += gridDim.x * E) {
    const int ne = min(E, ncol_el - first);
    __syncthreads();   // Bs loaded / previous chunk done with xs, ss, eidx
    if (threadIdx.x < ne) {
      const int ci = first + threadIdx.x;
      const int ix = ci % ncx, iy = (ci / ncx) % ncy, iz = ci / (ncx * ncy);
      const int ex = cx + 2 * ix, ey = cy + 2 * iy, ez = cz + 2 * iz;
      eidx[threadIdx.x][0] = ex;
      eidx[threadIdx.x][1] = ey;
      eidx[threadIdx.x][2] = ez;
      eidx[threadIdx.x][3] = ex + mx * (ey + my * ez);
    }
    __syncthreads();
    // gather x_e
    for (int i = threadIdx.x; i < ne * C; i += blockDim.x) {
      const int el = i / C, col = i - el * C;
      xs[i] = x[dof_index<ND>(cls, eidx[el][0], eidx[el][1], eidx[el][2], col)];
    }
    __syncthreads();
    // strain = Bs x_e, scaled by s_e
    for (int i = threadIdx.x; i < ne * R; i += blockDim.x) {
      const int el = i / R, r = i - el * R;
      const T* brow = bs + r * C;
      const T* xe = xs + el * C;
      T acc = T(0);
#pragma unroll 9
      for (int k = 0; k < C; ++k) acc += brow[k] * xe[k];
      ss[i] = acc * scale[(long long)eidx[el][3] * R + r];
    }
    __syncthreads();
    // y_e = Bs^T strain, scatter-add (no other element of this colour
    // touches these dofs)
    for (int i = threadIdx.x; i < ne * C; i += blockDim.x) {
      const int el = i / C, col = i - el * C;
      const T* se = ss + el * R;
      T acc = T(0);
#pragma unroll 9
      for (int r = 0; r < R; ++r) acc += bs[r * C + col] * se[r];
      y[dof_index<ND>(cls, eidx[el][0], eidx[el][1], eidx[el][2], col)] += acc;
    }
  }
}

template <typename T, int ND>
int launch_all(const T* x, const T* scale, const T* Bs, T* y, int mx, int my,
               int mz, cudaStream_t stream) {
  using S = Shape<ND>;
  if (ND == 2) mz = 1;
  Classes cls{};
  long long off = 0;
  for (int p = 0; p < S::NCLS; ++p) {
    const int nx = mx + 1 - (p & 1), ny = my + 1 - ((p >> 1) & 1);
    const int nz = ND == 3 ? mz + 1 - ((p >> 2) & 1) : 1;
    cls.off[p] = off;
    cls.nx[p] = nx;
    cls.ny[p] = ny;
    off += (long long)nx * ny * nz * ND;
  }
  const size_t smem = sizeof(T) * (size_t)(S::NROW * S::NCOL
                                           + S::ELEMS * (S::NROW + S::NCOL));
  cudaError_t err = cudaFuncSetAttribute(
      a00_colour_kernel<T, ND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  for (int colour = 0; colour < (1 << ND); ++colour) {
    const int cx = colour & 1, cy = (colour >> 1) & 1, cz = (colour >> 2) & 1;
    const int ncx = (mx - cx + 1) / 2, ncy = (my - cy + 1) / 2;
    const int ncz = ND == 3 ? (mz - cz + 1) / 2 : 1;
    const int n = ncx * ncy * ncz;
    if (n == 0) continue;
    const int blocks = (n + S::ELEMS - 1) / S::ELEMS;
    a00_colour_kernel<T, ND><<<blocks, S::THREADS, smem, stream>>>(
        x, scale, Bs, y, mx, my, cx, cy, cz, ncx, ncy, n, cls);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T>
int dispatch(const void* x, const void* scale, const void* Bs, void* y,
             int nd, int mx, int my, int mz, void* stream) {
  const T* xt = static_cast<const T*>(x);
  const T* st = static_cast<const T*>(scale);
  const T* bt = static_cast<const T*>(Bs);
  T* yt = static_cast<T*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nd == 3) return launch_all<T, 3>(xt, st, bt, yt, mx, my, mz, s);
  if (nd == 2) return launch_all<T, 2>(xt, st, bt, yt, mx, my, mz, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// y must be zeroed by the caller; x, scale_visc (nel x nrow), Bs (nrow x
// ncol) and y are contiguous device arrays of one dtype on the stream's
// device. Returns 0 or the cudaError_t of the failed launch.
extern "C" int a00_apply_f32(const void* x, const void* scale, const void* Bs,
                             void* y, int nd, int mx, int my, int mz,
                             void* stream) {
  return dispatch<float>(x, scale, Bs, y, nd, mx, my, mz, stream);
}

extern "C" int a00_apply_f64(const void* x, const void* scale, const void* Bs,
                             void* y, int nd, int mx, int my, int mz,
                             void* stream) {
  return dispatch<double>(x, scale, Bs, y, nd, mx, my, mz, stream);
}

extern "C" const char* a00_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
