// K1: fused velocity-block (A00) apply of the Q2-Q1 saddle operator.
//
//     y_u = sum_e G_e^T Bs^T diag(s_e) Bs G_e x_u          (no Dirichlet masks)
//
// Replaces exsaddle_tpu/pallas_apply.py:make_pallas_mult_u (pl.pallas_call
// at :190). Per element: gather 3^nd nodes x nd dofs from the
// parity-permuted vector, strain = Bs (nrow x ncol) x_e, scale by s_e,
// y_e = Bs^T strain, sum into the nodes. Bs is shared by every element
// (uniform box geometry); only s_e varies. In 3D Bs factors into one-axis
// 3x3 matrices (matfree.strain_factors), and the element products run by
// sum factorization (a00_factored_kernel, below), ~8.3k FLOP per element
// in place of the dense 52.6k; the dense products (a00_element_kernel) run
// in 2D only.
//
// Layout (matfree.parity_permutation): x is ONE flat vector holding the 2^nd
// parity classes of the Q2 node grid one after another; class p (bit a of p
// = parity of the node index along axis a) is a (z, y, x, nd) grid with
// nx_p = mx + 1 - (p & 1) nodes along x, and so on. Element
// e = ex + mx * (ey + my * ez); its local node (la, lb, lc) is global node
// (2ex+la, 2ey+lb, 2ez+lc), i.e. class (la&1 | (lb&1)<<1 | (lc&1)<<2) at
// (ex + la/2, ey + lb/2, ez + lc/2). Bs column nd*(la + 3 lb + 9 lc) + a.
//
// Bound on an H100 SXM (data-sheet peaks). At mx=32 the dense products are
// 32,768 elements x 2 products x 2*162*81 FLOP = 1.72 GFLOP against >= 27.9
// MB moved in float32 (x, y, scale_visc once each; 55.8 MB in float64).
// TF32 is not allowed (precision policy), so float32 runs on the FP32 CUDA
// cores: 25.7 us at 67 TFLOP/s against 8.3 us for the bytes, compute bound.
// The factored products are 0.27 GFLOP: 4 us in float32, 8 us in float64
// on the CUDA cores, so the factored apply is bound by its bytes (8.3 /
// 16.7 us, and the (nel, ncol) scratch's round trip through the L2).
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py, phase K1): the
// dense 3D apply, before the factored kernel, ~0.09-0.10 ms in either
// precision; the factored apply ~34 us float32 (element kernel ~22 us) and
// ~51 us float64 (~35 us).
//
// Two launches per apply:
//
// 1. a00_factored_kernel (3D; described at the kernel) or
//    a00_element_kernel (2D, the dense products): persistent blocks (as many
//    as fit on the card at
//    once: 2 per SM in float32, 1 in float64) walk tiles of TM = 32
//    consecutive elements in linear order over ALL elements. Per tile of
//    the dense kernel: S = X Bs^T (TM x ncol times ncol x nrow), S *=
//    scale_visc (one contiguous TM x nrow block), Ye = S Bs (TM x nrow
//    times nrow x ncol), written to a scratch (nel, ncol) array that stays
//    in the 50 MB L2.
// 2. a00_node_gather_kernel: one thread per velocity dof sums its <= 2^nd
//    element contributions in a fixed order (an ELL table built on the
//    host, kernels/a00.py:node_gather_table) and writes y: no zero fill, no
//    atomic, no colour, so repeated applies are bitwise equal.
//
// What the dense kernel does about the faults of the first (8-colour)
// version:
// - It computed each output in one thread, one Bs value and one x value
//   read from shared memory per FMA. Here each float32 thread owns a
//   register micro-tile (4 elements x 6 strain rows, then 4 elements x 3
//   columns) read with 16-byte vector loads, so one shared-memory read
//   feeds 3-6 FMAs; each float64 warp feeds the tensor cores 8-byte
//   fragments, 2 loads per 16x8x4 product.
// - It restaged Bs for every 8 elements (~215 MB of L2 -> shared traffic
//   per float32 apply). Here each persistent block stages Bs once.
// - It launched 8 colour kernels of 1.3 waves each per apply. Here one
//   element launch fills the card exactly once and the node gather follows;
//   the next tile's x_e gather runs with cp.async into a second buffer
//   while the current tile computes.
//
// Shared memory per block of the dense kernel, as sized for the 3D Bs it
// was written for (padded strides keep the vector and fragment reads free
// of bank conflicts; padding is zero):
// - float32: Bs 164 x 84, x tiles 2 x 32 x 84, strain 32 x 164 values:
//   97,600 B, two blocks of 216 threads per SM;
// - float64: Bs 168 x 84, x tiles 2 x 32 x 84, strain 32 x 164 values:
//   197,888 B, one block of 384 threads per SM;
// both above the 48 KB static limit, set with cudaFuncSetAttribute.
// 2D (Bs 27 x 18) runs the same two passes with its own shapes.
//
// Fused forms (the fine level of the ABF V-cycle and GCR's operator; the
// products, either route, and the node gather's summation order are the
// plain apply's):
// - keep in the loads: y_u = A00 (x_u ks). The x gather is cp.async
//   global -> shared, which cannot scale a value, so once a tile's copies
//   have landed (cp.async.wait_group, then a barrier) each thread scales
//   16-byte chunks of the tile in place by 1.0 or 0.0 from the keep's bits
//   (a bit table per element built once from ks,
//   kernels/a00.py:keep_bit_table; the words loaded into registers during
//   the previous tile's element_out): x * 0.0 and x * 1.0 round as
//   torch's xu * ks. It adds no cp.async buffer and no shared memory, so
//   the float32 pair of blocks per SM still fits. Measured on an H100 80GB
//   HBM3 at 700 W (k1_tune.py): ~2 us (float32) and ~4 us (float64) above
//   the plain apply's ~93 / ~90 us at mx=32.
// - store epilogues in the node gather (a00_fused_gather_kernel, the
//   epilogue a template parameter): mask, y ks + ms x_u; cheb_first and
//   cheb_step, K6's update on that masked y with x_u = x0 or p_k. The
//   arithmetic is cheb_math.cuh's, shared with K6 (cheb_update.cu), in the
//   twin's order with explicitly rounded intrinsics: each form gives the
//   bits of the plain apply followed by the torch ops (and K6) it replaces
//   (kernels/a00.py twins). The plain apply (no keep, no epilogue) runs the
//   same kernels as before the fused forms existed.

#include <cuda_runtime.h>

#include "cheb_math.cuh"

namespace {

template <int ND> struct Shape;
template <> struct Shape<3> {
  static constexpr int NCLS = 8, R = 162, C = 81, TC = 27;
};
template <> struct Shape<2> {
  static constexpr int NCLS = 4, R = 27, C = 18, TC = 9;
};

constexpr int TM = 32;   // elements per tile

constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }
constexpr int imax(int a, int b) { return a > b ? a : b; }

// Row stride (values) of a shared tile read with 16-byte vector loads, rows
// on consecutive threads: a multiple of the vector width v and an odd number
// of 16-byte units, so 8 consecutive rows start in 8 different bank groups.
constexpr int vec_stride(int len, int v) {
  return (round_up(len, v) / v) % 2 ? round_up(len, v) : round_up(len, v) + v;
}

// Row stride (doubles) of a tile read as MMA fragments (8 rows x 4 columns
// per warp, half a warp per shared-memory wavefront): 4 or 12 mod 16, so
// the 4 rows of a half warp land in 4 different groups of 8 banks.
constexpr int mma_stride(int len) {
  return round_up(len, 4) % 16 == 4 || round_up(len, 4) % 16 == 12
             ? round_up(len, 4) : mma_stride(len + 4);
}

struct Grid {
  int off[8];         // start of class p in the flat vector (in values)
  int nx[8], ny[8];   // node counts of class p along x and y
};

__device__ __forceinline__ float comp(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(sizeof(T)));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// ---------------------------------------------------------------------------
// Products on the CUDA cores (float32). Thread (te, tc) owns elements
// te*AE .. te*AE+AE-1 of the tile and strain rows tc + TC*j (B1 of them),
// then element columns tc + TC*j (B2 of them).
// ---------------------------------------------------------------------------
template <int ND> struct Simt {
  using S = Shape<ND>;
  using T = float;
  using V = float4;
  static constexpr int VW = 4;
  static constexpr int AE = 4, TE = TM / AE, TC = S::TC;
  static constexpr int NT = TE * TC, MINB = 2;
  static constexpr int B1 = S::R / TC, B2 = S::C / TC;
  static constexpr int KC = round_up(S::C, VW);   // depth of S = X Bs^T
  static constexpr int RP = round_up(S::R, VW);   // Bs rows = depth of S Bs
  static constexpr int LDX = vec_stride(S::C, VW);
  static constexpr int LDS = vec_stride(S::R, VW);
  static_assert(B1 * TC == S::R && B2 * TC == S::C, "TC must divide R, C");

  // ss[el][r] = (X Bs^T)[el][r] * scale[e0 + el][r]
  __device__ static void strain(const T* xt, const T* bs, T* ss,
                                const T* __restrict__ scale, int e0,
                                int nel) {
    const int te = threadIdx.x / TC, tc = threadIdx.x - te * TC;
    T sc[AE][B1], acc[AE][B1];
#pragma unroll
    for (int i = 0; i < AE; ++i) {
      const int e = e0 + te * AE + i;
#pragma unroll
      for (int j = 0; j < B1; ++j) {
        sc[i][j] = e < nel ? scale[(size_t)e * S::R + tc + TC * j] : T(0);
        acc[i][j] = T(0);
      }
    }
    for (int k = 0; k < KC; k += VW) {
      V xv[AE], bv[B1];
#pragma unroll
      for (int i = 0; i < AE; ++i)
        xv[i] = *reinterpret_cast<const V*>(xt + (te * AE + i) * LDX + k);
#pragma unroll
      for (int j = 0; j < B1; ++j)
        bv[j] = *reinterpret_cast<const V*>(bs + (tc + TC * j) * LDX + k);
#pragma unroll
      for (int q = 0; q < VW; ++q)
#pragma unroll
        for (int i = 0; i < AE; ++i)
#pragma unroll
          for (int j = 0; j < B1; ++j)
            acc[i][j] = fma(comp(xv[i], q), comp(bv[j], q), acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < AE; ++i)
#pragma unroll
      for (int j = 0; j < B1; ++j)
        ss[(te * AE + i) * LDS + tc + TC * j] = acc[i][j] * sc[i][j];
  }

  // ye[e0 + el][c] = (S Bs)[el][c]
  __device__ static void element_out(const T* ss, const T* bs,
                                     T* __restrict__ ye, int e0, int nel) {
    const int te = threadIdx.x / TC, tc = threadIdx.x - te * TC;
    T acc[AE][B2];
#pragma unroll
    for (int i = 0; i < AE; ++i)
#pragma unroll
      for (int j = 0; j < B2; ++j) acc[i][j] = T(0);
    for (int r = 0; r < RP; r += VW) {
      V sv[AE];
#pragma unroll
      for (int i = 0; i < AE; ++i)
        sv[i] = *reinterpret_cast<const V*>(ss + (te * AE + i) * LDS + r);
#pragma unroll
      for (int q = 0; q < VW; ++q) {
        T b[B2];
#pragma unroll
        for (int j = 0; j < B2; ++j) b[j] = bs[(r + q) * LDX + tc + TC * j];
#pragma unroll
        for (int i = 0; i < AE; ++i)
#pragma unroll
          for (int j = 0; j < B2; ++j)
            acc[i][j] = fma(comp(sv[i], q), b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < AE; ++i) {
      const int e = e0 + te * AE + i;
      if (e < nel)
#pragma unroll
        for (int j = 0; j < B2; ++j)
          ye[(size_t)e * S::C + tc + TC * j] = acc[i][j];
    }
  }
};

// ---------------------------------------------------------------------------
// Products on the FP64 tensor cores (float64): mma.sync m16n8k4 per warp.
// Fragments (PTX ISA, f64 m16n8k4), g = lane / 4, t = lane % 4, h < 2:
//   A (16x4, row) a[h] = A[g + 8h][t];  B (4x8, col) b = B[t][g];
//   C (16x8)      c[2h + i] = C[g + 8h][2t + i].
// Twelve warps: element tiles of 16 (2 per tile of TM), strain-row and
// element-column tiles of 8. S = X Bs^T: warp w owns both element tiles x
// row tiles w + 12s. Ye = S Bs: warp w owns element tile w%2 x column tiles
// w/2 + 6s.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mma16x8x4(double (&c)[4], const double (&a)[2],
                                          double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

template <int ND> struct Mma {
  using S = Shape<ND>;
  using T = double;
  static constexpr int NW = 12, NT = 32 * NW, MINB = 1;
  static constexpr int MT = TM / 16;            // element tiles
  static constexpr int N1 = (S::R + 7) / 8;     // strain-row tiles
  static constexpr int N2 = (S::C + 7) / 8;     // element-column tiles
  static constexpr int KC = round_up(S::C, 4);  // depth of S = X Bs^T
  static constexpr int K2 = round_up(S::R, 4);  // depth of S Bs
  static constexpr int RP = imax(8 * N1, K2);   // Bs rows
  static constexpr int LDX = mma_stride(KC);
  static constexpr int LDS = mma_stride(K2);
  static constexpr int NP1 = (N1 + NW - 1) / NW;
  static constexpr int NP2 = (N2 + NW / 2 - 1) / (NW / 2);
  static_assert(MT == 2, "the Ye split assigns one element tile per warp");

  __device__ static void strain(const T* xt, const T* bs, T* ss,
                                const T* __restrict__ scale, int e0,
                                int nel) {
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    T acc[MT][NP1][4], sc[MT][NP1][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int s = 0; s < NP1; ++s)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int e = e0 + m * 16 + g + 8 * (v >> 1);
          const int r = (w + NW * s) * 8 + 2 * t + (v & 1);
          sc[m][s][v] = e < nel && r < S::R ? scale[(size_t)e * S::R + r]
                                            : T(0);
          acc[m][s][v] = T(0);
        }
#pragma unroll
    for (int k = 0; k < KC; k += 4) {
      T a[MT][2], b[NP1];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          a[m][h] = xt[(m * 16 + g + 8 * h) * LDX + k + t];
#pragma unroll
      for (int s = 0; s < NP1; ++s)
        b[s] = w + NW * s < N1 ? bs[((w + NW * s) * 8 + g) * LDX + k + t]
                               : T(0);
#pragma unroll
      for (int s = 0; s < NP1; ++s)
        if (w + NW * s < N1)   // warp-uniform
#pragma unroll
          for (int m = 0; m < MT; ++m) mma16x8x4(acc[m][s], a[m], b[s]);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int s = 0; s < NP1; ++s)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int r = (w + NW * s) * 8 + 2 * t + (v & 1);
          if (r < S::R)
            ss[(m * 16 + g + 8 * (v >> 1)) * LDS + r] =
                acc[m][s][v] * sc[m][s][v];
        }
  }

  __device__ static void element_out(const T* ss, const T* bs,
                                     T* __restrict__ ye, int e0, int nel) {
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int m = w & 1, n0 = w >> 1;
    T acc[NP2][4];
#pragma unroll
    for (int s = 0; s < NP2; ++s)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[s][v] = T(0);
#pragma unroll
    for (int k = 0; k < K2; k += 4) {
      T a[2], b[NP2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        a[h] = ss[(m * 16 + g + 8 * h) * LDS + k + t];
#pragma unroll
      for (int s = 0; s < NP2; ++s) {
        const int c = (n0 + (NW / 2) * s) * 8 + g;
        b[s] = c < S::C ? bs[(k + t) * LDX + c] : T(0);
      }
#pragma unroll
      for (int s = 0; s < NP2; ++s)
        if (n0 + (NW / 2) * s < N2)   // warp-uniform
          mma16x8x4(acc[s], a, b[s]);
    }
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int e = e0 + m * 16 + g + 8 * (v >> 1);
      if (e < nel)
#pragma unroll
        for (int s = 0; s < NP2; ++s) {
          const int c = (n0 + (NW / 2) * s) * 8 + 2 * t + (v & 1);
          if (c < S::C) ye[(size_t)e * S::C + c] = acc[s][v];
        }
    }
  }
};

template <typename T, int ND> struct Products;
template <int ND> struct Products<float, ND> { using type = Simt<ND>; };
template <int ND> struct Products<double, ND> { using type = Mma<ND>; };

template <class P, typename T>
constexpr size_t smem_bytes() {
  return sizeof(T) * (size_t)(P::RP * P::LDX + 2 * TM * P::LDX +
                              TM * P::LDS);
}

// ---------------------------------------------------------------------------
// Pass 1: Ye = (X_e Bs^T * s_e) Bs for every element, persistent blocks.
// KEEP: x is scaled by the Dirichlet keep vector (0 or 1) once it has
// landed. The keep arrives as a bit table, one bit per element column
// (kernels/a00.py:keep_bit_table, NW words per element): a warp's loads of
// it touch one or two words, where loads of the keep vector at the
// gather's scattered indices would double the gather's L1 traffic; and
// the scaling runs by 16-byte chunks, a quarter (float32) of the scalar
// passes' instructions.
template <int C>
struct KeepBits {
  static constexpr int NW = (C + 31) / 32;   // words per element
};

// 16-byte chunks of a tile's x rows (rows are 16-byte aligned, their
// padding columns zero: any keep bit leaves them zero): thread tid takes
// chunks q = tid + j NT, element q / NV, columns W (q % NV) ..
template <typename T> struct Vec;
template <> struct Vec<float> { using V = float4; static constexpr int W = 4; };
template <> struct Vec<double> { using V = double2; static constexpr int W = 2; };

__device__ __forceinline__ void scale_chunk(float4& v, unsigned w, int c0) {
  v.x = cheb_math::mul(v.x, (w >> (c0 & 31)) & 1u ? 1.f : 0.f);
  v.y = cheb_math::mul(v.y, (w >> ((c0 + 1) & 31)) & 1u ? 1.f : 0.f);
  v.z = cheb_math::mul(v.z, (w >> ((c0 + 2) & 31)) & 1u ? 1.f : 0.f);
  v.w = cheb_math::mul(v.w, (w >> ((c0 + 3) & 31)) & 1u ? 1.f : 0.f);
}
__device__ __forceinline__ void scale_chunk(double2& v, unsigned w, int c0) {
  v.x = cheb_math::mul(v.x, (w >> (c0 & 31)) & 1u ? 1.0 : 0.0);
  v.y = cheb_math::mul(v.y, (w >> ((c0 + 1) & 31)) & 1u ? 1.0 : 0.0);
}

template <typename T, int C, int NT, int KPT>
__device__ __forceinline__ void keep_words(unsigned (&kw)[KPT],
                                           const unsigned* __restrict__ kb,
                                           int tid, int e0, int ne) {
  constexpr int W = Vec<T>::W, NV = (C + W - 1) / W;
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    const int q = tid + j * NT, el = q / NV, c0 = (q - el * NV) * W;
    kw[j] = q < ne * NV
                ? __ldg(kb + (size_t)(e0 + el) * KeepBits<C>::NW + (c0 >> 5))
                : 0u;
  }
}

template <typename T, int ND, class P, bool KEEP>
__global__ void __launch_bounds__(P::NT, P::MINB)
a00_element_kernel(const T* __restrict__ x, const unsigned* __restrict__ kb,
                   const T* __restrict__ scale, const T* __restrict__ Bs,
                   T* __restrict__ ye, int nel, int mx, int my, Grid g) {
  using S = Shape<ND>;
  constexpr int R = S::R, C = S::C, NCLS = S::NCLS;
  constexpr int LDX = P::LDX, NT = P::NT;
  constexpr int NV = (C + Vec<T>::W - 1) / Vec<T>::W;
  constexpr int KPT = (TM * NV + NT - 1) / NT;     // keep words per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bs = reinterpret_cast<T*>(smem_raw);   // P::RP x LDX
  T* xs = bs + P::RP * LDX;                 // 2 x TM x LDX
  T* ss = xs + 2 * TM * LDX;                // TM x P::LDS
  __shared__ int col_off[C], col_cls[C];    // per element column
  __shared__ int ebase[TM][NCLS];           // per tile element and class
  const int tid = threadIdx.x;

  for (int i = tid; i < P::RP * LDX; i += NT) {
    const int r = i / LDX, c = i - r * LDX;
    bs[i] = r < R && c < C ? Bs[r * C + c] : T(0);
  }
  for (int i = tid; i < 2 * TM * LDX + TM * P::LDS; i += NT) xs[i] = T(0);
  for (int c = tid; c < C; c += NT) {
    const int node = c / ND, a = c - node * ND;
    const int la = node % 3, lb = (node / 3) % 3, lc = node / 9;
    const int p = (la & 1) | ((lb & 1) << 1) | ((lc & 1) << 2);
    col_cls[c] = p;
    col_off[c] = g.off[p] +
                 (((lc >> 1) * g.ny[p] + (lb >> 1)) * g.nx[p] + (la >> 1)) *
                     ND + a;
  }

  const int ntiles = (nel + TM - 1) / TM;
  // flat-vector offset of each tile element's node (0,0,0) shifted into
  // class p: x index of column c = col_off[c] + ebase[el][col_cls[c]]
  auto element_bases = [&](int tile) {
    for (int i = tid; i < TM * NCLS; i += NT) {
      const int el = i / NCLS, p = i - el * NCLS;
      const int e = min(tile * TM + el, nel - 1);
      const int ex = e % mx, ey = (e / mx) % my, ez = e / (mx * my);
      ebase[el][p] = ((ez * g.ny[p] + ey) * g.nx[p] + ex) * ND;
    }
  };
  auto gather = [&](int tile, T* dst) {
    const int ne = min(TM, nel - tile * TM);
    for (int i = tid; i < ne * C; i += NT) {
      const int el = i / C, c = i - el * C;
      cp_async(dst + el * LDX + c, x + col_off[c] + ebase[el][col_cls[c]]);
    }
    cp_async_commit();
  };
  // KEEP: the keep words of this thread's chunks of a tile, in registers:
  // loaded for the next tile while this tile's element_out runs, applied
  // once that tile's copies have landed
  unsigned kw[KPT];

  int tile = blockIdx.x;
  if (tile < ntiles) element_bases(tile);
  __syncthreads();
  if (tile < ntiles) gather(tile, xs);
  if constexpr (KEEP)
    if (tile < ntiles)
      keep_words<T, C, NT>(kw, kb, tid, tile * TM,
                           min(TM, nel - tile * TM));
  __syncthreads();   // every thread has read ebase
  for (int it = 0; tile < ntiles; ++it, tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (next < ntiles) element_bases(next);
    // ebase ready; the other x buffer and the strain tile are free
    __syncthreads();
    if (next < ntiles)
      gather(next, xs + ((it + 1) & 1) * TM * LDX);
    else
      cp_async_commit();
    cp_async_wait_prev();   // this tile's group has landed
    if constexpr (KEEP) {
      // every copy has landed: x * keep by 16-byte chunks, in place
      __syncthreads();
      using V = typename Vec<T>::V;
      T* xt = xs + (it & 1) * TM * LDX;
      const int ne = min(TM, nel - tile * TM);
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int q = tid + j * NT, el = q / NV, c0 = (q - el * NV) * Vec<T>::W;
        if (q < ne * NV) {
          V* p = reinterpret_cast<V*>(xt + el * LDX + c0);
          V v = *p;
          scale_chunk(v, kw[j], c0);
          *p = v;
        }
      }
    }
    __syncthreads();
    P::strain(xs + (it & 1) * TM * LDX, bs, ss, scale, tile * TM, nel);
    __syncthreads();
    if constexpr (KEEP)
      if (next < ntiles)
        keep_words<T, C, NT>(kw, kb, tid, next * TM,
                             min(TM, nel - next * TM));
    P::element_out(ss, bs, ye, tile * TM, nel);
  }
}

// ---------------------------------------------------------------------------
// Pass 1, factored (3D; kernels/a00.py takes it where the operator holds the
// one-axis factors of Bs, matfree.strain_factors): the same Ye by sum
// factorization. dN_i/dx_a at Gauss point q factors as the product of three
// 3x3 matrices, D_a along axis a and N_b along the two others, so the nine
// gradient fields du_b/dx_a of an element come from one-axis contractions
// (x: N and D; y: N on both, D on the N one; z: N, N, D), 648 FMAs per
// component (the dense product's 13,122 FMAs per element against 1,944),
// and Ye from the transposed ones (z, y, x). F[axis][0: N, 1: D][q][l] are
// kernel arguments (__grid_constant__), so each contraction is an FMA chain
// with constant operands and the block keeps only data in shared memory.
//
// Block: 9 warps over tiles of TM = 32 elements, one element per lane;
// warp j owns line j of the element's 3 x 3 cross-section in each pass:
// (ly, lz) = (j % 3, j / 3) in the x passes, (qx, lz) in the y passes and
// (qx, qy) in the z pass, and holds the line's 3 points in registers. Each
// pass reads and writes whole warps of consecutive elements in the
// element-fastest tiles B and C (no bank conflict), and the z pass runs the
// strains, their scaling and the first transposed contraction in registers,
// in place in C. x lands in an [el][81] tile by cp.async (each thread
// copies the 9 values it reads, so only the thread's own wait_group guards
// them), the next tile's while this one computes; the keep scales them as
// they are read (x * 1.0 or x * 0.0, as the dense kernel's in-place pass).
// The element's scale row (nrow = 162 contiguous values) lands by cp.async
// of 2-value chunks into an [el][162] tile, issued a whole pass ahead; read
// as 2-value vectors (an odd stride of 81 chunks: no bank conflict). Ye
// leaves through an [el][81] tile in C, stored as 16-byte vectors over the
// tile's contiguous (TM x 81) rows.
//
// Operations per element: 3 x 648 FMAs forward, as many transposed, ~90 for
// the strains and scales, ~8.3k FLOP against the dense 52.6k; bytes as the
// dense kernel's (x, the scale row, Ye).
// ---------------------------------------------------------------------------
template <typename T>
struct Factors {
  T f[3][2][3][3];   // [axis][0: N, 1: D][q][l]
};

constexpr int FLINES = 9, FNT = 32 * FLINES;   // warps (lines), threads
constexpr int FC = 81, FR = 162;               // element columns, strain rows
constexpr int FB = 6 * 27, FCC = 9 * 27;       // the two pass tiles' fields
static_assert(TM == 32, "one element per lane");

template <typename T> struct Factored;
template <> struct Factored<float> {
  using V2 = float2;
  using V = float4;
  static constexpr int W = 4, MINB = 2;
};
template <> struct Factored<double> {
  using V2 = double2;
  using V = double2;
  static constexpr int W = 2, MINB = 1;
};

template <typename T>
constexpr size_t factored_smem() {
  return sizeof(T) * (size_t)TM * (FC + FB + FCC + FR);
}

// out[q] = sum_l M[q][l] in[l]
template <typename T>
__device__ __forceinline__ void contract(T (&out)[3], const T (&M)[3][3],
                                         const T (&in)[3]) {
#pragma unroll
  for (int q = 0; q < 3; ++q)
    out[q] = fma(M[q][2], in[2], fma(M[q][1], in[1], M[q][0] * in[0]));
}

// out[l] = sum_q M[q][l] in[q] (+ sum_q M2[q][l] in2[q])
template <typename T>
__device__ __forceinline__ void contract_t(T (&out)[3], const T (&M)[3][3],
                                           const T (&in)[3]) {
#pragma unroll
  for (int l = 0; l < 3; ++l)
    out[l] = fma(M[2][l], in[2], fma(M[1][l], in[1], M[0][l] * in[0]));
}
template <typename T>
__device__ __forceinline__ void contract_t(T (&out)[3], const T (&M)[3][3],
                                           const T (&in)[3],
                                           const T (&M2)[3][3],
                                           const T (&in2)[3]) {
#pragma unroll
  for (int l = 0; l < 3; ++l)
    out[l] = fma(M2[2][l], in2[2],
                 fma(M2[1][l], in2[1],
                     fma(M2[0][l], in2[0],
                         fma(M[2][l], in[2],
                             fma(M[1][l], in[1], M[0][l] * in[0])))));
}

template <typename T, bool KEEP>
__global__ void __launch_bounds__(FNT, Factored<T>::MINB)
a00_factored_kernel(const T* __restrict__ x, const unsigned* __restrict__ kb,
                    const T* __restrict__ scale,
                    const __grid_constant__ Factors<T> F,
                    T* __restrict__ ye, int nel, int mx, int my, Grid g) {
  using V2 = typename Factored<T>::V2;
  using V = typename Factored<T>::V;
  constexpr int W = Factored<T>::W;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);   // [el][FC]
  T* bt = xs + TM * FC;                     // [FB][el]
  T* ct = bt + TM * FB;                     // [FCC][el]; Ye as [el][FC]
  T* ss = ct + TM * FCC;                    // [el][FR]
  const int tid = threadIdx.x, j = tid >> 5, el = tid & 31;
  const int j3 = j % 3, j9 = j / 3;
  const int ntiles = (nel + TM - 1) / TM;

  // this thread's 9 x values: column 9 j + 3 lx + b, node (lx, ly, lz) =
  // (lx, j3, j9); its class and its offset from element (0, 0, 0)'s
  int cls[3], off[3];
#pragma unroll
  for (int lx = 0; lx < 3; ++lx) {
    const int p = (lx & 1) | ((j3 & 1) << 1) | ((j9 & 1) << 2);
    cls[lx] = p;
    off[lx] = g.off[p] +
              (((j9 >> 1) * g.ny[p] + (j3 >> 1)) * g.nx[p] + (lx >> 1)) * 3;
  }
  auto gather = [&](int tile) {
    const int e = tile * TM + el;
    if (e < nel) {
      const int ex = e % mx, ey = (e / mx) % my, ez = e / (mx * my);
#pragma unroll
      for (int lx = 0; lx < 3; ++lx) {
        const int p = cls[lx];
        const T* src = x + off[lx] + ((ez * g.ny[p] + ey) * g.nx[p] + ex) * 3;
#pragma unroll
        for (int b = 0; b < 3; ++b)
          cp_async(xs + el * FC + 9 * j + 3 * lx + b, src + b);
      }
    }
    cp_async_commit();
  };
  auto stage_scale = [&](int tile) {
    const int ne = min(TM, nel - tile * TM);
    const V2* src =
        reinterpret_cast<const V2*>(scale + (size_t)tile * TM * FR);
    V2* dst = reinterpret_cast<V2*>(ss);
    for (int i = tid; i < ne * (FR / 2); i += FNT) cp_async(dst + i, src + i);
    cp_async_commit();
  };
  // KEEP: the keep words of this thread's columns 9 j .. 9 j + 8
  unsigned kw0 = 0u, kw1 = 0u;
  auto keep_words = [&](int tile) {
    const size_t e = min(tile * TM + el, nel - 1);
    kw0 = __ldg(kb + e * KeepBits<FC>::NW + ((9 * j) >> 5));
    kw1 = __ldg(kb + e * KeepBits<FC>::NW + ((9 * j + 8) >> 5));
  };

  int tile = blockIdx.x;
  if (tile < ntiles) {
    gather(tile);
    stage_scale(tile);
    if constexpr (KEEP) keep_words(tile);
  }
  for (; tile < ntiles; tile += gridDim.x) {
    const int next = tile + gridDim.x;
    cp_async_wait_prev();   // this thread's x copies of the tile have landed
    // x: the line (., ly, lz) of each component through N_x and D_x
    {
      T u[3][3];   // [b][lx]
#pragma unroll
      for (int lx = 0; lx < 3; ++lx)
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          T v = xs[el * FC + 9 * j + 3 * lx + b];
          if constexpr (KEEP) {
            const int c = 9 * j + 3 * lx + b;
            const unsigned w = (c >> 5) == ((9 * j) >> 5) ? kw0 : kw1;
            v = cheb_math::mul(v, (w >> (c & 31)) & 1u ? T(1) : T(0));
          }
          u[b][lx] = v;
        }
#pragma unroll
      for (int b = 0; b < 3; ++b)
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          T o[3];
          contract(o, F.f[0][f], u[b]);
#pragma unroll
          for (int q = 0; q < 3; ++q)
            bt[((b * 2 + f) * 27 + q + 3 * j) * TM + el] = o[q];
        }
    }
    __syncthreads();   // x read; B written
    if (next < ntiles) {
      gather(next);
      if constexpr (KEEP) keep_words(next);
    } else {
      cp_async_commit();
    }
    // y: the line (qx, ., lz); NN, ND from the N_x field, DN from the D_x
    {
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        T vn[3], vd[3], o[3];
#pragma unroll
        for (int l = 0; l < 3; ++l) {
          vn[l] = bt[((b * 2) * 27 + j3 + 3 * l + 9 * j9) * TM + el];
          vd[l] = bt[((b * 2 + 1) * 27 + j3 + 3 * l + 9 * j9) * TM + el];
        }
        auto put = [&](int h) {
#pragma unroll
          for (int q = 0; q < 3; ++q)
            ct[((b * 3 + h) * 27 + j3 + 3 * q + 9 * j9) * TM + el] = o[q];
        };
        contract(o, F.f[1][0], vn);
        put(0);   // NN
        contract(o, F.f[1][1], vn);
        put(1);   // ND
        contract(o, F.f[1][0], vd);
        put(2);   // DN
      }
    }
    cp_async_wait_prev();   // this thread's scale copies have landed
    __syncthreads();        // C written; the tile's scales in place
    // z: the line (qx, qy, .); du_b/dx_a at its 3 points, the strains and
    // their scaling, then the first transposed contraction, in place in C
    {
      T gr[3][3][3];   // [b][a][qz]
#pragma unroll
      for (int b = 0; b < 3; ++b)
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          // a = 0: DN through N_z; 1: ND through N_z; 2: NN through D_z
          const int h = 2 - a;
          T v[3];
#pragma unroll
          for (int l = 0; l < 3; ++l)
            v[l] = ct[((b * 3 + h) * 27 + j + 9 * l) * TM + el];
          contract(gr[b][a], F.f[2][a == 2], v);
        }
      // t[a][d][qz]: the field that meets dN/dx_d in output component a
      T t[3][3][3];
#pragma unroll
      for (int qz = 0; qz < 3; ++qz) {
        const V2* sp = reinterpret_cast<const V2*>(ss + el * FR +
                                                   6 * (j + 9 * qz));
        const V2 s01 = sp[0], s23 = sp[1], s45 = sp[2];
        t[0][0][qz] = gr[0][0][qz] * s01.x;
        t[1][1][qz] = gr[1][1][qz] * s01.y;
        t[2][2][qz] = gr[2][2][qz] * s23.x;
        const T e01 = (gr[0][1][qz] + gr[1][0][qz]) * s23.y;
        const T e02 = (gr[0][2][qz] + gr[2][0][qz]) * s45.x;
        const T e12 = (gr[1][2][qz] + gr[2][1][qz]) * s45.y;
        t[0][1][qz] = t[1][0][qz] = e01;
        t[0][2][qz] = t[2][0][qz] = e02;
        t[1][2][qz] = t[2][1][qz] = e12;
      }
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          T o[3];
          contract_t(o, F.f[2][d == 2], t[a][d]);
#pragma unroll
          for (int l = 0; l < 3; ++l)
            ct[((a * 3 + d) * 27 + j + 9 * l) * TM + el] = o[l];
        }
    }
    __syncthreads();   // the scales read; C holds the z pass's fields
    if (next < ntiles)
      stage_scale(next);
    else
      cp_async_commit();
    // y transposed: the line (qx, ., lz); s = N_y^T t2 + D_y^T t1 (then
    // N_x^T), r = N_y^T t0 (then D_x^T)
    {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        T v[3][3], o[3];
#pragma unroll
        for (int d = 0; d < 3; ++d)
#pragma unroll
          for (int q = 0; q < 3; ++q)
            v[d][q] = ct[((a * 3 + d) * 27 + j3 + 3 * q + 9 * j9) * TM + el];
        contract_t(o, F.f[1][0], v[2], F.f[1][1], v[1]);
#pragma unroll
        for (int l = 0; l < 3; ++l)
          bt[((a * 2) * 27 + j3 + 3 * l + 9 * j9) * TM + el] = o[l];
        contract_t(o, F.f[1][0], v[0]);
#pragma unroll
        for (int l = 0; l < 3; ++l)
          bt[((a * 2 + 1) * 27 + j3 + 3 * l + 9 * j9) * TM + el] = o[l];
      }
    }
    __syncthreads();   // C read; B written
    // x transposed: the line (., ly, lz); Ye[el][9 j + 3 lx + a]
    {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        T vs[3], vr[3], o[3];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          vs[q] = bt[((a * 2) * 27 + q + 3 * j) * TM + el];
          vr[q] = bt[((a * 2 + 1) * 27 + q + 3 * j) * TM + el];
        }
        contract_t(o, F.f[0][0], vs, F.f[0][1], vr);
#pragma unroll
        for (int l = 0; l < 3; ++l) ct[el * FC + 9 * j + 3 * l + a] = o[l];
      }
    }
    __syncthreads();   // the tile's Ye rows in C
    {
      const int nv = min(TM, nel - tile * TM) * FC;
      T* dst = ye + (size_t)tile * TM * FC;
      for (int i = tid; i < nv / W; i += FNT)
        reinterpret_cast<V*>(dst)[i] = reinterpret_cast<const V*>(ct)[i];
      for (int i = nv / W * W + tid; i < nv; i += FNT) dst[i] = ct[i];
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 2: y[dof] = sum over the node's elements, in table order.
// ---------------------------------------------------------------------------
constexpr int GATHER_THREADS = 256;

template <typename T, int ND>
__global__ void __launch_bounds__(GATHER_THREADS)
a00_node_gather_kernel(const T* __restrict__ ye, const int* __restrict__ ell,
                       T* __restrict__ y, int nu) {
  constexpr int NS = 1 << ND;   // elements per node, at most
  const int i = blockIdx.x * GATHER_THREADS + threadIdx.x;
  if (i >= nu) return;
  const int node = i / ND, a = i - node * ND;
  const int4* row = reinterpret_cast<const int4*>(ell + (size_t)node * NS);
  int idx[NS];
#pragma unroll
  for (int v = 0; v < NS / 4; ++v) {
    const int4 q = __ldg(row + v);
    idx[4 * v] = q.x;
    idx[4 * v + 1] = q.y;
    idx[4 * v + 2] = q.z;
    idx[4 * v + 3] = q.w;
  }
  T acc = T(0);
#pragma unroll
  for (int s = 0; s < NS; ++s)
    if (idx[s] >= 0) acc += ye[idx[s] + a];
  y[i] = acc;
}

// The node gather with a store epilogue on the summed A00 value acc of
// (keep-scaled) x_u: EPI_MASK y = acc ks + ms x_u; EPI_FIRST K6's first
// iterate scale (d (b - y)) + x_u (x_u = x0); EPI_STEP K6's step
// omega ((scale (d (b - y)) + x_u) - p_km1) + p_km1 (x_u = p_k). The sum is
// the plain gather's, in its order.
enum { EPI_NONE = 0, EPI_MASK = 1, EPI_FIRST = 2, EPI_STEP = 3 };

template <typename T, int ND, int EPI>
__global__ void __launch_bounds__(GATHER_THREADS)
a00_fused_gather_kernel(const T* __restrict__ ye, const int* __restrict__ ell,
                        const T* __restrict__ xu, const T* __restrict__ ks,
                        const T* __restrict__ ms, const T* __restrict__ b,
                        const T* __restrict__ d, const T* __restrict__ pkm1,
                        T scale, T omega, T* __restrict__ y, int nu) {
  constexpr int NS = 1 << ND;   // elements per node, at most
  const int i = blockIdx.x * GATHER_THREADS + threadIdx.x;
  if (i >= nu) return;
  const int node = i / ND, a = i - node * ND;
  // the epilogue's operands, in flight with the table's and ye's loads
  const T k = ks[i], m = ms[i], x = xu[i];
  T bi = T(0), di = T(0), pm = T(0);
  if constexpr (EPI != EPI_MASK) {
    bi = b[i];
    di = d[i];
  }
  if constexpr (EPI == EPI_STEP) pm = pkm1[i];
  const int4* row = reinterpret_cast<const int4*>(ell + (size_t)node * NS);
  int idx[NS];
#pragma unroll
  for (int v = 0; v < NS / 4; ++v) {
    const int4 q = __ldg(row + v);
    idx[4 * v] = q.x;
    idx[4 * v + 1] = q.y;
    idx[4 * v + 2] = q.z;
    idx[4 * v + 3] = q.w;
  }
  T acc = T(0);
#pragma unroll
  for (int s = 0; s < NS; ++s)
    if (idx[s] >= 0) acc += ye[idx[s] + a];
  const T ax = cheb_math::masked(acc, k, m, x);
  if constexpr (EPI == EPI_MASK)
    y[i] = ax;
  else if constexpr (EPI == EPI_FIRST)
    y[i] = cheb_math::first(cheb_math::sub(bi, ax), di, x, scale);
  else
    y[i] = cheb_math::step(bi, ax, di, x, pm, scale, omega);
}

// What a fused launch adds to the plain apply: the keep vector (or null)
// and the epilogue's operands; and, for either, Bs's one-axis factors (3D
// only; 2D reads none).
template <typename T>
struct Fused {
  const unsigned* keep;   // keep_bit_table's words, or null
  const T *ks, *ms, *b, *d, *pkm1;
  double scale, omega;
  int epi;
  const double* fac;      // host: F[3][2][3][3] in float64, or null
};

// Blocks of `kernel` resident at once on the current device (its dynamic
// shared memory set first), found once per device and kept in `cache`.
template <typename K>
cudaError_t resident_blocks(K kernel, int nt, size_t smem, int (&cache)[64],
                            int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, nt,
                                                        smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cache[dev] = per_sm * sms;
  }
  *blocks = cache[dev];
  return cudaSuccess;
}

template <typename T, int ND, class P, bool KEEP>
int launch(const T* x, const T* scale, const T* Bs, const int* ell, T* ye,
           T* y, int mx, int my, int mz, const Fused<T>& f,
           cudaStream_t stream) {
  using S = Shape<ND>;
  if (ND == 2) mz = 1;
  Grid g{};
  int off = 0;
  for (int p = 0; p < S::NCLS; ++p) {
    const int nx = mx + 1 - (p & 1), ny = my + 1 - ((p >> 1) & 1);
    const int nz = ND == 3 ? mz + 1 - ((p >> 2) & 1) : 1;
    g.off[p] = off;
    g.nx[p] = nx;
    g.ny[p] = ny;
    off += nx * ny * nz * ND;
  }
  const int nu = off, nel = mx * my * mz;
  const int ntiles = (nel + TM - 1) / TM;
  int resident = 0;
  cudaError_t err;
  if constexpr (ND == 3) {
    if (f.fac == nullptr) return (int)cudaErrorInvalidValue;
    static int cache[64];
    constexpr size_t smem = factored_smem<T>();
    err = resident_blocks(a00_factored_kernel<T, KEEP>, FNT, smem, cache,
                          &resident);
    if (err != cudaSuccess) return (int)err;
    Factors<T> F;
    T* fv = &F.f[0][0][0][0];
    for (int i = 0; i < 54; ++i) fv[i] = static_cast<T>(f.fac[i]);
    a00_factored_kernel<T, KEEP>
        <<<ntiles < resident ? ntiles : resident, FNT, smem, stream>>>(
            x, f.keep, scale, F, ye, nel, mx, my, g);
  } else {
    static int cache[64];
    constexpr size_t smem = smem_bytes<P, T>();
    err = resident_blocks(a00_element_kernel<T, ND, P, KEEP>, P::NT, smem,
                          cache, &resident);
    if (err != cudaSuccess) return (int)err;
    a00_element_kernel<T, ND, P, KEEP>
        <<<ntiles < resident ? ntiles : resident, P::NT, smem, stream>>>(
            x, f.keep, scale, Bs, ye, nel, mx, my, g);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int gblocks = (nu + GATHER_THREADS - 1) / GATHER_THREADS;
  const T sc = static_cast<T>(f.scale), om = static_cast<T>(f.omega);
  switch (f.epi) {
    case EPI_NONE:
      a00_node_gather_kernel<T, ND>
          <<<gblocks, GATHER_THREADS, 0, stream>>>(ye, ell, y, nu);
      break;
    case EPI_MASK:
      a00_fused_gather_kernel<T, ND, EPI_MASK>
          <<<gblocks, GATHER_THREADS, 0, stream>>>(
              ye, ell, x, f.ks, f.ms, f.b, f.d, f.pkm1, sc, om, y, nu);
      break;
    case EPI_FIRST:
      a00_fused_gather_kernel<T, ND, EPI_FIRST>
          <<<gblocks, GATHER_THREADS, 0, stream>>>(
              ye, ell, x, f.ks, f.ms, f.b, f.d, f.pkm1, sc, om, y, nu);
      break;
    case EPI_STEP:
      a00_fused_gather_kernel<T, ND, EPI_STEP>
          <<<gblocks, GATHER_THREADS, 0, stream>>>(
              ye, ell, x, f.ks, f.ms, f.b, f.d, f.pkm1, sc, om, y, nu);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T, int ND>
int launch_nd(const T* x, const T* scale, const T* Bs, const int* ell, T* ye,
              T* y, int mx, int my, int mz, const Fused<T>& f,
              cudaStream_t s) {
  using P = typename Products<T, ND>::type;
  if (f.keep != nullptr)
    return launch<T, ND, P, true>(x, scale, Bs, ell, ye, y, mx, my, mz, f,
                                  s);
  return launch<T, ND, P, false>(x, scale, Bs, ell, ye, y, mx, my, mz, f, s);
}

template <typename T>
int dispatch(const void* x, const void* scale, const void* Bs,
             const void* ell, void* ye, void* y, int nd, int mx, int my,
             int mz, const Fused<T>& f, void* stream) {
  const T* xt = static_cast<const T*>(x);
  const T* st = static_cast<const T*>(scale);
  const T* bt = static_cast<const T*>(Bs);
  const int* et = static_cast<const int*>(ell);
  T* yet = static_cast<T*>(ye);
  T* yt = static_cast<T*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f.epi != EPI_NONE && f.ks == nullptr) return (int)cudaErrorInvalidValue;
  if (nd == 3)
    return launch_nd<T, 3>(xt, st, bt, et, yet, yt, mx, my, mz, f, s);
  if (nd == 2)
    return launch_nd<T, 2>(xt, st, bt, et, yet, yt, mx, my, mz, f, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int fused(const void* x, const void* keep, const void* scale, const void* Bs,
          const void* fac, const void* ell, void* ye, void* y,
          const void* ks, const void* ms, const void* b, const void* d,
          const void* pkm1, double cs, double omega, int epi, int nd, int mx,
          int my, int mz, void* stream) {
  const Fused<T> f{static_cast<const unsigned*>(keep),
                   static_cast<const T*>(ks),
                   static_cast<const T*>(ms),   static_cast<const T*>(b),
                   static_cast<const T*>(d),    static_cast<const T*>(pkm1),
                   cs, omega, epi, static_cast<const double*>(fac)};
  return dispatch<T>(x, scale, Bs, ell, ye, y, nd, mx, my, mz, f, stream);
}

}  // namespace

// x (nu), scale_visc (nel x nrow), Bs (nrow x ncol), the node table ell
// (nu / nd x 2^nd int32, kernels/a00.py:node_gather_table), the scratch ye
// (nel x ncol) and y (nu) are contiguous device arrays on the stream's
// device, of one dtype but for ell; y is fully written (no zero fill).
// fac is a HOST array of Bs's one-axis factors, F[3][2][3][3] in float64
// (matfree.strain_factors), rounded to the dtype here and passed as kernel
// arguments: the 3D element products run factored from them, and a 3D
// launch with fac null returns cudaErrorInvalidValue. 2D reads no fac and
// runs the dense products with Bs.
// Returns 0 or the cudaError_t of the failed launch.
extern "C" int a00_apply_f32(const void* x, const void* scale, const void* Bs,
                             const void* fac, const void* ell, void* ye,
                             void* y, int nd, int mx, int my, int mz,
                             void* stream) {
  return fused<float>(x, nullptr, scale, Bs, fac, ell, ye, y, nullptr,
                      nullptr, nullptr, nullptr, nullptr, 0.0, 0.0, EPI_NONE,
                      nd, mx, my, mz, stream);
}

extern "C" int a00_apply_f64(const void* x, const void* scale, const void* Bs,
                             const void* fac, const void* ell, void* ye,
                             void* y, int nd, int mx, int my, int mz,
                             void* stream) {
  return fused<double>(x, nullptr, scale, Bs, fac, ell, ye, y, nullptr,
                       nullptr, nullptr, nullptr, nullptr, 0.0, 0.0,
                       EPI_NONE, nd, mx, my, mz, stream);
}

// The fused forms: keep (kernels/a00.py:keep_bit_table's nel x NW int32
// words of the operator's keep vector, or null) scales x in the element
// kernel's loads;
// epi (0 none, 1 mask, 2 cheb_first, 3 cheb_step) picks the node gather's
// store epilogue, which reads x itself as x_u (x0, p_k), the keep and mask
// vectors ks, ms (both non-null with an epilogue), b and d (the Chebyshev
// forms) and p_km1 (the step), each a contiguous nu-vector of x's dtype;
// scale and omega are rounded to the dtype here (as torch rounds a Python
// scalar). y aliases no input. fac as for the plain apply.
extern "C" int a00_fused_f32(const void* x, const void* keep,
                             const void* scale, const void* Bs,
                             const void* fac, const void* ell, void* ye,
                             void* y, const void* ks, const void* ms,
                             const void* b, const void* d, const void* pkm1,
                             double cs, double omega, int epi, int nd, int mx,
                             int my, int mz, void* stream) {
  return fused<float>(x, keep, scale, Bs, fac, ell, ye, y, ks, ms, b, d,
                      pkm1, cs, omega, epi, nd, mx, my, mz, stream);
}

extern "C" int a00_fused_f64(const void* x, const void* keep,
                             const void* scale, const void* Bs,
                             const void* fac, const void* ell, void* ye,
                             void* y, const void* ks, const void* ms,
                             const void* b, const void* d, const void* pkm1,
                             double cs, double omega, int epi, int nd, int mx,
                             int my, int mz, void* stream) {
  return fused<double>(x, keep, scale, Bs, fac, ell, ye, y, ks, ms, b, d,
                       pkm1, cs, omega, epi, nd, mx, my, mz, stream);
}

extern "C" const char* a00_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
