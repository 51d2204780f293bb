// K1: fused velocity-block (A00) apply of the Q2-Q1 saddle operator.
//
//     y_u = sum_e G_e^T Bs^T diag(s_e) Bs G_e x_u          (no Dirichlet masks)
//
// Replaces exsaddle_tpu/pallas_apply.py:make_pallas_mult_u (pl.pallas_call
// at :190). Per element: gather 3^nd nodes x nd dofs from the
// parity-permuted vector, strain = Bs (nrow x ncol) x_e, scale by s_e,
// y_e = Bs^T strain, sum into the nodes. Bs is shared by every element
// (uniform box geometry); only s_e varies.
//
// Layout (matfree.parity_permutation): x is ONE flat vector holding the 2^nd
// parity classes of the Q2 node grid one after another; class p (bit a of p
// = parity of the node index along axis a) is a (z, y, x, nd) grid with
// nx_p = mx + 1 - (p & 1) nodes along x, and so on. Element
// e = ex + mx * (ey + my * ez); its local node (la, lb, lc) is global node
// (2ex+la, 2ey+lb, 2ez+lc), i.e. class (la&1 | (lb&1)<<1 | (lc&1)<<2) at
// (ex + la/2, ey + lb/2, ez + lc/2). Bs column nd*(la + 3 lb + 9 lc) + a.
//
// Bound on an H100 SXM (data-sheet peaks). At mx=32 one apply is 32,768
// elements x 2 products x 2*162*81 FLOP = 1.72 GFLOP against >= 27.9 MB
// moved in float32 (x, y, scale_visc once each; 55.8 MB in float64).
// TF32 is not allowed (precision policy), so float32 runs on the FP32 CUDA
// cores: 25.7 us at 67 TFLOP/s against 8.3 us for the bytes, compute bound.
// float64 runs on the FP64 tensor cores (mma.sync m16n8k4, IEEE FMA): 25.7
// us at 67 TFLOP/s against 16.7 us for the bytes. Measured on an H100 80GB
// HBM3 at 700 W (chip_smoke.py, phase K1): ~0.10 ms per apply in either
// precision, a quarter of the bound.
//
// Two launches per apply:
//
// 1. a00_element_kernel: persistent blocks (as many as fit on the card at
//    once: 2 per SM in float32, 1 in float64) walk tiles of TM = 32
//    consecutive elements in linear order over ALL elements. Per tile:
//    S = X Bs^T (TM x ncol times ncol x nrow), S *= scale_visc (one
//    contiguous TM x nrow block), Ye = S Bs (TM x nrow times nrow x ncol),
//    written to a scratch (nel, ncol) array that stays in the 50 MB L2.
// 2. a00_node_gather_kernel: one thread per velocity dof sums its <= 2^nd
//    element contributions in a fixed order (an ELL table built on the
//    host, kernels/a00.py:node_gather_table) and writes y: no zero fill, no
//    atomic, no colour, so repeated applies are bitwise equal.
//
// What this does about the faults of the first (8-colour) version:
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
// Shared memory per block (padded strides keep the vector and fragment
// reads free of bank conflicts; padding is zero):
// - float32: Bs 164 x 84, x tiles 2 x 32 x 84, strain 32 x 164 values:
//   97,600 B, two blocks of 216 threads per SM;
// - float64: Bs 168 x 84, x tiles 2 x 32 x 84, strain 32 x 164 values:
//   197,888 B, one block of 384 threads per SM;
// both above the 48 KB static limit, set with cudaFuncSetAttribute.
// 2D (Bs 27 x 18) runs the same two passes with its own shapes.
//
// Fused forms (the fine level of the ABF V-cycle and GCR's operator; the
// products and the node gather's summation order are the plain apply's):
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
// and the epilogue's operands.
template <typename T>
struct Fused {
  const unsigned* keep;   // keep_bit_table's words, or null
  const T *ks, *ms, *b, *d, *pkm1;
  double scale, omega;
  int epi;
};

// Sets the element kernel's dynamic shared memory and returns how many of
// its blocks fit on one SM.
template <typename T, int ND, class P, bool KEEP>
cudaError_t blocks_per_sm(int* per_sm) {
  constexpr size_t smem = smem_bytes<P, T>();
  cudaError_t err = cudaFuncSetAttribute(
      a00_element_kernel<T, ND, P, KEEP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, a00_element_kernel<T, ND, P, KEEP>, P::NT, smem);
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
  // blocks resident at once on this device, found once per device
  static int resident[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = blocks_per_sm<T, ND, P, KEEP>(&per_sm);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident[dev] = per_sm * sms;
  }
  const int ntiles = (nel + TM - 1) / TM;
  const int blocks = ntiles < resident[dev] ? ntiles : resident[dev];
  constexpr size_t smem = smem_bytes<P, T>();
  a00_element_kernel<T, ND, P, KEEP><<<blocks, P::NT, smem, stream>>>(
      x, f.keep, scale, Bs, ye, nel, mx, my, g);
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
          const void* ell, void* ye, void* y, const void* ks, const void* ms,
          const void* b, const void* d, const void* pkm1, double cs,
          double omega, int epi, int nd, int mx, int my, int mz,
          void* stream) {
  const Fused<T> f{static_cast<const unsigned*>(keep),
                   static_cast<const T*>(ks),
                   static_cast<const T*>(ms),   static_cast<const T*>(b),
                   static_cast<const T*>(d),    static_cast<const T*>(pkm1),
                   cs, omega, epi};
  return dispatch<T>(x, scale, Bs, ell, ye, y, nd, mx, my, mz, f, stream);
}

}  // namespace

// x (nu), scale_visc (nel x nrow), Bs (nrow x ncol), the node table ell
// (nu / nd x 2^nd int32, kernels/a00.py:node_gather_table), the scratch ye
// (nel x ncol) and y (nu) are contiguous device arrays on the stream's
// device, of one dtype but for ell; y is fully written (no zero fill).
// Returns 0 or the cudaError_t of the failed launch.
extern "C" int a00_apply_f32(const void* x, const void* scale, const void* Bs,
                             const void* ell, void* ye, void* y, int nd,
                             int mx, int my, int mz, void* stream) {
  return dispatch<float>(x, scale, Bs, ell, ye, y, nd, mx, my, mz,
                         Fused<float>{}, stream);
}

extern "C" int a00_apply_f64(const void* x, const void* scale, const void* Bs,
                             const void* ell, void* ye, void* y, int nd,
                             int mx, int my, int mz, void* stream) {
  return dispatch<double>(x, scale, Bs, ell, ye, y, nd, mx, my, mz,
                          Fused<double>{}, stream);
}

// The fused forms: keep (kernels/a00.py:keep_bit_table's nel x NW int32
// words of the operator's keep vector, or null) scales x in the element
// kernel's loads;
// epi (0 none, 1 mask, 2 cheb_first, 3 cheb_step) picks the node gather's
// store epilogue, which reads x itself as x_u (x0, p_k), the keep and mask
// vectors ks, ms (both non-null with an epilogue), b and d (the Chebyshev
// forms) and p_km1 (the step), each a contiguous nu-vector of x's dtype;
// scale and omega are rounded to the dtype here (as torch rounds a Python
// scalar). y aliases no input.
extern "C" int a00_fused_f32(const void* x, const void* keep,
                             const void* scale, const void* Bs,
                             const void* ell, void* ye, void* y,
                             const void* ks, const void* ms, const void* b,
                             const void* d, const void* pkm1, double cs,
                             double omega, int epi, int nd, int mx, int my,
                             int mz, void* stream) {
  return fused<float>(x, keep, scale, Bs, ell, ye, y, ks, ms, b, d, pkm1, cs,
                      omega, epi, nd, mx, my, mz, stream);
}

extern "C" int a00_fused_f64(const void* x, const void* keep,
                             const void* scale, const void* Bs,
                             const void* ell, void* ye, void* y,
                             const void* ks, const void* ms, const void* b,
                             const void* d, const void* pkm1, double cs,
                             double omega, int epi, int nd, int mx, int my,
                             int mz, void* stream) {
  return fused<double>(x, keep, scale, Bs, ell, ye, y, ks, ms, b, d, pkm1,
                       cs, omega, epi, nd, mx, my, mz, stream);
}

extern "C" const char* a00_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
