// The Krylov control kernels: the scalar tails of the GCR, FGMRES and
// iterative-refinement loop bodies, run on the card so that a whole solve
// is one graph launch with no host read (graphs.ControlGraph).
//
// They are the counterpart of the scalar code XLA compiled inside the JAX
// package's while loops:
//   fgmres_start_ctl   -- exsaddle_tpu/treeops.py:338-359 (cycle_start)
//   fgmres_arnoldi_ctl -- exsaddle_tpu/treeops.py:369-420 (arnoldi: the
//                         Givens recurrence, the state tests, and at a
//                         cycle's end the triangle of build_soln, :328-336)
//   gcr_ctl            -- exsaddle_tpu/treeops.py:256-285 (GCR's target
//                         and state)
//   ir_ctl             -- exsaddle_tpu/abf.py:1133-1161 (accept/reject,
//                         history, rounds, done, stalled)
// Each runs in one block; thread 0 does the arithmetic, the block only
// fills arrays. The work is at most a (k+1) x k Hessenberg column and a
// k x k triangle (k = 30: ~1,000 scalar operations), so one launch's
// latency bounds each kernel, not bytes or operations.
//
// Bitwise with their plain twins (kernels/krylov_ctl.py): every operation
// is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn and the __d* forms), so nvcc contracts nothing into an FMA,
// and the order of every sum is the twin's.
//
// Each kernel writes its loops' predicates into `pred` (the plain driver
// reads them) and, inside a graph (handles != nullptr), sets the same
// values into the conditional nodes' handles; it adds one to counts[slot]
// per execution of its loop body, so the host can count what ran inside
// one launch. State codes as treeops.py: 0 running, 2 rtol, 3 atol,
// 5 happy breakdown, -3 iteration limit, -4 dtol.

#include <cuda_runtime.h>

namespace {

constexpr int RUNNING = 0;
constexpr int CONVERGED_RTOL = 2;
constexpr int CONVERGED_ATOL = 3;
constexpr int CONVERGED_HAPPY = 5;
constexpr int DIVERGED_ITS = -3;
constexpr int DIVERGED_DTOL = -4;
constexpr int THREADS = 128;
constexpr int KMAX = 256;   // the wrapper refuses larger restarts

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double dvd(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float absv(float a) { return fabsf(a); }
__device__ __forceinline__ double absv(double a) { return fabs(a); }

__device__ __forceinline__ void set_pred(int* pred,
                                         const unsigned long long* handles,
                                         int slot, bool v) {
  pred[slot] = v ? 1 : 0;
  if (handles != nullptr) cudaGraphSetConditional(handles[slot], v ? 1u : 0u);
}

template <typename T>
__device__ void block_fill(T* a, int n, T v) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) a[i] = v;
}

__device__ __forceinline__ int clamp_index(int i, int n) {
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

// KSPConvergedDefault after a residual: rtol/atol, then dtol
template <typename T>
__device__ int conv_test(int state, T rnorm, T r0, const T* par) {
  const T rtol = par[0], atol = par[1], dtol = par[2];
  if (state == RUNNING) {
    T a = mul(rtol, r0);
    T lim = atol > a ? atol : a;
    if (rnorm <= lim) state = rnorm < atol ? CONVERGED_ATOL : CONVERGED_RTOL;
  }
  if (state == RUNNING && rnorm > mul(dtol, r0)) state = DIVERGED_DTOL;
  return state;
}

// FGMRES predicates, slots p0 .. p0+3: the while loop, cycle_start,
// arnoldi, build_soln
__device__ void fgmres_preds(int* pred, const unsigned long long* handles,
                             int p0, bool run, bool start, bool arnoldi,
                             bool build) {
  set_pred(pred, handles, p0, run);
  set_pred(pred, handles, p0 + 1, start);
  set_pred(pred, handles, p0 + 2, arnoldi);
  set_pred(pred, handles, p0 + 3, build);
}

// FGMRES state (working dtype T): H (k+1, k) row-major, g (k+1), cs, sn,
// y (k), hist (hist_len), sc = [r0, rnorm, 1/safe(beta)],
// par = [rtol, atol, dtol]; ints = [state, it, itc];
// ix = [max(it, 0), max(it, 0) + 1] (basis rows a step reads and writes).

// mode 0: a new solve (state, it = -1, itc, r0, rnorm, hist = -1);
// mode 1: a cycle start after beta = ||F - A x||.
template <typename T>
__global__ void fgmres_start_kernel(int mode, int k, int hist_len, T* H, T* g,
                                    T* cs, T* sn, T* hist, T* sc, const T* par,
                                    int* ints, long long* ix, const T* beta_p,
                                    int* pred,
                                    const unsigned long long* handles,
                                    long long* counts, int p0, int c0) {
  if (mode == 0) {
    block_fill(hist, hist_len, T(-1));
    if (threadIdx.x != 0) return;
    ints[0] = RUNNING;
    ints[1] = -1;
    ints[2] = 0;
    sc[0] = T(0);
    sc[1] = T(0);
    ix[0] = 0;
    ix[1] = 1;
    fgmres_preds(pred, handles, p0, true, true, false, false);
    counts[c0] += 1;
    return;
  }
  block_fill(H, (k + 1) * k, T(0));
  block_fill(g, k + 1, T(0));
  block_fill(cs, k, T(0));
  block_fill(sn, k, T(0));
  __syncthreads();
  if (threadIdx.x != 0) return;
  const T beta = *beta_p;
  const int itc = ints[2];
  sc[1] = beta;
  hist[clamp_index(itc, hist_len)] = beta;
  if (itc == 0) sc[0] = beta;
  const T safe = beta == T(0) ? T(1) : beta;
  sc[2] = dvd(T(1), safe);
  g[0] = beta;
  int state = ints[0];
  if (beta == T(0)) state = CONVERGED_ATOL;
  state = conv_test(state, beta, sc[0], par);
  ints[0] = state;
  ints[1] = 0;
  ix[0] = 0;
  ix[1] = 1;
  const bool run = state == RUNNING;
  fgmres_preds(pred, handles, p0, run, false, run, false);
  counts[c0 + 1] += 1;
}

// One Arnoldi step's tail: h = the masked Gram-Schmidt dots (k+1), tt =
// ||w|| after the projection.
template <typename T>
__global__ void fgmres_arnoldi_kernel(int k, int hist_len, int max_it, T* H,
                                      T* g, T* cs, T* sn, T* y, T* hist, T* sc,
                                      const T* par, int* ints, long long* ix,
                                      const T* h, const T* tt_p, int* pred,
                                      const unsigned long long* handles,
                                      long long* counts, int p0, int c0) {
  if (threadIdx.x != 0) return;
  T hcol[KMAX + 1];
  int it = ints[1], itc = ints[2];
  // a step runs at 0 <= it < k; a state outside (never reached by a
  // solve) is clamped, so no index leaves the arrays
  it = it < 0 ? 0 : (it > k - 1 ? k - 1 : it);
  const T tt = *tt_p;
  const T git = g[it];
  // happy breakdown (gmres.c hapbnd: min(|tt / g_it|, haptol))
  const T safe_g = git == T(0) ? T(1) : git;
  const T q = absv(dvd(tt, safe_g));
  const T cap = T(1e-30);
  const T hapbnd = cap < q ? cap : q;
  const bool happy = tt <= hapbnd;
  for (int j = 0; j <= k; ++j) hcol[j] = j <= it ? h[j] : T(0);
  hcol[it + 1] = tt;
  // the previous rotations on the new column
  for (int i = 0; i < it; ++i) {
    const T t1 = hcol[i], t2 = hcol[i + 1];
    hcol[i] = add(mul(cs[i], t1), mul(sn[i], t2));
    hcol[i + 1] = add(mul(-sn[i], t1), mul(cs[i], t2));
  }
  const T h_it = hcol[it], h_it1 = hcol[it + 1];
  const T delta = sqrt_rn(add(mul(h_it, h_it), mul(h_it1, h_it1)));
  const T safe_d = delta == T(0) ? T(1) : delta;
  const T c = dvd(h_it, safe_d), s = dvd(h_it1, safe_d);
  cs[it] = c;
  sn[it] = s;
  hcol[it] = delta;
  hcol[it + 1] = T(0);
  for (int j = 0; j <= k; ++j) H[j * k + it] = hcol[j];
  const T g_new = mul(-s, git);
  g[it] = mul(c, git);
  g[it + 1] = g_new;
  const T rnorm = absv(g_new);
  sc[1] = rnorm;
  it += 1;
  itc += 1;
  hist[clamp_index(itc, hist_len)] = rnorm;
  int state = ints[0];
  if (delta == T(0)) state = DIVERGED_ITS;
  state = conv_test(state, rnorm, sc[0], par);
  if (state == RUNNING && happy) state = CONVERGED_HAPPY;
  if (state == RUNNING && itc >= max_it) state = DIVERGED_ITS;
  const bool end = state != RUNNING || it >= k;
  if (end) {
    // y from the rotated triangle H[:it, :it], padded to k x k with a unit
    // diagonal and a zero right-hand side (exact zeros in y); columns
    // right to left, each row's sum in that order
    const int n = it;
    for (int i = 0; i < k; ++i) y[i] = i < n ? g[i] : T(0);
    for (int j = k - 1; j >= 0; --j) {
      const T d = j < n ? H[j * k + j] : T(1);
      const T yj = dvd(y[j], d);
      y[j] = yj;
      for (int i = 0; i < j; ++i) y[i] = sub(y[i], mul(H[i * k + j], yj));
    }
    it = -1;
  }
  ints[0] = state;
  ints[1] = it;
  ints[2] = itc;
  const int row = it < 0 ? 0 : it;
  ix[0] = row;
  ix[1] = row + 1;
  const bool run = state == RUNNING;
  fgmres_preds(pred, handles, p0, run, run && it < 0, run && it >= 0, end);
  counts[c0 + 2] += 1;
  if (end) counts[c0 + 3] += 1;
}

// GCR state: sc = [rnorm0, target, rnorm], par = [rtol, atol];
// ints = [state, nv, its]; ix = [nv]. mode 0 after rnorm0 = ||b||, mode 1
// after a step (alpha = ||v|| before scaling, rn = ||r||).
template <typename T>
__global__ void gcr_kernel(int mode, int restart, int max_it, T* sc,
                           const T* par, int* ints, long long* ix,
                           const T* alpha_p, const T* rn_p, int* pred,
                           const unsigned long long* handles, long long* counts,
                           int p, int c0) {
  if (threadIdx.x != 0) return;
  const T rtol = par[0], atol = par[1];
  int state;
  if (mode == 0) {
    const T rn0 = *rn_p;
    const T a = mul(rtol, rn0);
    sc[0] = rn0;
    sc[1] = atol > a ? atol : a;
    sc[2] = rn0;
    state = rn0 <= atol ? CONVERGED_ATOL : RUNNING;
    ints[1] = 0;
    ints[2] = 0;
    ix[0] = 0;
  } else {
    const T alpha = *alpha_p, rn = *rn_p;
    sc[2] = rn;
    const int its = ints[2] + 1;
    const int nv = ints[1] + 1 >= restart ? 0 : ints[1] + 1;
    state = ints[0];
    if (rn <= sc[1]) state = CONVERGED_RTOL;
    if (state == RUNNING && its >= max_it) state = DIVERGED_ITS;
    if (alpha == T(0)) state = DIVERGED_ITS;
    ints[1] = nv;
    ints[2] = its;
    ix[0] = nv;
  }
  ints[0] = state;
  set_pred(pred, handles, p, state == RUNNING);
  counts[c0 + mode] += 1;
}

// Refinement state (float64): sc = [rnorm0, rnorm, rtol, n_rounds],
// ints = [rounds, inner_total, done, stalled, accept], hist (n_hist).
// mode 0 after rnorm0 = ||F||; mode 1 after a round (rn = the float64
// residual of x + dx; fg_ints = the inner FGMRES's [state, it, itc]).
__global__ void ir_kernel(int mode, int n_hist, double* sc, int* ints,
                          double* hist, const double* rn_p, const int* fg_ints,
                          int* pred, const unsigned long long* handles,
                          long long* counts, int p, int c0) {
  if (threadIdx.x != 0) return;
  const int n_rounds = static_cast<int>(sc[3]);
  if (mode == 0) {
    const double rn0 = *rn_p;
    sc[0] = rn0;
    sc[1] = rn0;
    for (int i = 0; i < n_hist; ++i) hist[i] = -1.0;
    hist[0] = rn0;
    for (int i = 0; i < 5; ++i) ints[i] = 0;
    set_pred(pred, handles, p, 0 < n_rounds);
    counts[c0] += 1;
    return;
  }
  const double rn_try = *rn_p;
  const int rounds = ints[0] + 1;
  ints[0] = rounds;
  ints[1] += fg_ints[2];
  const bool accept = fg_ints[0] >= 0 && rn_try < sc[1];
  if (accept) {
    sc[1] = rn_try;
    hist[clamp_index(rounds, n_hist)] = rn_try;
  }
  const bool stalled = !accept;
  const bool done = stalled || (accept && sc[1] <= __dmul_rn(sc[2], sc[0]));
  ints[2] = done;
  ints[3] = stalled;
  ints[4] = accept;
  set_pred(pred, handles, p, !done && rounds < n_rounds);
  counts[c0 + 1] += 1;
}

using ull = unsigned long long;

template <typename T>
int start_launch(int mode, int k, int hist_len, void* H, void* g, void* cs,
                 void* sn, void* hist, void* sc, const void* par, void* ints,
                 void* ix, const void* beta, void* pred, const void* handles,
                 void* counts, int p0, int c0, void* stream) {
  fgmres_start_kernel<T><<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      mode, k, hist_len, static_cast<T*>(H), static_cast<T*>(g),
      static_cast<T*>(cs), static_cast<T*>(sn), static_cast<T*>(hist),
      static_cast<T*>(sc), static_cast<const T*>(par), static_cast<int*>(ints),
      static_cast<long long*>(ix), static_cast<const T*>(beta),
      static_cast<int*>(pred), static_cast<const ull*>(handles),
      static_cast<long long*>(counts), p0, c0);
  return cudaGetLastError();
}

template <typename T>
int arnoldi_launch(int k, int hist_len, int max_it, void* H, void* g, void* cs,
                   void* sn, void* y, void* hist, void* sc, const void* par,
                   void* ints, void* ix, const void* h, const void* tt,
                   void* pred, const void* handles, void* counts, int p0,
                   int c0, void* stream) {
  if (k > KMAX) return cudaErrorInvalidValue;
  fgmres_arnoldi_kernel<T><<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      k, hist_len, max_it, static_cast<T*>(H), static_cast<T*>(g),
      static_cast<T*>(cs), static_cast<T*>(sn), static_cast<T*>(y),
      static_cast<T*>(hist), static_cast<T*>(sc), static_cast<const T*>(par),
      static_cast<int*>(ints), static_cast<long long*>(ix),
      static_cast<const T*>(h), static_cast<const T*>(tt),
      static_cast<int*>(pred), static_cast<const ull*>(handles),
      static_cast<long long*>(counts), p0, c0);
  return cudaGetLastError();
}

template <typename T>
int gcr_launch(int mode, int restart, int max_it, void* sc, const void* par,
               void* ints, void* ix, const void* alpha, const void* rn,
               void* pred, const void* handles, void* counts, int p, int c0,
               void* stream) {
  gcr_kernel<T><<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      mode, restart, max_it, static_cast<T*>(sc), static_cast<const T*>(par),
      static_cast<int*>(ints), static_cast<long long*>(ix),
      static_cast<const T*>(alpha), static_cast<const T*>(rn),
      static_cast<int*>(pred), static_cast<const ull*>(handles),
      static_cast<long long*>(counts), p, c0);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

#define KC_START(NAME, T)                                                     \
  int NAME(int mode, int k, int hist_len, void* H, void* g, void* cs,        \
           void* sn, void* hist, void* sc, const void* par, void* ints,      \
           void* ix, const void* beta, void* pred, const void* handles,      \
           void* counts, int p0, int c0, void* stream) {                     \
    return start_launch<T>(mode, k, hist_len, H, g, cs, sn, hist, sc, par,   \
                           ints, ix, beta, pred, handles, counts, p0, c0,    \
                           stream);                                          \
  }
KC_START(kc_fgmres_start_f32, float)
KC_START(kc_fgmres_start_f64, double)

#define KC_ARNOLDI(NAME, T)                                                   \
  int NAME(int k, int hist_len, int max_it, void* H, void* g, void* cs,      \
           void* sn, void* y, void* hist, void* sc, const void* par,         \
           void* ints, void* ix, const void* h, const void* tt, void* pred,  \
           const void* handles, void* counts, int p0, int c0, void* stream) { \
    return arnoldi_launch<T>(k, hist_len, max_it, H, g, cs, sn, y, hist, sc, \
                             par, ints, ix, h, tt, pred, handles, counts,    \
                             p0, c0, stream);                                \
  }
KC_ARNOLDI(kc_fgmres_arnoldi_f32, float)
KC_ARNOLDI(kc_fgmres_arnoldi_f64, double)

#define KC_GCR(NAME, T)                                                       \
  int NAME(int mode, int restart, int max_it, void* sc, const void* par,     \
           void* ints, void* ix, const void* alpha, const void* rn,          \
           void* pred, const void* handles, void* counts, int p, int c0,     \
           void* stream) {                                                   \
    return gcr_launch<T>(mode, restart, max_it, sc, par, ints, ix, alpha,    \
                         rn, pred, handles, counts, p, c0, stream);          \
  }
KC_GCR(kc_gcr_f32, float)
KC_GCR(kc_gcr_f64, double)

int kc_ir_f64(int mode, int n_hist, void* sc, void* ints, void* hist,
              const void* rn, const void* fg_ints, void* pred,
              const void* handles, void* counts, int p, int c0, void* stream) {
  ir_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      mode, n_hist, static_cast<double*>(sc), static_cast<int*>(ints),
      static_cast<double*>(hist), static_cast<const double*>(rn),
      static_cast<const int*>(fg_ints), static_cast<int*>(pred),
      static_cast<const ull*>(handles), static_cast<long long*>(counts), p,
      c0);
  return cudaGetLastError();
}

}  // extern "C"
