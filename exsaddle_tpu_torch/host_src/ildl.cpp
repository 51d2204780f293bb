// Incomplete LDL^T factorization with inverse-based dropping, plus a
// multilevel mode with condest-driven pivot rejection and Schur-complement
// recursion.
//
// Native (host-side, sequential) replacement for the reference's ILDL /
// ILUPACK preconditioner stack, which wraps ILUPACK's Fortran-77 DSYMiluc
// and AMGfactor (pcildl.c:46-286, pcilupack.c:29-176). Sparse
// pointer-chasing factorization is exactly the kind of work that belongs
// in native code next to the TPU compute path: it is sequential, branchy
// and latency-bound.
//
// Algorithm: column-oriented Crout LDL^T over the (symmetrically permuted)
// upper-triangular CSR input.
//
// Inverse-based dropping (the technique behind ILUPACK's robustness,
// Bollhoefer's growth-monitored ILU): alongside the factorization we run
// the classic incremental condition estimator for the unit-lower factor L
// -- solve L y = b with b_k chosen in {+1,-1} to maximize |y_k| -- so
// kappa_k = |y_k| estimates the growth of e_k^T L^{-1}. The drop rule
// |l_rk d_k| * min(kappa_k, condest) <= droptol * ||A(:,k)||_inf keeps
// more of exactly those columns whose inverse rows are large, which is
// where plain threshold-ILU preconditioners lose their effectiveness.
//
// Multilevel mode (ilupack AMGfactor semantics) is driven from Python in
// two passes per level:
//   1. TRIAL pass (nsplit < 0): pivots are REJECTED when the inverse
//      growth estimate exceeds the condest bound or the pivot is
//      negligible relative to 1/condest; rejected unknowns are not
//      eliminated. Only the rejection flags are consumed.
//   2. SPLIT pass (nsplit >= 0) on the matrix re-permuted with the
//      rejected unknowns LAST: columns k < nsplit are eliminated
//      (safeguarded, no rejection -- the pivot sequence is identical to
//      the trial's accepted pivots), and the approximate Schur complement
//      S = A_CC - L_CF D_F L_CF^T is formed on the tail (drop tolerance
//      droptolS) for the caller to recurse on.
// The rejected-last permutation is what makes the two-level identity
//      P A P^T ~ [L_FF 0; L_CF I] [D_F 0; 0 S] [L_FF 0; L_CF I]^T
// exact (up to dropping): with interleaved rejections the coupling of a
// rejected unknown to LATER accepted columns has no home in the factor.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

struct Factor {
    long n = 0;
    std::vector<std::vector<long>>   Lrows;  // per accepted column: rows
    std::vector<std::vector<double>> Lvals;
    std::vector<double> D;
    std::vector<char>   rejected;
    long nreject = 0;
};

// Core Crout pass. condest <= 0 disables the estimator (plain threshold
// dropping); drop_cap (> 0) caps the inverse-based drop weight separately
// from the rejection bound. nsplit >= 0: split mode (eliminate k < nsplit,
// reject the rest unconditionally); nsplit < 0 with allow_reject: trial
// mode (condest-driven rejection); otherwise single-level (safeguarded
// pivots).
void crout_ldl(long n, const long* Ap, const long* Aj, const double* Ax,
               double droptol, double condest, double drop_cap,
               int allow_reject, long nsplit, Factor& F)
{
    F.n = n;
    F.Lrows.assign(n, {});
    F.Lvals.assign(n, {});
    F.D.assign(n, 0.0);
    F.rejected.assign(n, 0);
    F.nreject = 0;

    // Crout linked lists: for each accepted column j, pos[j] points at the
    // next unconsumed entry; llist[k] chains the columns whose next entry
    // has row k.
    std::vector<long> llist(n, -1), lnext(n, -1), pos(n, 0);

    std::vector<double> w(n, 0.0);        // dense accumulator for column k
    std::vector<char>   mark(n, 0);
    std::vector<long>   pattern;
    pattern.reserve(256);

    // inverse-growth estimator state: s[r] = sum_j L_rj y_j over accepted j
    std::vector<double> s(n, 0.0);

    // column norms of A (inf-norm over the symmetric column)
    std::vector<double> anorm(n, 0.0);
    for (long i = 0; i < n; ++i) {
        for (long t = Ap[i]; t < Ap[i + 1]; ++t) {
            double a = std::fabs(Ax[t]);
            long j = Aj[t];
            if (a > anorm[i]) anorm[i] = a;
            if (a > anorm[j]) anorm[j] = a;
        }
    }

    for (long k = 0; k < n; ++k) {
        if (nsplit >= 0 && k >= nsplit) {      // split mode: forced tail
            F.rejected[k] = 1;
            ++F.nreject;
            continue;
        }
        // scatter column k of the lower triangle = row k of the upper CSR
        pattern.clear();
        for (long t = Ap[k]; t < Ap[k + 1]; ++t) {
            long r = Aj[t];             // r >= k
            w[r] = Ax[t];
            if (!mark[r]) { mark[r] = 1; pattern.push_back(r); }
        }

        // updates from previous accepted columns j with L[k,j] != 0
        long j = llist[k];
        while (j != -1) {
            long jn = lnext[j];                  // save: we re-link j below
            long pj = pos[j];
            double lkj = F.Lvals[j][pj];
            double f = F.D[j] * lkj;
            // w[r] -= f * L[r,j] for r >= k (includes r == k via l_kj)
            w[k] -= f * lkj;
            if (!mark[k]) { mark[k] = 1; pattern.push_back(k); }
            const std::vector<long>&   rj = F.Lrows[j];
            const std::vector<double>& vj = F.Lvals[j];
            for (size_t t = pj + 1; t < rj.size(); ++t) {
                long r = rj[t];
                w[r] -= f * vj[t];
                if (!mark[r]) { mark[r] = 1; pattern.push_back(r); }
            }
            // advance column j to its next row
            if ((size_t)(pj + 1) < rj.size()) {
                long rnext = rj[pj + 1];
                pos[j] = pj + 1;
                lnext[j] = llist[rnext];
                llist[rnext] = j;
            }
            j = jn;
        }

        double an = anorm[k] > 0 ? anorm[k] : 1.0;
        double dk = w[k];

        // inverse-growth estimate for this unknown: y_k = b_k - s_k with
        // b_k = +-1 maximizing |y_k|
        double yk = (s[k] >= 0.0 ? -1.0 : 1.0) - s[k];
        double kap = std::fabs(yk);
        if (kap < 1.0) kap = 1.0;

        if (allow_reject && nsplit < 0) {
            // reject when the factor's inverse would grow past the condest
            // bound -- either through the estimated growth of L^{-1} or
            // directly through 1/|d_k| (D^{-1}'s contribution)
            if ((condest > 0 && (kap > condest
                                 || std::fabs(dk) * condest < an))
                    || std::fabs(dk) < 1e-12 * an) {
                F.rejected[k] = 1;
                ++F.nreject;
                for (long r : pattern) { mark[r] = 0; w[r] = 0.0; }
                continue;
            }
        } else {
            double tiny = 1e-12 * an;
            if (std::fabs(dk) < tiny)
                dk = (dk >= 0.0 ? tiny : -tiny);
        }
        F.D[k] = dk;

        // scale, drop, store column k of L (sorted rows). Inverse-based
        // rule: entries are kept down to droptol / kappa -- extra accuracy
        // exactly in the columns whose inverse rows are large.
        double cap = drop_cap > 0 ? drop_cap : condest;
        double keff = (condest > 0) ? std::min(kap, cap) : 1.0;
        double tol = droptol * an / keff;
        std::vector<long>&   rk = F.Lrows[k];
        std::vector<double>& vk = F.Lvals[k];
        for (long r : pattern) {
            mark[r] = 0;
            if (r <= k) continue;
            double val = w[r];
            w[r] = 0.0;
            if (std::fabs(val) <= tol) continue;     // drop
            rk.push_back(r);
            vk.push_back(val / dk);
        }
        w[k] = 0.0;
        // sort by row index (insertion into paired arrays)
        for (size_t a = 1; a < rk.size(); ++a) {
            long ri = rk[a]; double vi = vk[a];
            size_t b = a;
            while (b > 0 && rk[b - 1] > ri) {
                rk[b] = rk[b - 1]; vk[b] = vk[b - 1]; --b;
            }
            rk[b] = ri; vk[b] = vi;
        }
        // estimator update with the kept column
        if (condest > 0) {
            for (size_t t = 0; t < rk.size(); ++t)
                s[rk[t]] += vk[t] * yk;
        }
        if (!rk.empty()) {
            pos[k] = 0;
            long rfirst = rk[0];
            lnext[k] = llist[rfirst];
            llist[rfirst] = k;
        }
    }
}

// Pack the factor's accepted columns into CSC arrays (original indices).
int pack_factor(const Factor& F, long** Lp_out, long** Li_out,
                double** Lx_out, double** D_out, long* nnz_out)
{
    long n = F.n;
    long nnz = 0;
    for (long c = 0; c < n; ++c) nnz += (long)F.Lrows[c].size();
    long* Lp = (long*)std::malloc((n + 1) * sizeof(long));
    long* Li = (long*)std::malloc((nnz > 0 ? nnz : 1) * sizeof(long));
    double* Lx = (double*)std::malloc((nnz > 0 ? nnz : 1) * sizeof(double));
    double* Dv = (double*)std::malloc(n * sizeof(double));
    if (!Lp || !Li || !Lx || !Dv) return -1;
    long t = 0;
    Lp[0] = 0;
    for (long c = 0; c < n; ++c) {
        std::memcpy(Li + t, F.Lrows[c].data(),
                    F.Lrows[c].size() * sizeof(long));
        std::memcpy(Lx + t, F.Lvals[c].data(),
                    F.Lvals[c].size() * sizeof(double));
        t += (long)F.Lrows[c].size();
        Lp[c + 1] = t;
    }
    std::memcpy(Dv, F.D.data(), n * sizeof(double));
    *Lp_out = Lp; *Li_out = Li; *Lx_out = Lx; *D_out = Dv;
    *nnz_out = nnz + (n - F.nreject);  // diagonal counted like the reference
    return 0;
}

}  // namespace

extern "C" {

// Single-level factorization of the upper-triangular CSR matrix (diagonal
// entries must exist). condest <= 0: plain threshold dropping; > 0:
// inverse-based dropping bounded by condest. Outputs CSC arrays for the
// strictly-lower unit factor L and diagonal D. Returns 0 on success.
// Caller frees with ildl_free.
int ildl_factor2(long n, const long* Ap, const long* Aj, const double* Ax,
                 double droptol, double condest, double drop_cap,
                 long** Lp_out, long** Li_out, double** Lx_out,
                 double** D_out, long* nnz_out)
{
    Factor F;
    crout_ldl(n, Ap, Aj, Ax, droptol, condest, drop_cap, 0, -1, F);
    return pack_factor(F, Lp_out, Li_out, Lx_out, D_out, nnz_out);
}

// Back-compatible plain entry.
int ildl_factor(long n, const long* Ap, const long* Aj, const double* Ax,
                double droptol,
                long** Lp_out, long** Li_out, double** Lx_out,
                double** D_out, long* nnz_out)
{
    return ildl_factor2(n, Ap, Aj, Ax, droptol, -1.0, -1.0,
                        Lp_out, Li_out, Lx_out, D_out, nnz_out);
}

// TRIAL pass: run the factorization with condest-driven pivot rejection
// and report only the rejection flags (caller then permutes rejected-last
// and calls ildl_factor_split). rejected_out: n bytes, caller frees.
int ildl_factor_trial(long n, const long* Ap, const long* Aj,
                      const double* Ax, double droptol, double condest,
                      double drop_cap,
                      char** rejected_out, long* nreject_out)
{
    Factor F;
    crout_ldl(n, Ap, Aj, Ax, droptol, condest, drop_cap, 1, -1, F);
    char* rej = (char*)std::malloc(n > 0 ? n : 1);
    if (!rej) return -1;
    std::memcpy(rej, F.rejected.data(), n);
    *rejected_out = rej;
    *nreject_out = F.nreject;
    return 0;
}

// SPLIT pass on the rejected-last permuted matrix: eliminate columns
// k < nsplit (safeguarded pivots, no rejection), then form the
// approximate Schur complement on the tail C = [nsplit, n) as
// upper-triangular CSR (drop tolerance droptolS, diagonal always stored).
int ildl_factor_split(long n, const long* Ap, const long* Aj,
                      const double* Ax, double droptol, double condest,
                      double drop_cap, double droptolS, long nsplit,
                      long** Lp_out, long** Li_out, double** Lx_out,
                      double** D_out, long* nnz_out,
                      long** Sp_out, long** Sj_out, double** Sx_out)
{
    Factor F;
    crout_ldl(n, Ap, Aj, Ax, droptol, condest, drop_cap, 0, nsplit, F);
    if (pack_factor(F, Lp_out, Li_out, Lx_out, D_out, nnz_out) != 0)
        return -1;

    long nc = n - nsplit;

    // Schur triplets (upper triangle, tail-local indices): A_CC entries,
    // then -d_j l_r1j l_r2j over the tail rows of every eliminated column.
    struct Trip { long r, c; double v; };
    std::vector<Trip> trips;
    for (long i = nsplit; i < n; ++i)
        for (long t = Ap[i]; t < Ap[i + 1]; ++t)
            trips.push_back({i - nsplit, Aj[t] - nsplit, Ax[t]});
    std::vector<long> crow;           // tail rows of one eliminated column
    std::vector<double> cval;
    for (long j = 0; j < nsplit; ++j) {
        crow.clear(); cval.clear();
        const std::vector<long>&   rj = F.Lrows[j];
        const std::vector<double>& vj = F.Lvals[j];
        for (size_t t = 0; t < rj.size(); ++t)
            if (rj[t] >= nsplit) {
                crow.push_back(rj[t] - nsplit);
                cval.push_back(vj[t]);
            }
        double dj = F.D[j];
        for (size_t a = 0; a < crow.size(); ++a)
            for (size_t b = a; b < crow.size(); ++b)
                trips.push_back({crow[a], crow[b], -dj * cval[a] * cval[b]});
    }
    // merge triplets into upper CSR with droptolS thresholding
    std::sort(trips.begin(), trips.end(),
              [](const Trip& x, const Trip& y) {
                  return x.r != y.r ? x.r < y.r : x.c < y.c;
              });
    std::vector<long> mr, mc;
    std::vector<double> mv;
    {
        size_t i = 0;
        while (i < trips.size()) {
            size_t e = i + 1;
            double v = trips[i].v;
            while (e < trips.size() && trips[e].r == trips[i].r
                   && trips[e].c == trips[i].c) {
                v += trips[e].v; ++e;
            }
            mr.push_back(trips[i].r);
            mc.push_back(trips[i].c);
            mv.push_back(v);
            i = e;
        }
    }
    std::vector<double> snorm(nc, 0.0);
    for (size_t i = 0; i < mv.size(); ++i) {
        double a = std::fabs(mv[i]);
        if (a > snorm[mr[i]]) snorm[mr[i]] = a;
        if (a > snorm[mc[i]]) snorm[mc[i]] = a;
    }
    std::vector<long> Spv(nc + 1, 0);
    std::vector<long> Sjv;
    std::vector<double> Sxv;
    for (size_t i = 0; i < mv.size(); ++i) {
        long r = mr[i], c = mc[i];
        double nrm = std::max(snorm[r], 1e-300);
        if (r != c && std::fabs(mv[i]) <= droptolS * nrm) continue;
        Spv[r + 1]++;
        Sjv.push_back(c);
        Sxv.push_back(mv[i]);
    }
    for (long r = 0; r < nc; ++r) Spv[r + 1] += Spv[r];

    long* Sp = (long*)std::malloc((nc + 1) * sizeof(long));
    long* Sj = (long*)std::malloc((Sjv.size() ? Sjv.size() : 1)
                                  * sizeof(long));
    double* Sx = (double*)std::malloc((Sxv.size() ? Sxv.size() : 1)
                                      * sizeof(double));
    if (!Sp || !Sj || !Sx) return -1;
    std::memcpy(Sp, Spv.data(), (nc + 1) * sizeof(long));
    if (!Sjv.empty()) {
        std::memcpy(Sj, Sjv.data(), Sjv.size() * sizeof(long));
        std::memcpy(Sx, Sxv.data(), Sxv.size() * sizeof(double));
    }
    *Sp_out = Sp; *Sj_out = Sj; *Sx_out = Sx;
    return 0;
}

// In-place solve (L D L^T) x = b with unit-lower CSC L (single level).
void ildl_solve(long n, const long* Lp, const long* Li, const double* Lx,
                const double* D, double* x)
{
    for (long c = 0; c < n; ++c) {          // forward: L y = b
        double xc = x[c];
        for (long t = Lp[c]; t < Lp[c + 1]; ++t)
            x[Li[t]] -= Lx[t] * xc;
    }
    for (long c = 0; c < n; ++c) x[c] /= D[c];
    for (long c = n - 1; c >= 0; --c) {     // backward: L^T z = y
        double s = x[c];
        for (long t = Lp[c]; t < Lp[c + 1]; ++t)
            s -= Lx[t] * x[Li[t]];
        x[c] = s;
    }
}

// Multilevel forward pass over one level's split factor: forward-eliminate
// through the first nsplit columns and divide them by D; the tail entries
// of x end up holding the Schur right-hand side.
void ildl_split_fwd(long n, long nsplit, const long* Lp, const long* Li,
                    const double* Lx, const double* D, double* x)
{
    for (long c = 0; c < nsplit; ++c) {
        double xc = x[c];
        for (long t = Lp[c]; t < Lp[c + 1]; ++t)
            x[Li[t]] -= Lx[t] * xc;
    }
    for (long c = 0; c < nsplit; ++c) x[c] /= D[c];
}

// Multilevel backward pass: x_F <- L_FF^{-T} (x_F - L_CF^T x_C), with the
// tail of x already holding the recursed Schur solution.
void ildl_split_bwd(long n, long nsplit, const long* Lp, const long* Li,
                    const double* Lx, double* x)
{
    for (long c = nsplit - 1; c >= 0; --c) {
        double s = x[c];
        for (long t = Lp[c]; t < Lp[c + 1]; ++t)
            s -= Lx[t] * x[Li[t]];
        x[c] = s;
    }
}

void ildl_free(void* p) { std::free(p); }

}  // extern "C"
