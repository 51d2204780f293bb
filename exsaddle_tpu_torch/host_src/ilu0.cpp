// ILU(0): incomplete LU with zero fill on the original CSR pattern,
// natural ordering -- PETSc PCILU's default configuration (0 levels of
// fill, no shifts), the default sub-preconditioner of bjacobi/fieldsplit
// splits in the reference's solver trees (testref/exSaddle3d_pseudoice_1
// .ref p-split section).
//
// Native replacement for the former pure-Python factorization loop: the
// row-by-row IKJ elimination is sequential pointer-chasing, exactly the
// kind of setup work that belongs in C++ next to the TPU compute path.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <cmath>
#include <vector>

extern "C" {

// In-place ILU(0) on the CSR arrays (indices must be sorted per row, the
// diagonal entry must exist). After return, Ax holds L (strict lower,
// unit diagonal implied) and U (upper incl. diagonal) interleaved on the
// original pattern. Returns the row of a zero pivot, or -1 on success.
long ilu0_factor(long n, const long* Ap, const long* Aj, double* Ax)
{
    std::vector<long> diag(n, -1);       // position of a_ii in row i
    std::vector<long> pos(n, 0);         // scratch: column -> position
    for (long i = 0; i < n; ++i)
        for (long t = Ap[i]; t < Ap[i + 1]; ++t)
            if (Aj[t] == i) { diag[i] = t; break; }

    std::vector<long> colpos(n, -1);
    for (long i = 0; i < n; ++i) {
        // register row i's pattern
        for (long t = Ap[i]; t < Ap[i + 1]; ++t) colpos[Aj[t]] = t;
        for (long kk = Ap[i]; kk < Ap[i + 1]; ++kk) {
            long k = Aj[kk];
            if (k >= i) break;
            long dk = diag[k];
            if (dk < 0 || Ax[dk] == 0.0) return k;   // zero pivot
            double aik = Ax[kk] / Ax[dk];
            Ax[kk] = aik;
            for (long t = dk + 1; t < Ap[k + 1]; ++t) {
                long j = Aj[t];
                long pj = colpos[j];
                if (pj >= 0) Ax[pj] -= aik * Ax[t];
            }
        }
        for (long t = Ap[i]; t < Ap[i + 1]; ++t) colpos[Aj[t]] = -1;
    }
    (void)pos;
    return -1;
}

// In-place solve (L U) x = b on the factored CSR arrays.
void ilu0_solve(long n, const long* Ap, const long* Aj, const double* Ax,
                double* x)
{
    // forward: L y = b (unit diagonal)
    for (long i = 0; i < n; ++i) {
        double s = x[i];
        for (long t = Ap[i]; t < Ap[i + 1]; ++t) {
            long j = Aj[t];
            if (j >= i) break;
            s -= Ax[t] * x[j];
        }
        x[i] = s;
    }
    // backward: U x = y
    for (long i = n - 1; i >= 0; --i) {
        double s = x[i];
        double d = 1.0;
        for (long t = Ap[i + 1] - 1; t >= Ap[i]; --t) {
            long j = Aj[t];
            if (j < i) break;
            if (j == i) { d = Ax[t]; break; }
            s -= Ax[t] * x[j];
        }
        x[i] = s / d;
    }
}

}  // extern "C"
