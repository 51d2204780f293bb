"""Native (C++) host factorizations and orderings, bound via ctypes (the port
of exsaddle_tpu/native/__init__.py).

The sources are the port's own copies of the JAX package's C++ files,
exsaddle_tpu_torch/host_src/{ilu0,ildl,order}.cpp, byte for byte the same
(tests/test_torch_native.py holds them so). Each is compiled with g++ on
first use into exsaddle_tpu_torch/_build/ (listed in .gitignore) under a
name that carries the hash of the source and flags, so an edited source is
rebuilt and an unchanged one is reused. A failed build raises. Nothing is
built at import time.

These are sequential sparse factorizations (ILU(0), incomplete LDL^T,
AMD / nested-dissection orderings, MC64 scalings) that belong next to, not
on, the device: the preconditioners that use them (precond.PCILU, PCILDL,
PCILUPACK) move each vector to the host and back explicitly.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG, "host_src")
BUILD_DIR = os.path.join(_PKG, "_build")
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_LIBS = {}

_c_long_p = ctypes.POINTER(ctypes.c_long)
_c_dbl_p = ctypes.POINTER(ctypes.c_double)
_c_char_p = ctypes.POINTER(ctypes.c_char)
_L = ctypes.c_long
_D = ctypes.c_double

# argtypes/restype of every C entry point used here
_SIGNATURES = {
    "ilu0": {
        "ilu0_factor": (ctypes.c_long, [_L, _c_long_p, _c_long_p, _c_dbl_p]),
        "ilu0_solve": (None, [_L, _c_long_p, _c_long_p, _c_dbl_p, _c_dbl_p]),
    },
    "ildl": {
        "ildl_factor2": (ctypes.c_int, [
            _L, _c_long_p, _c_long_p, _c_dbl_p, _D, _D, _D,
            ctypes.POINTER(_c_long_p), ctypes.POINTER(_c_long_p),
            ctypes.POINTER(_c_dbl_p), ctypes.POINTER(_c_dbl_p),
            ctypes.POINTER(_L)]),
        "ildl_factor_trial": (ctypes.c_int, [
            _L, _c_long_p, _c_long_p, _c_dbl_p, _D, _D, _D,
            ctypes.POINTER(_c_char_p), ctypes.POINTER(_L)]),
        "ildl_factor_split": (ctypes.c_int, [
            _L, _c_long_p, _c_long_p, _c_dbl_p, _D, _D, _D, _D, _L,
            ctypes.POINTER(_c_long_p), ctypes.POINTER(_c_long_p),
            ctypes.POINTER(_c_dbl_p), ctypes.POINTER(_c_dbl_p),
            ctypes.POINTER(_L),
            ctypes.POINTER(_c_long_p), ctypes.POINTER(_c_long_p),
            ctypes.POINTER(_c_dbl_p)]),
        "ildl_solve": (None, [_L, _c_long_p, _c_long_p, _c_dbl_p, _c_dbl_p,
                              _c_dbl_p]),
        "ildl_split_fwd": (None, [_L, _L, _c_long_p, _c_long_p, _c_dbl_p,
                                  _c_dbl_p, _c_dbl_p]),
        "ildl_split_bwd": (None, [_L, _L, _c_long_p, _c_long_p, _c_dbl_p,
                                  _c_dbl_p]),
        "ildl_free": (None, [ctypes.c_void_p]),
    },
    "order": {
        "amd_order": (ctypes.c_int, [_L, _c_long_p, _c_long_p, _c_long_p]),
        "nd_order": (ctypes.c_int, [_L, _c_long_p, _c_long_p, _c_long_p,
                                    _L]),
        "mc64_scale": (ctypes.c_int, [_L, _c_long_p, _c_long_p, _c_dbl_p,
                                      _c_dbl_p, _c_dbl_p, _c_long_p]),
    },
}


def library_path(name):
    """Path of the library the current source and flags of `name` build
    to."""
    src = os.path.join(SRC_DIR, f"{name}.cpp")
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(src, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(name):
    """Compile lib<name> if the library for the current source is missing.
    Returns (path, built_now)."""
    out = library_path(name)
    if os.path.exists(out):
        return out, False
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = (["g++"] + GXX_FLAGS
           + ["-o", tmp, os.path.join(SRC_DIR, f"{name}.cpp")])
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                           f"{name}:\n{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    return out, True


def build_all():
    """Build every native library; returns the names built now."""
    return [name for name in _SIGNATURES if build(name)[1]]


def _load(name):
    with _lock:
        if name not in _LIBS:
            lib = ctypes.CDLL(build(name)[0])
            for fn, (restype, argtypes) in _SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.restype = restype
                f.argtypes = argtypes
            _LIBS[name] = lib
        return _LIBS[name]


def _lp(a):
    return a.ctypes.data_as(_c_long_p)


def _dp(a):
    return a.ctypes.data_as(_c_dbl_p)


def _as_upper_csr_arrays(A_upper_csr):
    A = A_upper_csr.tocsr().sorted_indices()
    Ap = np.ascontiguousarray(A.indptr, dtype=np.int64)
    Aj = np.ascontiguousarray(A.indices, dtype=np.int64)
    Ax = np.ascontiguousarray(A.data, dtype=np.float64)
    return A.shape[0], Ap, Aj, Ax


def _vec(b, n):
    """Contiguous float64 copy of a length-n right-hand side."""
    x = np.array(b, dtype=np.float64, copy=True)
    if x.shape != (n,):
        raise ValueError(f"right-hand side of shape {x.shape}, expected "
                         f"({n},)")
    return x


class ILDLFactor:
    """Incomplete LDL^T of a symmetric matrix given by its upper-triangular
    scipy CSR (diagonal entries present), with drop tolerance. condest > 0
    enables inverse-based dropping (entries kept down to droptol/kappa where
    kappa estimates the growth of L^{-1}, capped at condest)."""

    def __init__(self, A_upper_csr, droptol, condest=-1.0, drop_cap=-1.0):
        lib = _load("ildl")
        n, Ap, Aj, Ax = _as_upper_csr_arrays(A_upper_csr)
        Lp = _c_long_p()
        Li = _c_long_p()
        Lx = _c_dbl_p()
        D = _c_dbl_p()
        nnz = ctypes.c_long()
        rc = lib.ildl_factor2(n, _lp(Ap), _lp(Aj), _dp(Ax), droptol,
                              condest, drop_cap, ctypes.byref(Lp),
                              ctypes.byref(Li), ctypes.byref(Lx),
                              ctypes.byref(D), ctypes.byref(nnz))
        if rc != 0:
            raise RuntimeError("ildl_factor failed")
        self._lib = lib
        self.n = n
        self.nnz = int(nnz.value)          # incl. diagonal
        # copy into numpy and free the C buffers
        ln = np.ctypeslib.as_array(Lp, shape=(n + 1,)).copy()
        lnnz = int(ln[-1])
        self.Lp = ln
        self.Li = np.ctypeslib.as_array(Li, shape=(max(lnnz, 1),)).copy()
        self.Lx = np.ctypeslib.as_array(Lx, shape=(max(lnnz, 1),)).copy()
        self.D = np.ctypeslib.as_array(D, shape=(n,)).copy()
        for p in (Lp, Li, Lx, D):
            lib.ildl_free(p)

    def solve(self, b):
        x = _vec(b, self.n)
        self._lib.ildl_solve(self.n, _lp(self.Lp), _lp(self.Li),
                             _dp(self.Lx), _dp(self.D), _dp(x))
        return x


class _MLLevel:
    __slots__ = ("n", "nsplit", "perm", "iperm", "Lp", "Li", "Lx", "D",
                 "nnz")


class MultilevelILDLFactor:
    """Multilevel incomplete LDL^T: condest-driven pivot rejection with
    Schur-complement recursion -- the semantics of ILUPACK's AMGfactor
    (pcilupack.c:29-176: droptol for the factors, condest bounding the
    inverse growth per level, droptolS for the coarse Schur systems).

    Per level, two native passes: a TRIAL factorization discovers which
    pivots are safe under the condest bound, then the rejected unknowns are
    permuted last and a SPLIT factorization eliminates the safe block and
    forms the approximate Schur complement, which becomes the next level.
    Recursion stops when nothing is rejected or the Schur system is small;
    a droptol-0 factorization (a direct LDL^T) finishes the job."""

    def __init__(self, A_upper_csr, droptol, condest=100.0, droptolS=None,
                 drop_cap=5.0, max_levels=20, nmin=16):
        import scipy.sparse as sp
        lib = _load("ildl")
        self._lib = lib
        if droptolS is None:
            droptolS = droptol
        self.levels = []
        A = A_upper_csr.tocsr()
        total_nnz = 0
        for _ in range(max_levels):
            n = A.shape[0]
            if n <= nmin:
                break
            _, Ap, Aj, Ax = _as_upper_csr_arrays(A)
            rej = _c_char_p()
            nreject = ctypes.c_long()
            rc = lib.ildl_factor_trial(n, _lp(Ap), _lp(Aj), _dp(Ax),
                                       droptol, condest, drop_cap,
                                       ctypes.byref(rej),
                                       ctypes.byref(nreject))
            if rc != 0:
                raise RuntimeError("ildl_factor_trial failed")
            rj = np.frombuffer(
                ctypes.string_at(rej, n), dtype=np.int8).copy()
            lib.ildl_free(rej)
            nc = int(nreject.value)
            nsplit = n - nc
            perm = np.concatenate([np.nonzero(rj == 0)[0],
                                   np.nonzero(rj)[0]]).astype(np.int64)
            # symmetric permutation, rejected last, back to upper CSR
            Afull = A + sp.triu(A, 1).T
            Pm = Afull[perm][:, perm]
            Aperm = sp.triu(Pm).tocsr()
            _, Ap, Aj, Ax = _as_upper_csr_arrays(Aperm)
            Lp = _c_long_p()
            Li = _c_long_p()
            Lx = _c_dbl_p()
            D = _c_dbl_p()
            Sp = _c_long_p()
            Sj = _c_long_p()
            Sx = _c_dbl_p()
            nnz = ctypes.c_long()
            rc = lib.ildl_factor_split(
                n, _lp(Ap), _lp(Aj), _dp(Ax), droptol, condest, drop_cap,
                droptolS, nsplit,
                ctypes.byref(Lp), ctypes.byref(Li), ctypes.byref(Lx),
                ctypes.byref(D), ctypes.byref(nnz),
                ctypes.byref(Sp), ctypes.byref(Sj), ctypes.byref(Sx))
            if rc != 0:
                raise RuntimeError("ildl_factor_split failed")
            lv = _MLLevel()
            lv.n = n
            lv.nsplit = nsplit
            lv.perm = perm
            lv.iperm = np.empty(n, dtype=np.int64)
            lv.iperm[perm] = np.arange(n)
            ln = np.ctypeslib.as_array(Lp, shape=(n + 1,)).copy()
            lnnz = int(ln[-1])
            lv.Lp = ln
            lv.Li = np.ctypeslib.as_array(Li, shape=(max(lnnz, 1),)).copy()
            lv.Lx = np.ctypeslib.as_array(Lx, shape=(max(lnnz, 1),)).copy()
            lv.D = np.ctypeslib.as_array(D, shape=(n,)).copy()
            lv.nnz = int(nnz.value)
            total_nnz += lv.nnz
            spv = np.ctypeslib.as_array(Sp, shape=(nc + 1,)).copy()
            snnz = int(spv[-1]) if nc > 0 else 0
            sjv = np.ctypeslib.as_array(Sj, shape=(max(snnz, 1),)).copy()
            sxv = np.ctypeslib.as_array(Sx, shape=(max(snnz, 1),)).copy()
            for p in (Lp, Li, Lx, D, Sp, Sj, Sx):
                lib.ildl_free(p)
            self.levels.append(lv)
            if nc == 0:
                A = None
                break
            A = sp.csr_matrix((sxv[:snnz], sjv[:snnz], spv), shape=(nc, nc))
        # terminal level: droptol-0 plain factorization = direct LDL^T
        self.coarse = None
        if A is not None and A.shape[0] > 0:
            self.coarse = ILDLFactor(A, droptol=0.0)
            total_nnz += self.coarse.nnz
        self.n = self.levels[0].n if self.levels else (
            self.coarse.n if self.coarse else 0)
        self.nnz = total_nnz
        self.nlevels = len(self.levels) + (1 if self.coarse is not None
                                           else 0)

    def storage_bytes(self):
        """Measured memory held by the preconditioner: every per-level
        array (factor values + index arrays + diagonals + permutations),
        the basis of the 'final elbow space factor' report (pcilupack.c:169
        prints ILUPACK's used-elbow, i.e. memory consumed relative to
        nnz(A))."""
        total = 0
        for lv in self.levels:
            for name in ("Lp", "Li", "Lx", "D", "perm", "iperm"):
                a = getattr(lv, name, None)
                if a is not None:
                    total += np.asarray(a).nbytes
        if self.coarse is not None:
            for name in ("Lp", "Li", "Lx", "D"):
                total += np.asarray(getattr(self.coarse, name)).nbytes
        return total

    def _solve_level(self, k, b):
        if k >= len(self.levels):
            return self.coarse.solve(b) if self.coarse is not None else b
        lv = self.levels[k]
        x = np.ascontiguousarray(np.asarray(b, dtype=np.float64)[lv.perm])
        self._lib.ildl_split_fwd(lv.n, lv.nsplit, _lp(lv.Lp), _lp(lv.Li),
                                 _dp(lv.Lx), _dp(lv.D), _dp(x))
        if lv.nsplit < lv.n:
            x[lv.nsplit:] = self._solve_level(k + 1, x[lv.nsplit:])
        self._lib.ildl_split_bwd(lv.n, lv.nsplit, _lp(lv.Lp), _lp(lv.Li),
                                 _dp(lv.Lx), _dp(x))
        return x[lv.iperm]

    def solve(self, b):
        if np.shape(b) != (self.n,):
            raise ValueError(f"right-hand side of shape {np.shape(b)}, "
                             f"expected ({self.n},)")
        return self._solve_level(0, b)


def _sym_adjacency(A_csr):
    """Full symmetric pattern CSR (int64) of A + A^T, no self loops."""
    A = A_csr.tocsr()
    S = (A + A.T).tocsr().sorted_indices()
    S.setdiag(0)
    S.eliminate_zeros()
    Ap = np.ascontiguousarray(S.indptr, dtype=np.int64)
    Aj = np.ascontiguousarray(S.indices, dtype=np.int64)
    return S.shape[0], Ap, Aj, S


def amd_order(A_csr):
    """Approximate Minimum Degree ordering (native/order.cpp: quotient
    graph, element absorption, approximate external degrees, supervariable
    coalescing -- the AMD the reference links via SuiteSparse)."""
    lib = _load("order")
    n, Ap, Aj, _ = _sym_adjacency(A_csr)
    perm = np.empty(n, dtype=np.int64)
    rc = lib.amd_order(n, _lp(Ap), _lp(Aj), _lp(perm))
    if rc != 0:
        raise RuntimeError("amd_order failed")
    return perm


def nd_order(A_csr, leaf=64):
    """Nested-dissection ordering (native/order.cpp: recursive level-set
    bisection, pseudo-peripheral roots, separators last, minimum-degree
    leaves) -- the METIS_NodeND class the reference's 'metisn' default
    uses (pcildl.c:480-482)."""
    lib = _load("order")
    n, Ap, Aj, _ = _sym_adjacency(A_csr)
    perm = np.empty(n, dtype=np.int64)
    rc = lib.nd_order(n, _lp(Ap), _lp(Aj), _lp(perm), leaf)
    if rc != 0:
        raise RuntimeError("nd_order failed")
    return perm


def mc64_scaling(A_csr):
    """Maximum-product matching scalings (MC64 job=5 semantics,
    native/order.cpp): row/column scalings that make every matched entry
    of |D_r A D_c| equal 1 and all others <= 1. Returns (sr, sc, match).
    The symmetrized scaling sqrt(sr*sc) is what ILUPACK applies before
    its symmetric factorizations (pcildl.c:147-193)."""
    lib = _load("order")
    A = A_csr.tocsr().sorted_indices()
    n = A.shape[0]
    Ap = np.ascontiguousarray(A.indptr, dtype=np.int64)
    Aj = np.ascontiguousarray(A.indices, dtype=np.int64)
    Ax = np.ascontiguousarray(A.data, dtype=np.float64)
    sr = np.empty(n)
    sc = np.empty(n)
    match = np.empty(n, dtype=np.int64)
    rc = lib.mc64_scale(n, _lp(Ap), _lp(Aj), _dp(Ax), _dp(sr), _dp(sc),
                        _lp(match))
    if rc != 0:
        raise RuntimeError("mc64: structurally singular matrix")
    return sr, sc, match


class ILU0Factor:
    """ILU(0) on the original CSR pattern, natural ordering (PETSc PCILU
    defaults). Factorization and triangular solves run in native C++
    (host_src/ilu0.cpp)."""

    def __init__(self, A_csr):
        lib = _load("ilu0")
        A = A_csr.tocsr().sorted_indices()
        self.n = A.shape[0]
        self.Ap = np.ascontiguousarray(A.indptr, dtype=np.int64)
        self.Aj = np.ascontiguousarray(A.indices, dtype=np.int64)
        self.Ax = np.ascontiguousarray(A.data, dtype=np.float64).copy()
        rc = lib.ilu0_factor(self.n, _lp(self.Ap), _lp(self.Aj),
                             _dp(self.Ax))
        if rc >= 0:
            raise ZeroDivisionError(f"ILU(0) zero pivot at row {rc}")
        self._lib = lib

    def solve(self, b):
        x = _vec(b, self.n)
        self._lib.ilu0_solve(self.n, _lp(self.Ap), _lp(self.Aj),
                             _dp(self.Ax), _dp(x))
        return x
