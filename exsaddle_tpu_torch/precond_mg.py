"""Geometric multigrid: structured prolongation/restriction, PCMG V-cycle
and the Galerkin coarse hierarchy (the torch port of
exsaddle_tpu/precond_mg.py).

Capability parity with the reference's two MG configurations:
  - monolithic saddle PCMG with per-level *re-assembled* operators
    (PC_MG_GALERKIN_NONE) and DMComposite interpolation = blockdiag of the
    Q2-velocity and Q1-pressure multilinear interpolations
    (exSaddle.c:333-402);
  - Galerkin MG inside the velocity block of a fieldsplit
    (-saddle_fieldsplit_u_pc_mg_galerkin, abf.opts:13) with RAP coarse
    operators.

Interpolation between structured node grids is multilinear (DMDA's default
Q1 interpolation). Index/weight arrays are built on the host exactly as the
JAX package builds them, so the coarse operators are the same matrices. On
the device, P is a gather with weights and its transpose (restriction) is
stored as a padded-row (ELL) gather of P^T: both are sums over fixed-width
rows, with no scatter, so they are deterministic on CUDA. The ABF route
needs only the host half (restriction_scale, to_scipy, the Galerkin
products); its solve applies transfers in the parity/grid layouts of
abf.py."""

import numpy as np
import torch


def _ell(A_csr):
    """Padded-row (ELL) form of a scipy CSR matrix: (cols, vals) numpy
    arrays of shape (n, max row length), padding col 0 / val 0."""
    A = A_csr.tocsr().sorted_indices()
    n = A.shape[0]
    counts = np.diff(A.indptr)
    k = int(counts.max())
    cols = np.zeros((n, k), dtype=np.int64)
    vals = np.zeros((n, k))
    rows = np.repeat(np.arange(n), counts)
    slot = np.arange(A.nnz) - np.repeat(A.indptr[:-1], counts)
    cols[rows, slot] = A.indices
    vals[rows, slot] = A.data
    return cols, vals


class Prolongation:
    """Multilinear interpolation between structured node grids.

    coarse_nn/fine_nn: node counts per dimension (x fastest linearization).
    dof: dofs per node (interleaved).
    Equivalent to DMDA's DMCreateInterpolation for uniform coordinates."""

    def __init__(self, coarse_nn, fine_nn, dof=1):
        ndim = len(coarse_nn)
        self.dof = dof
        self.coarse_n = int(np.prod(coarse_nn)) * dof
        self.fine_n = int(np.prod(fine_nn)) * dof

        # per-dimension: fine index -> (base coarse index, weight of base+1)
        base_1d, w_1d = [], []
        for d in range(ndim):
            nc, nf = coarse_nn[d], fine_nn[d]
            # fine node at parametric coarse coordinate t in [0, nc-1]
            t = np.arange(nf) * (nc - 1) / (nf - 1)
            b = np.floor(t + 1e-12).astype(np.int64)
            b = np.minimum(b, nc - 2) if nc > 1 else b * 0
            w = t - b
            base_1d.append(b)
            w_1d.append(w)

        # tensor-product stencil: 2^ndim coarse nodes per fine node
        fine_grid = np.indices(tuple(fine_nn[::-1])).reshape(ndim, -1)[::-1]
        # fine_grid[d] is the d-coordinate of each fine node, x fastest
        nfine_nodes = fine_grid.shape[1]
        ncorners = 2 ** ndim
        cidx = np.zeros((nfine_nodes, ncorners), dtype=np.int64)
        wts = np.ones((nfine_nodes, ncorners))
        for corner in range(ncorners):
            coord = np.zeros((ndim, nfine_nodes), dtype=np.int64)
            w = np.ones(nfine_nodes)
            for d in range(ndim):
                bit = (corner >> d) & 1
                fb = base_1d[d][fine_grid[d]]
                fw = w_1d[d][fine_grid[d]]
                coord[d] = np.minimum(fb + bit, coarse_nn[d] - 1)
                w = w * (fw if bit else (1.0 - fw))
            lin = coord[0]
            mult = coarse_nn[0]
            for d in range(1, ndim):
                lin = lin + coord[d] * mult
                mult *= coarse_nn[d]
            cidx[:, corner] = lin
            wts[:, corner] = w

        if dof > 1:
            # expand to interleaved dofs
            cidx = (dof * cidx[:, None, :]
                    + np.arange(dof)[None, :, None]).reshape(-1, ncorners)
            wts = np.repeat(wts, dof, axis=0)
        self.cidx = cidx
        self.wts = wts
        self._dev = {}            # (device, dtype) -> device arrays

    def _device_arrays(self, x):
        key = (x.device, x.dtype)
        if key not in self._dev:
            rcols, rvals = _ell(self.to_scipy().T)
            self._dev[key] = tuple(
                torch.as_tensor(a, device=x.device,
                                dtype=None if a.dtype == np.int64
                                else x.dtype)
                for a in (self.cidx, self.wts, rcols, rvals))
        return self._dev[key]

    def apply(self, xc):
        """x_fine = P x_coarse (tensor)."""
        cidx, wts, _, _ = self._device_arrays(xc)
        return (xc[cidx] * wts).sum(dim=1)

    def restrict(self, rf):
        """r_coarse = P^T r_fine (MatRestrict; tensor): an ELL gather of
        P^T, deterministic on every device."""
        _, _, rcols, rvals = self._device_arrays(rf)
        return (rf[rcols] * rvals).sum(dim=1)

    def restriction_scale(self):
        """DMCreateInterpolationScale: 1 / (P^T ones) (numpy)."""
        return 1.0 / np.bincount(self.cidx.ravel(), weights=self.wts.ravel(),
                                 minlength=self.coarse_n)

    def to_scipy(self):
        """CSR form of P for setup-phase Galerkin RAP products."""
        import scipy.sparse as sp
        rows = np.repeat(np.arange(self.fine_n), self.cidx.shape[1])
        P = sp.coo_matrix((self.wts.ravel(), (rows, self.cidx.ravel())),
                          shape=(self.fine_n, self.coarse_n)).tocsr()
        P.sum_duplicates()
        return P


class BlockDiagProlongation:
    """DMComposite interpolation: blockdiag(P_u, P_p) on [u | p] vectors
    (exSaddle.c:348 via DMCreateInterpolation on the composite)."""

    def __init__(self, P_u, P_p):
        self.P_u = P_u
        self.P_p = P_p
        self.fine_nu = P_u.fine_n
        self.coarse_nu = P_u.coarse_n
        self.fine_n = P_u.fine_n + P_p.fine_n
        self.coarse_n = P_u.coarse_n + P_p.coarse_n

    def apply(self, xc):
        return torch.cat([self.P_u.apply(xc[: self.coarse_nu]),
                          self.P_p.apply(xc[self.coarse_nu:])])

    def restrict(self, rf):
        return torch.cat([self.P_u.restrict(rf[: self.fine_nu]),
                          self.P_p.restrict(rf[self.fine_nu:])])


class MGLevel:
    """One PCMG level: smoother KSP (pre==post, nonzero initial guess on the
    post sweep), operator apply, prolongation from the next-coarser level."""

    def __init__(self, apply_A, smoother, prolong):
        self.A = apply_A
        self.smoother = smoother
        self.P = prolong


class PCMG:
    """PCMG multiplicative V-cycle, 1 cycle per application (the reference's
    configuration; testref view: 'type is MULTIPLICATIVE, levels=N cycles=v,
    Cycles per PCApply=1')."""

    def __init__(self, levels, coarse_ksp):
        self.levels = levels      # levels[1..] from coarsest+1 to finest
        self.coarse_ksp = coarse_ksp
        self.nlevels = len(levels) + 1

    def apply(self, b):
        return self._cycle(self.nlevels - 1, b)

    def _cycle(self, k, b):
        if k == 0:
            return self.coarse_ksp.solve(b).x
        lv = self.levels[k - 1]
        x = lv.smoother.solve(b).x                 # pre-smooth from zero
        r = b - lv.A(x)
        xc = self._cycle(k - 1, lv.P.restrict(r))
        x = x + lv.P.apply(xc)
        return lv.smoother.solve(b, x0=x).x        # post-smooth, x warm


def galerkin_coarse_operators(A_fine_csr, prolongations, dof=1):
    """Compute the Galerkin hierarchy A_k = P_k^T A_{k+1} P_k (PCMG Galerkin,
    abf.opts:13). prolongations: list from coarsest->fine transfer, i.e.
    prolongations[k] maps level k to level k+1. Returns list of CSR coarse
    operators [A_0 ... A_{nlev-2}].

    dof > 1 inflates each coarse pattern to full dof x dof node blocks
    (explicit zeros), matching PETSc's MatPtAP result for a bs=dof
    interpolation (the reference's coarse operators report e.g.
    nonzeros=9000 = 9 * node-pairs, testref/exSaddle3d_pseudoice_1.ref)."""
    import scipy.sparse as sp
    ops = [None] * len(prolongations)
    A = A_fine_csr
    for k in range(len(prolongations) - 1, -1, -1):
        P = prolongations[k].to_scipy()
        A = (P.T @ (A @ P)).tocsr()
        A.sum_duplicates()
        if dof > 1:
            # inflate to the node-block pattern with EXPLICIT zeros (scipy
            # arithmetic would prune them): values of A scattered into the
            # block-union structure
            C = A.tocoo()
            nb = A.shape[0] // dof
            blk = sp.coo_matrix(
                (np.ones_like(C.data), (C.row // dof, C.col // dof)),
                shape=(nb, nb)).tocsr()
            blk.sum_duplicates()
            blk.data[:] = 1.0
            pat = sp.kron(blk, np.ones((dof, dof)), format="csr")
            pat.sort_indices()
            data = np.zeros(pat.nnz)
            Ac = A.tocsr().sorted_indices()
            # locate each A entry inside pat's (superset) row structure
            pos = np.empty(Ac.nnz, dtype=np.int64)
            for r in range(A.shape[0]):
                a0, a1 = Ac.indptr[r], Ac.indptr[r + 1]
                p0, p1 = pat.indptr[r], pat.indptr[r + 1]
                pos[a0:a1] = p0 + np.searchsorted(
                    pat.indices[p0:p1], Ac.indices[a0:a1])
            data[pos] = Ac.data
            A = sp.csr_matrix((data, pat.indices, pat.indptr),
                              shape=A.shape)
        ops[k] = A
    return ops


def csr_apply(A_csr, device, max_dense=4096):
    """Return a matvec closure on `device` for a scipy CSR operator: a dense
    matrix at or below max_dense rows, a padded-row ELL gather + row sum
    above (every row of a Q2/Q1 grid operator has <= a few hundred
    entries)."""
    n = A_csr.shape[0]
    if n <= max_dense:
        Ad = torch.as_tensor(A_csr.toarray(), device=device)
        return lambda x: Ad @ x
    cols, vals = _ell(A_csr)
    cols_t = torch.as_tensor(cols, device=device)
    vals_t = torch.as_tensor(vals, device=device)
    return lambda x: (vals_t * x[cols_t]).sum(dim=1)
