"""Structured multilinear prolongation and the Galerkin coarse hierarchy
(host setup, numpy/scipy).

The setup half of exsaddle_tpu/precond_mg.py: the ABF u-block multigrid
(-saddle_fieldsplit_u_pc_mg_galerkin, abf.opts:13) needs the DMDA
interpolation between node grids only to form the RAP products of its deep
levels; the solve itself applies transfers in the parity/grid layouts of
abf.py. Index/weight arrays are built exactly as the JAX package builds them,
so the coarse operators are the same matrices."""

import numpy as np


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

    def apply(self, xc):
        """x_fine = P x_coarse."""
        return np.sum(np.asarray(xc)[self.cidx] * self.wts, axis=1)

    def restrict(self, rf):
        """r_coarse = P^T r_fine (MatRestrict)."""
        contrib = np.asarray(rf)[:, None] * self.wts
        return np.bincount(self.cidx.ravel(), weights=contrib.ravel(),
                           minlength=self.coarse_n)

    def restriction_scale(self):
        """DMCreateInterpolationScale: 1 / (P^T ones)."""
        return 1.0 / self.restrict(np.ones(self.fine_n))

    def to_scipy(self):
        """CSR form of P for setup-phase Galerkin RAP products."""
        import scipy.sparse as sp
        rows = np.repeat(np.arange(self.fine_n), self.cidx.shape[1])
        P = sp.coo_matrix((self.wts.ravel(), (rows, self.cidx.ravel())),
                          shape=(self.fine_n, self.coarse_n)).tocsr()
        P.sum_duplicates()
        return P


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
