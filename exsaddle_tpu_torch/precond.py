"""Preconditioners with reference-matching semantics (the torch port of
exsaddle_tpu/precond.py).

Capability parity with the PETSc PC subset the reference exercises
(SURVEY.md section 2.2): Jacobi, ILU(0), LU, SOR (solver_config.make_sor),
block-Jacobi, fieldsplit (Schur UPPER with a user Schur-pre matrix, and
additive), ASM, ILDL and ILUPACK; geometric multigrid is precond_mg.py.

Setup (factorizations, orderings) runs on the host in numpy/scipy/C++ like
PETSc's setup phase. Applies take and return tensors on the vector's device:
Jacobi, LU (torch.linalg.lu_factor/lu_solve) and the block/fieldsplit
compositions stay on the device. ILU(0), ILDL and ILUPACK keep the JAX
package's design (exsaddle_tpu/precond.py:13-24): their applies are
sequential sparse triangular solves in native C++, so each apply moves the
vector to host numpy and back to its device explicitly. The nranks>1
block-Jacobi blocks and the ASM patches are host CSR sub-matrices
(solver_config) whose sub-solvers do the same.
"""

import numpy as np
import torch


def _host_apply(solve, x):
    """y = solve(x) for a host (numpy) solve: to the host and back to x's
    device and dtype."""
    y = solve(x.detach().cpu().numpy())
    return torch.as_tensor(y, dtype=x.dtype).to(x.device)


def _index(idx, device):
    """A numpy index array as an int64 tensor on `device`."""
    return torch.as_tensor(np.asarray(idx, dtype=np.int64), device=device)


class PCNone:
    def apply(self, x):
        return x


class PCJacobi:
    """PCJACOBI: y = x / diag(A); zero diagonal entries replaced by 1.0
    (PCSetUp_Jacobi's zero-pivot guard)."""

    def __init__(self, diag, device):
        d = torch.as_tensor(diag, dtype=torch.float64, device=device)
        d = torch.where(d == 0.0, torch.ones_like(d), d)
        self.inv_diag = 1.0 / d

    def apply(self, x):
        return self.inv_diag * x


class PCILU:
    """PCILU: ILU(0), natural ordering (PETSc PCILU defaults: 0 levels of
    fill, no shifts). Factorization and triangular solves run in native
    C++ on the original CSR pattern (native.ILU0Factor) on the host."""

    def __init__(self, A_csr):
        from exsaddle_tpu_torch.native import ILU0Factor
        self.fact = ILU0Factor(A_csr)
        self.n = self.fact.n

    def apply(self, x):
        return _host_apply(self.fact.solve, x)


class PCLU:
    """PCLU: exact (dense) LU with partial pivoting on the device -- the
    stable direct solve standing in for UMFPACK (Makefile:176-178 notes
    PETSc's sparse LU is unstable for these saddle systems; dense LAPACK
    pivoting is)."""

    def __init__(self, A_dense, device):
        A = torch.as_tensor(A_dense, dtype=torch.float64, device=device)
        self.lu, self.piv = torch.linalg.lu_factor(A)

    def apply(self, x):
        return torch.linalg.lu_solve(self.lu, self.piv,
                                     x.unsqueeze(1)).squeeze(1)


class PCBJacobi:
    """PCBJACOBI with per-block sub-KSPs over arbitrary dof index blocks.
    Serial: one block over the whole space (sub default preonly+ILU(0),
    matching testref/exSaddle3d_pseudoice_1.ref's bjacobi section).
    Parallel emulation: one block per virtual rank, blocks = the DMDA
    ownership dof sets (decomp.bjacobi_block_ranges)."""

    def __init__(self, n, sub_solvers, blocks, device):
        self.n = n
        self.subs = sub_solvers
        self.blocks = [_index(b, device) for b in blocks]

    def apply(self, x):
        y = torch.empty_like(x)
        for ksp, idx in zip(self.subs, self.blocks):
            y[idx] = ksp.solve(x[idx]).x
        return y


class PCKSP:
    """Adapter: use a KSP solve as a PC apply (used for fieldsplit splits
    and MG coarse solves)."""

    def __init__(self, ksp):
        self.ksp = ksp

    def apply(self, x):
        return self.ksp.solve(x).x


class SchurComplementApply:
    """MatSchurComplement: y = A11 x - A10 inv(A00) A01 x with inv(A00)
    applied by the fieldsplit's A00 KSP (fieldsplit.c Schur setup; view:
    'KSP of A00')."""

    def __init__(self, mult_p, mult_up, mult_pu, ksp_A00):
        self.mult_p = mult_p      # xp -> A11 xp
        self.mult_up = mult_up    # xp -> A01 xp (into u space)
        self.mult_pu = mult_pu    # xu -> A10 xu (into p space)
        self.ksp_A00 = ksp_A00

    def __call__(self, xp):
        t = self.mult_up(xp)
        w = self.ksp_A00.solve(t).x
        return self.mult_p(xp) - self.mult_pu(w)


class PCFieldSplitSchurUpper:
    """PCFIELDSPLIT, PC_COMPOSITE_SCHUR, PC_FIELDSPLIT_SCHUR_FACT_UPPER
    (exSaddle.c:313-318):

        y_p = kspschur^-1 b_p
        y_u = kspA^-1 (b_u - A01 y_p)

    kspschur has the true Schur complement as operator and a preconditioner
    built from the user matrix Mpscaled (PC_FIELDSPLIT_SCHUR_PRE_USER)."""

    def __init__(self, nu, ksp_A00, ksp_schur, mult_up):
        self.nu = nu
        self.ksp_A00 = ksp_A00
        self.ksp_schur = ksp_schur
        self.mult_up = mult_up

    def apply(self, x):
        bu = x[: self.nu]
        bp = x[self.nu:]
        yp = self.ksp_schur.solve(bp).x
        yu = self.ksp_A00.solve(bu - self.mult_up(yp)).x
        return torch.cat([yu, yp])


class PCASM:
    """PCASM (type RESTRICT, the PETSc default) with DM-defined
    element-aligned overlapping patches (DMCreateDomainDecomposition_
    DMDAFEQ2Q1, femixedspace.c:746-837): restrict the residual to each
    overlapping patch, sub-solve, but add the correction back only on the
    rank's OWNED dofs (a disjoint partition, so each owned dof is written
    once).

    Patch solves are delegated to per-patch sub-KSPs (preonly+LU in every
    reference configuration, Makefile:298,411,418)."""

    def __init__(self, n, subksps, patches, restrict_masks, device):
        self.n = n
        self.subksps = subksps
        self.patches = [_index(p, device) for p in patches]
        # owned dofs: global indices and their positions inside the patch
        self.owned = [_index(np.asarray(p)[m], device)
                      for p, m in zip(patches, restrict_masks)]
        self.owned_pos = [_index(np.nonzero(m)[0], device)
                          for m in restrict_masks]

    def apply(self, x):
        y = torch.zeros_like(x)
        for ksp, idx, own, pos in zip(self.subksps, self.patches, self.owned,
                                      self.owned_pos):
            res = ksp.solve(x[idx])
            y[own] += res.x[pos]
        return y


def _ildl_prepare(A_csr, ordering, matching):
    """Shared ILDL/ILUPACK preprocessing mirroring ILUPACK's pipeline
    (pcildl.c:147-193): MC64 maximum-product matching SCALING (symmetrized
    sqrt(sr*sc), native/order.cpp) when matching is on, then a
    fill-reducing symmetric ordering of the scaled matrix:

      metisn / metise -> native nested dissection (METIS_NodeND class)
      amd             -> native Approximate Minimum Degree
      rcm             -> reverse Cuthill-McKee
      natural         -> identity

    Returns (perm, iperm, scale, upper_csr) with upper_csr the permuted
    scaled upper triangle."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    from exsaddle_tpu_torch.native import amd_order, nd_order, mc64_scaling

    A = A_csr.tocsr()
    n = A.shape[0]
    if matching:
        sr, sc, _ = mc64_scaling(A)
        scale0 = np.sqrt(sr * sc)
    else:
        scale0 = np.ones(n)
    # scale in place so explicit zeros keep the stored pattern (the nz
    # count reported must match the reference's preallocated pattern)
    As = A.copy().sorted_indices()
    rows = np.repeat(np.arange(n), np.diff(As.indptr))
    As.data = As.data * scale0[rows] * scale0[As.indices]

    if ordering in ("metisn", "metise"):
        perm = np.asarray(nd_order(As))
    elif ordering == "amd":
        perm = np.asarray(amd_order(As))
    elif ordering == "rcm":
        perm = np.asarray(reverse_cuthill_mckee(As, True))
    else:                       # natural
        perm = np.arange(n)
    iperm = np.empty(n, dtype=np.int64)
    iperm[perm] = np.arange(n)
    Ps = As[perm][:, perm].tocsr().sorted_indices()
    Pu = sp.triu(Ps).tocsr()
    return perm, iperm, scale0[perm], Pu


class _PermutedFactorPC:
    """Apply of a symmetric factorization of the scaled, permuted matrix
    (_ildl_prepare): y = iperm(scale * fact^-1 (scale * perm(x))), solved
    on the host."""

    def _solve(self, xnp):
        y = self.scale * self.fact.solve(self.scale * xnp[self.perm])
        return y[self.iperm]

    def apply(self, x):
        return _host_apply(self._solve, x)


class PCILDL(_PermutedFactorPC):
    """PCILDL: incomplete LDL^T with drop tolerance -- the equivalent of
    the reference's ILUPACK-backed custom PC (pcildl.c:46-372: upper-CSR
    extraction, matching+ordering, DSYMiluc factorization, pilucsol
    triangular solves). The factorization runs in native C++
    (native.MultilevelILDLFactor): Crout LDL^T with inverse-based
    (growth-monitored) dropping and deferral of unstable pivots to a small
    Schur complement that is factored exactly.

    Orderings: amd (the default), metisn/metise, rcm, natural; matching
    applies MC64 maximum-product symmetrized scalings. Prints the relative
    fill line in the reference's format (pcildl.c:267). The solve runs on
    the host."""

    def __init__(self, A_csr, droptol=1e-2, ordering="amd",
                 matching=True, log=print):
        from exsaddle_tpu_torch.native import MultilevelILDLFactor

        n = A_csr.shape[0]
        self.perm, self.iperm, self.scale, Pu = _ildl_prepare(
            A_csr, ordering, matching)
        self.fact = MultilevelILDLFactor(
            Pu, droptol, condest=20.0, drop_cap=5.0,
            droptolS=max(droptol * 1e-2, 1e-14),
            nmin=max(500, n // 30))
        nzA = Pu.nnz
        log(f"relative fill ILDL/A: {self.fact.nnz / nzA:8.1e} "
            f"(wrt {nzA} nz)")


class PCILUPACK(_PermutedFactorPC):
    """PCILUPACK: multilevel ILU (ILUPACK AMGfactor/AMGsol,
    pcilupack.c:29-245): condest-driven pivot rejection builds a genuine
    multilevel factorization -- each level eliminates the pivots whose
    inverse growth stays under the condest bound, the rejected unknowns
    form an approximate Schur complement (drop tolerance droptolS) that
    becomes the next level (native.MultilevelILDLFactor). The solve runs on
    the host."""

    def __init__(self, A_csr, droptol=1e-2, condest=100.0, droptolS=None,
                 log=print):
        from exsaddle_tpu_torch.native import MultilevelILDLFactor

        self.droptol = droptol
        self.condest = condest
        self.droptolS = droptolS if droptolS is not None else droptol
        self.perm, self.iperm, self.scale, Pu = _ildl_prepare(
            A_csr, "metisn", True)
        self.fact = MultilevelILDLFactor(
            Pu, droptol, condest=condest, drop_cap=5.0,
            droptolS=droptolS if droptolS is not None else droptol)
        # banner in the reference's format (pcilupack.c AMGfactor report).
        # The elbow factor is the MEASURED memory held by the multilevel
        # preconditioner relative to the input matrix's CSR memory --
        # ILUPACK's own used-elbow semantics (pcilupack.c:169 prints
        # param.elbow as updated by AMGfactor, + its 0.005 rounding nudge)
        log(f"factorization successful with {self.fact.nlevels} levels "
            "completed")
        a_bytes = (Pu.data.nbytes + Pu.indices.nbytes + Pu.indptr.nbytes)
        elbow = self.fact.storage_bytes() / max(a_bytes, 1) + 0.005
        log(f"final elbow space factor={elbow:8.2f}")


class PCFieldSplitAdditive:
    """PCFIELDSPLIT, PC_COMPOSITE_ADDITIVE (the PETSc default used by
    ex42mod's field-based split, ex42mod.c:1561-1567):
    y = R_u^T ksp_u(x_u) + R_p^T ksp_p(x_p)."""

    def __init__(self, n, splits, device):
        self.n = n
        self.splits = [(_index(idx, device), ksp) for idx, ksp in splits]

    def apply(self, x):
        y = torch.zeros_like(x)
        for idx, ksp in self.splits:
            y[idx] = ksp.solve(x[idx]).x
        return y
