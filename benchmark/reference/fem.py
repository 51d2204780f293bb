"""The plain float64 reference of the Q2-Q1 (Taylor-Hood) Stokes saddle
system that the benchmark judges the port's solutions by.

Frozen copies of the setup code the system under test was ported from
(the structured mesh and its element maps, the 3-point Gauss rule, the Q1 /
Q2 tensor bases, the isoparametric geometry, the qp -> Q1 -> qp coefficient
projection and the right-hand side of the reference's femixedspace.c), as
they stood when the benchmark was written, and the element matrices of the
weak forms of MatAssemble_Saddle (femixedspace.c:2487-2610),

    A11 = sum_q w_q detJ_q eta_q B^T D B,  D = diag(2, 2, 2, 1, 1, 1)
    A12 = -sum_q w_q detJ_q grad(N_u) N_p,  A21 = A12^T,  A22 = 0,

applied element by element in float64 (torch, on any device), with the
Dirichlet rows eliminated as y = keep (K (keep x)) + mask x.

The numpy parts build the problem; `Saddle` applies it. Nothing here
imports jax, exsaddle_tpu or exsaddle_tpu_torch, and nothing is taken from
what the system under test built: the operator, the coefficients, the
Dirichlet rows and the loads are all worked out here again.
"""

import numpy as np
import torch

# --------------------------------------------------------------------------
# Quadrature and bases (femixedspace.c:1366-1408, 1489-1855)
# --------------------------------------------------------------------------

# the 3-point Gauss-Legendre rule at the precision the reference hard-codes
XI_1D = np.array([-0.774596669241483, 0.0, 0.774596669241483])
WT_1D = np.array([0.555555555555556, 0.888888888888889, 0.555555555555556])


def gauss_tensor(ndim):
    """(points (nqp, ndim), weights (nqp,)), x index fastest."""
    idx = np.stack(np.meshgrid(*[np.arange(3)] * ndim, indexing="ij"),
                   axis=-1).reshape(-1, ndim)[:, ::-1]
    return XI_1D[idx], np.prod(WT_1D[idx], axis=1)


def _q1_1d(x):
    return np.array([0.5 * (1.0 - x), 0.5 * (1.0 + x)])


def _q1_1d_deriv(x):
    return np.array([-0.5, 0.5])


def _q2_1d(x):
    return np.array([0.5 * x * (x - 1.0), (1.0 + x) * (1.0 - x),
                     0.5 * (1.0 + x) * x])


def _q2_1d_deriv(x):
    return np.array([0.5 * (2.0 * x - 1.0), -2.0 * x, 0.5 * (2.0 * x + 1.0)])


def _tensor_basis(pts, vals_1d, derivs_1d, nb_1d):
    """(N (nqp, nb), dN (nqp, ndim, nb)), node x index fastest."""
    nqp, ndim = pts.shape
    loc = np.stack(np.meshgrid(*[np.arange(nb_1d)] * ndim, indexing="ij"),
                   axis=-1).reshape(-1, ndim)[:, ::-1]      # (nb, ndim)
    N = np.ones((nqp, len(loc)))
    dN = np.ones((nqp, ndim, len(loc)))
    for q in range(nqp):
        v = [vals_1d(pts[q, d])[loc[:, d]] for d in range(ndim)]
        g = [derivs_1d(pts[q, d])[loc[:, d]] for d in range(ndim)]
        for d in range(ndim):
            N[q] *= v[d]
            for a in range(ndim):
                dN[q, a] *= g[d] if a == d else v[d]
    return N, dN


def tabulate_q1(pts):
    return _tensor_basis(pts, _q1_1d, _q1_1d_deriv, 2)


def tabulate_q2(pts):
    return _tensor_basis(pts, _q2_1d, _q2_1d_deriv, 3)


# --------------------------------------------------------------------------
# Mesh (femixedspace.c:852-1363): node index i + j nx + k nx ny, dofs
# [u interleaved per node | p], elements ei + ej mx + ek mx my
# --------------------------------------------------------------------------

def _grid_indices(nn):
    """(prod(nn), ndim) structured coordinates, x fastest."""
    g = np.meshgrid(*[np.arange(n) for n in reversed(nn)], indexing="ij")
    return np.stack([a.ravel() for a in reversed(g)], axis=1)


def _lin_index(coords, nn):
    idx = coords[..., 0].astype(np.int64)
    mult = nn[0]
    for d in range(1, len(nn)):
        idx = idx + coords[..., d] * mult
        mult *= nn[d]
    return idx


class Mesh:
    """Q2-Q1 structured box mesh of m_el elements over a box of `size`."""

    def __init__(self, m_el, size):
        self.ndim = nd = len(m_el)
        if nd not in (2, 3) or len(size) != nd:
            raise ValueError(f"a 2D or 3D box, not m_el {m_el} size {size}")
        self.m_el, self.size = tuple(m_el), tuple(float(s) for s in size)
        self.nn_u = tuple(2 * m + 1 for m in m_el)
        self.nn_p = tuple(m + 1 for m in m_el)
        self.nel = int(np.prod(m_el))
        self.n_u_nodes = int(np.prod(self.nn_u))
        self.nu = nd * self.n_u_nodes
        self.np_ = int(np.prod(self.nn_p))
        self.ndof = self.nu + self.np_
        self.u_basis, self.p_basis = 3 ** nd, 2 ** nd
        origins = _grid_indices(self.m_el)                  # (nel, nd)
        self.u_el_nodes = _lin_index(
            2 * origins[:, None] + _grid_indices((3,) * nd)[None], self.nn_u)
        self.p_el_nodes = _lin_index(
            origins[:, None] + _grid_indices((2,) * nd)[None], self.nn_p)
        self.u_el_dofs = (nd * self.u_el_nodes[:, :, None]
                          + np.arange(nd)[None, None]).reshape(self.nel, -1)
        # elements of one colour share no node: (ei % 2, ej % 2, ek % 2)
        self.el_colour = (origins % 2) @ (2 ** np.arange(nd))
        self.u_grid = _grid_indices(self.nn_u)
        h_u = np.array(self.size) / (np.array(self.nn_u) - 1)
        h_p = np.array(self.size) / (np.array(self.nn_p) - 1)
        self.u_coords = self.u_grid * h_u
        self.p_coords = _grid_indices(self.nn_p) * h_p

    def u_face_nodes(self, dim, end):
        """Q2 nodes on the face where coordinate `dim` is at its min (end
        0) or max (end 1)."""
        val = 0 if end == 0 else self.nn_u[dim] - 1
        return np.nonzero(self.u_grid[:, dim] == val)[0]


# --------------------------------------------------------------------------
# FE geometry (femixedspace.c:1615-1723, 1902-1915)
# --------------------------------------------------------------------------

class FESpace:
    """Basis and quadrature tables and per-element geometry. On a box mesh
    of more than 4096 elements that are all translates of the first, the
    geometry is computed once and broadcast (shared=True)."""

    def __init__(self, mesh):
        self.mesh = mesh
        nd = mesh.ndim
        self.qp, self.wq = gauss_tensor(nd)
        self.nqp = len(self.wq)
        self.Nu, self.dNu = tabulate_q2(self.qp)
        self.Np, self.dNp = tabulate_q1(self.qp)
        xu = mesh.u_coords[mesh.u_el_nodes]                 # (nel, nbu, nd)
        nel = mesh.nel
        span = xu[:, -1] - xu[:, 0]
        rel = xu - xu[:, :1]
        self.shared = bool(
            nel > 4096
            and np.abs(span - span[0]).max() <= 1e-12 * np.abs(span[0]).max()
            and np.abs(rel - rel[0]).max() <= 1e-12 * np.abs(span[0]).max())
        geo = xu[:1] if self.shared else xu
        J = np.einsum("qai,eib->eqab", self.dNu, geo)
        detJ = np.linalg.det(J)
        G = np.einsum("eqab,qbi->eqai", np.linalg.inv(J), self.dNu)
        if self.shared:
            detJ = np.broadcast_to(detJ, (nel, self.nqp))
            G = np.broadcast_to(G, (nel,) + G.shape[1:])
        self.detJ_u, self.dNu_glob = detJ, G
        self.qp_coords = np.einsum("qi,eid->eqd", self.Nu, xu)


# --------------------------------------------------------------------------
# Coefficients: qp evaluation -> lumped Q1 projection -> qp interpolation
# (FEMixedSpaceDefineQPwiseProperties_Q1Projection, femixedspace.c:1937-2266)
# --------------------------------------------------------------------------

def project_qp_to_q1(fes, fields_qp):
    """(nel, nqp, nf) qp fields -> (n_p_nodes, nf) lumped nodal values."""
    mesh = fes.mesh
    nf = fields_qp.shape[-1]
    contrib = np.einsum("qi,eqf->eif", fes.Np, fields_qp)
    idx = mesh.p_el_nodes.ravel()
    nodal = np.stack([np.bincount(idx, weights=contrib[..., f].ravel(),
                                  minlength=mesh.np_) for f in range(nf)],
                     axis=1)
    scale = np.bincount(idx, weights=np.tile(fes.Np.sum(axis=0), mesh.nel),
                        minlength=mesh.np_)
    return nodal / scale[:, None]


def interp_q1_to_qp(fes, nodal):
    """(n_p_nodes, nf) -> (nel, nqp, nf)."""
    return np.einsum("qi,eif->eqf", fes.Np, nodal[fes.mesh.p_el_nodes])


def projected(fes, fields_qp):
    """The qp fields as the solver sees them: projected to the Q1 nodes
    and interpolated back."""
    return interp_q1_to_qp(fes, project_qp_to_q1(fes, fields_qp))


# --------------------------------------------------------------------------
# Right-hand side (VecAssemble_F1_qp / F2_qp, femixedspace.c:2650-2786)
# --------------------------------------------------------------------------

def rhs_vector(fes, Fu_qp, Fp_qp, bc_idx, bc_vals):
    """The assembled load (ndof,) of the body force Fu_qp (nel, nqp, nd) and
    the pressure source Fp_qp (nel, nqp), with the Dirichlet rows set to
    their values."""
    mesh = fes.mesh
    nd, nel, nqp = mesh.ndim, mesh.nel, fes.nqp
    fac = fes.wq[None, :] * fes.detJ_u                      # (nel, nqp)
    Y = (fac[:, :, None] * Fu_qp).transpose(1, 0, 2).reshape(nqp, -1)
    f1 = (fes.Nu.T @ Y).reshape(mesh.u_basis, nel, nd).transpose(1, 0, 2)
    f2 = (fac * Fp_qp) @ fes.Np                             # (nel, npb)
    F = np.empty(mesh.ndof)
    F[:mesh.nu] = np.bincount(mesh.u_el_dofs.ravel(), weights=f1.ravel(),
                              minlength=mesh.nu)
    F[mesh.nu:] = np.bincount(mesh.p_el_nodes.ravel(), weights=f2.ravel(),
                              minlength=mesh.np_)
    F[np.asarray(bc_idx, dtype=np.int64)] = bc_vals
    return F


# --------------------------------------------------------------------------
# The operator
# --------------------------------------------------------------------------

def strain_rows(G, nd):
    """Engineering strain rows B (..., ncomp, nd * nbu) of the global basis
    derivatives G (..., nd, nbu), and their weights D (ncomp,): normal
    strains 2, shear strains 1."""
    pairs = [(a, b) for a in range(nd) for b in range(a + 1, nd)]
    nbu = G.shape[-1]
    B = G.new_zeros(G.shape[:-2] + (nd + len(pairs), nd * nbu))
    for a in range(nd):
        B[..., a, a::nd] = G[..., a, :]
    for r, (a, b) in enumerate(pairs):
        B[..., nd + r, a::nd] = G[..., b, :]
        B[..., nd + r, b::nd] = G[..., a, :]
    D = G.new_tensor([2.0] * nd + [1.0] * len(pairs))
    return B, D


class Saddle:
    """The Stokes saddle operator K of a mesh with viscosity eta_qp (nel,
    nqp) at the quadrature points, its Dirichlet rows bc_idx eliminated,
    applied element by element in float64 on `device`.

    Element matrices are formed per block of elements of one colour (no two
    share a dof, so each block's scatter adds once per dof and the sum is
    the same on every run), `block` elements at a time."""

    def __init__(self, fes, eta_qp, bc_idx, device, block=4096):
        mesh = self.mesh = fes.mesh
        self.device, self.block = torch.device(device), block
        nd, nbu = mesh.ndim, mesh.u_basis
        self.nud = nd * nbu
        f64 = dict(dtype=torch.float64, device=self.device)
        fac = fes.wq[None, :] * fes.detJ_u                  # (nel, nqp)
        self.fac = torch.as_tensor(np.ascontiguousarray(fac), **f64)
        self.facv = self.fac * torch.as_tensor(eta_qp, **f64)
        self.Np = torch.as_tensor(fes.Np, **f64)            # (nqp, npb)
        self.Nu = torch.as_tensor(fes.Nu, **f64)            # (nqp, nbu)
        self.shared = fes.shared
        G = fes.dNu_glob[:1] if fes.shared else fes.dNu_glob
        self.G = torch.as_tensor(np.array(G), **f64)
        if fes.shared:
            B, D = strain_rows(self.G[0], nd)              # (nqp, nc, nud)
            # per-qp A11 and A12 kernels, shared by every element
            self.K11 = torch.einsum("qsi,s,qsj->qij", B, D, B).reshape(
                fes.nqp, -1)
            self.K12 = -torch.einsum("qai,qj->qiaj", self.G[0],
                                     self.Np).reshape(fes.nqp, -1)
        self.dofs = torch.as_tensor(np.concatenate(
            [mesh.u_el_dofs, mesh.nu + mesh.p_el_nodes], axis=1),
            dtype=torch.int64, device=self.device)
        self.blocks = [torch.as_tensor(b, device=self.device)
                       for c in np.unique(mesh.el_colour)
                       for els in [np.nonzero(mesh.el_colour == c)[0]]
                       for b in np.array_split(
                           els, -(-len(els) // block))]
        self.bc_idx = torch.as_tensor(np.asarray(bc_idx, dtype=np.int64),
                                      device=self.device)
        self.mask = torch.zeros(mesh.ndof, **f64)
        self.mask[self.bc_idx] = 1.0
        self.keep = 1.0 - self.mask

    def load(self, Fu_qp, Fp_qp, bc_vals):
        """rhs_vector on the device: the assembled load (ndof,) of the body
        force Fu_qp (nel, nqp, nd) and pressure source Fp_qp (nel, nqp),
        the Dirichlet rows at bc_vals."""
        nel = self.mesh.nel
        f1 = torch.einsum("qi,eqa->eia", self.Nu,
                          self.fac[..., None] * Fu_qp).reshape(nel, -1)
        fe = torch.cat([f1, (self.fac * Fp_qp) @ self.Np], dim=1)
        F = torch.zeros(self.mesh.ndof, dtype=torch.float64,
                        device=self.device)
        for els in self.blocks:
            F.index_add_(0, self.dofs[els].reshape(-1), fe[els].reshape(-1))
        F[self.bc_idx] = torch.as_tensor(bc_vals, dtype=torch.float64,
                                         device=self.device)
        return F

    def element_matrices(self, els):
        """(len(els), nud + npb, nud + npb) element matrices."""
        nd, nud = self.mesh.ndim, self.nud
        npb = self.Np.shape[1]
        n = len(els)
        if self.shared:
            A11 = (self.facv[els] @ self.K11).reshape(n, nud, nud)
            A12 = (self.fac[els] @ self.K12).reshape(n, nud, npb)
        else:
            B, D = strain_rows(self.G[els], nd)            # (n, nqp, nc, nud)
            A11 = torch.einsum("eq,eqsi,s,eqsj->eij", self.facv[els], B, D,
                               B)
            A12 = -torch.einsum("eq,eqai,qj->eiaj", self.fac[els],
                                self.G[els], self.Np).reshape(n, nud, npb)
        K = A11.new_zeros(n, nud + npb, nud + npb)
        K[:, :nud, :nud] = A11
        K[:, :nud, nud:] = A12
        K[:, nud:, :nud] = A12.transpose(1, 2)
        return K

    def apply_raw(self, X):
        """K X for X (ndof, k) float64 on the device, no Dirichlet rows."""
        Y = torch.zeros_like(X)
        for els in self.blocks:
            d = self.dofs[els]                              # (n, ndofe)
            Ye = self.element_matrices(els) @ X[d]          # (n, ndofe, k)
            Y.index_add_(0, d.reshape(-1), Ye.reshape(-1, X.shape[1]))
        return Y

    def apply(self, X):
        """The eliminated operator: keep (K (keep X)) + mask X."""
        keep, mask = self.keep[:, None], self.mask[:, None]
        return keep * self.apply_raw(keep * X) + mask * X

    def rhs(self, F_raw):
        """The eliminated right-hand side of a load (ndof, k) whose Dirichlet
        rows hold their values: keep (F - K x_bc) + mask F."""
        keep, mask = self.keep[:, None], self.mask[:, None]
        return keep * (F_raw - self.apply_raw(mask * F_raw)) + mask * F_raw

    def rel_residuals(self, F_raw, X):
        """||F - A x|| / ||F|| per column, F eliminated from the loads F_raw
        (ndof, k) and A the eliminated operator, in float64."""
        F = self.rhs(F_raw)
        R = F - self.apply(X)
        return (torch.linalg.vector_norm(R, dim=0)
                / torch.linalg.vector_norm(F, dim=0))
