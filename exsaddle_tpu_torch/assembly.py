"""Element-batched FE setup for the Q2-Q1 saddle system (host, numpy).

A copy of exsaddle_tpu/assembly.py for the PyTorch port, which cannot import
the JAX package: the FE space, right-hand side, Schur-pre element blocks and
the coefficient projection pipeline of the reference's VecAssemble_F1_qp /
VecAssemble_F2_qp / MatAssemble_Schur (femixedspace.c:2306-2948). The element
stiffness batch is not needed: the port's operator is the factored
matrix-free form of matfree.py.

Weak forms (femixedspace.c:2487-2610):
  A11 = sum_q w_q detJ_q eta_q B^T D B,  D = diag(2,2,[2],1,[1,1])
  A12 = -sum_q w_q detJ_q  grad(N_u) N_p   (pressure gradient, by component)
  A21 = A12^T
  A22 = -sum_q w_q detJ_q (1/lambda) N_p N_p        (Lame only)
  S   = -sum_q w_q detJ_q (1/eta) N_p N_p           (Schur pre, Stokes)
      = -sum_q w_q detJ_q (1/lambda + 1/mu) N_p N_p (Schur pre, Lame)
  F1  = sum_q w_q detJ_q N_u Fu ;  F2 = sum_q w_q detJ_q N_p Fp
"""

import numpy as np

from exsaddle_tpu_torch import basis, quadrature


class FESpace:
    """Precomputed basis/quadrature tables + per-element geometry for a mesh.

    The analogue of the reference's FEMixedSpace + quadrature setup
    (femixedspace.h:30-56), with geometry evaluated isoparametrically per
    element/quadrature point as in EvaluateBasisDerivGlobal
    (femixedspace.c:1615-1723).

    NOTE (ADVICE r4): on uniform box meshes with > 4096 elements,
    `detJ_u` / `dNu_glob` / `detJ_p` / `dNp_glob` are READ-ONLY
    zero-stride `np.broadcast_to` views (every element shares the
    geometry of element 0). Consumers that mutate per-element geometry or
    require writable/contiguous batches must `np.ascontiguousarray` them
    first; the <= 4096-element path returns real writable batches.
    """

    def __init__(self, mesh):
        self.mesh = mesh
        nd = mesh.ndim
        self.qp, self.wq = quadrature.gauss_tensor(nd)      # (nqp, d), (nqp,)
        self.nqp = len(self.wq)
        self.Nu, self.dNu = basis.tabulate_q2(self.qp)      # (nqp,nb),(nqp,d,nb)
        self.Np, self.dNp = basis.tabulate_q1(self.qp)

        xu = mesh.u_el_coords                                # (nel, nbu, d)
        xp = mesh.p_el_coords
        nel = mesh.nel
        if nel > 4096 and self._translate_congruent(xu):
            # Uniform box mesh (DMDASetUniformCoordinates_Saddle,
            # femixedspace.c:1353-1363): every element is a translate of
            # element 0, so the isoparametric geometry is computed ONCE
            # and broadcast -- the per-element (nel, nqp, d, d) Jacobian
            # batch + inverses cost ~10 s at mx=32 for identical values.
            # Gated to large meshes: the single-element einsum differs
            # from the batched one by ~1 ulp, enough to flip MC64/drop
            # decisions in the droptol-factorization regressions (which
            # all run small meshes).
            J0 = np.einsum("qai,ib->qab", self.dNu, xu[0])
            detJ0 = np.linalg.det(J0)                        # (nqp,)
            G0 = np.einsum("qab,qbi->qai", np.linalg.inv(J0), self.dNu)
            self.detJ_u = np.broadcast_to(detJ0, (nel, self.nqp))
            self.dNu_glob = np.broadcast_to(
                G0, (nel, self.nqp, nd, mesh.u_basis))
            Jp0 = np.einsum("qai,ib->qab", self.dNp, xp[0])
            detJp0 = np.linalg.det(Jp0)
            Gp0 = np.einsum("qab,qbi->qai", np.linalg.inv(Jp0), self.dNp)
            self.detJ_p = np.broadcast_to(detJp0, (nel, self.nqp))
            self.dNp_glob = np.broadcast_to(
                Gp0, (nel, self.nqp, nd, mesh.p_basis))
            # qp physical coordinates stay the exact per-element basis sum
            # (femixedspace.c:1902-1915): a translated-pattern shortcut
            # differs by ~1 ulp, which is enough to flip quadrature points
            # sitting on discontinuous-coefficient interfaces (sinker
            # indicator functions) to the other side
            self.qp_coords = np.einsum("qi,eid->eqd", self.Nu, xu)
            return

        # Isoparametric geometry on the Q2 (velocity) element.
        # J[e,q,a,b] = sum_i dNu[q,a,i] * x[e,i,b]
        J = np.einsum("qai,eib->eqab", self.dNu, xu)
        self.detJ_u = np.linalg.det(J)                       # (nel, nqp)
        Jinv = np.linalg.inv(J)                              # (nel,nqp,d,d)
        # global derivatives: GN[e,q,a,i] = Jinv[e,q,a,b] dNu[q,b,i]
        self.dNu_glob = np.einsum("eqab,qbi->eqai", Jinv, self.dNu)

        # Geometry on the Q1 (pressure) element (used for A22/Schur,
        # femixedspace.c:2597-2599, 2920-2922).
        Jp = np.einsum("qai,eib->eqab", self.dNp, xp)
        self.detJ_p = np.linalg.det(Jp)
        Jp_inv = np.linalg.inv(Jp)
        self.dNp_glob = np.einsum("eqab,qbi->eqai", Jp_inv, self.dNp)

        # Quadrature-point physical coordinates via the Q2 map
        # (femixedspace.c:1902-1915).
        self.qp_coords = np.einsum("qi,eid->eqd", self.Nu, xu)  # (nel,nqp,d)

    @staticmethod
    def _translate_congruent(xu):
        """True when every element is a translate of element 0 (uniform
        box mesh): an O(nel) corner-span test over the FULL batch (catches
        graded meshes) plus full node-pattern checks on sampled elements
        (interior Q2 nodes are midpoints of the span by construction)."""
        nel = xu.shape[0]
        span = xu[:, -1] - xu[:, 0]
        scale = np.abs(span[0]).max() + 1e-300
        if np.abs(span - span[0]).max() > 1e-12 * scale:
            return False
        rel0 = xu[0] - xu[0, 0]
        samp = np.unique(np.linspace(0, nel - 1, 8).astype(np.int64))
        return all(np.abs((xu[e] - xu[e, 0]) - rel0).max() <= 1e-12 * scale
                   for e in samp)


def assemble_rhs(fes, Fu_qp, Fp_qp):
    """RHS element vectors (VecAssemble_F1_qp/F2_qp, femixedspace.c:2650-2786).

    Fu_qp: (nel, nqp, ndim), Fp_qp: (nel, nqp).
    Returns (f1el (nel, nud), f2el (nel, npb)).
    """
    mesh = fes.mesh
    nd = mesh.ndim
    fac = fes.wq[None, :] * fes.detJ_u
    f1 = np.einsum("eq,qi,eqa->eia", fac, fes.Nu, Fu_qp)
    f1 = f1.reshape(mesh.nel, nd * mesh.u_basis)
    f2 = np.einsum("eq,qj,eq->ej", fac, fes.Np, Fp_qp)
    return f1, f2


def assemble_schur_pre(fes, coeff_qp, lame=False):
    """Viscosity-scaled pressure mass matrix element blocks
    (MatAssemble_Schur, femixedspace.c:2837-2948). Returns (nel, npb, npb)."""
    if lame:
        inv = 1.0 / coeff_qp["lambda"] + 1.0 / coeff_qp["mu"]
    else:
        inv = 1.0 / coeff_qp["eta"]
    facp = fes.wq[None, :] * fes.detJ_p
    return -np.einsum("eq,qi,qj->eij", facp * inv, fes.Np, fes.Np)


def scatter_vector(mesh, f1el, f2el):
    """Scatter element RHS vectors into a global (ndof,) vector."""
    F = np.zeros(mesh.ndof)
    np.add.at(F, mesh.u_el_dofs.ravel(), f1el.ravel())
    np.add.at(F[mesh.nu:], mesh.p_el_nodes.ravel(), f2el.ravel())
    return F


# --------------------------------------------------------------------------
# Coefficient pipeline: qp evaluation -> Q1 projection -> interpolation back
# to qp -> restriction chain over MG levels
# (FEMixedSpaceDefineQPwiseProperties[_Q1Projection],
#  femixedspace.c:1857-2266).
# --------------------------------------------------------------------------

def project_qp_to_q1(fes, fields_qp):
    """Lumped L2-style projection of qp fields onto Q1 nodes
    (femixedspace.c:1976-2018).

    fields_qp: (nel, nqp, nf). Returns nodal (n_p_nodes, nf)."""
    mesh = fes.mesh
    contrib = np.einsum("qi,eqf->eif", fes.Np, fields_qp)
    scale_el = np.tile(fes.Np.sum(axis=0), (mesh.nel, 1))
    nf = fields_qp.shape[-1]
    nodal = np.zeros((mesh.n_p_nodes, nf))
    scale = np.zeros(mesh.n_p_nodes)
    np.add.at(nodal, mesh.p_el_nodes.ravel(),
              contrib.reshape(-1, nf))
    np.add.at(scale, mesh.p_el_nodes.ravel(), scale_el.ravel())
    return nodal / scale[:, None]


def interp_q1_to_qp(fes, nodal):
    """Interpolate Q1 nodal fields to quadrature points
    (femixedspace.c:2036-2083). nodal: (n_p_nodes, nf) ->
    (nel, nqp, nf)."""
    el = nodal[fes.mesh.p_el_nodes]              # (nel, npb, nf)
    return np.einsum("qi,eif->eqf", fes.Np, el)
