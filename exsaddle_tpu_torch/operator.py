"""Element-batched saddle-point operator with symmetric Dirichlet elimination
(the torch port of exsaddle_tpu/operator.py).

The operator is stored as per-element dense blocks on one device; y = A x is

    gather x -> batched (nel, ndof_el, ndof_el) matmuls -> scatter-add

Dirichlet elimination (MatZeroRowsColumns with diag=1.0) is applied to the
element blocks at setup: rows+columns of constrained dofs are zeroed in every
element block and an identity contribution is added at apply time. The
non-zero-Dirichlet RHS correction rhs_diri = -A_raw x_bc (femixedspace.c:
2634-2643) is computed from the raw blocks before masking.

Deterministic scatter: elements are stored sorted by colour (ex&1, ey&1[,
ez&1]), 8 colours in 3D and 4 in 2D. Elements of one colour share no Q2 and
no Q1 node, so each colour's index_add_ sees every index at most once and
the sum does not depend on the order in which a CUDA device runs its atomics:
repeated applies are bitwise equal. The host conversions (to_dense, to_csr)
undo the colour order, so they sum duplicates in element order as the JAX
package does.
"""

from dataclasses import dataclass

import numpy as np
import torch


def element_colours(m_el):
    """(order, bounds): element indices sorted by colour (ex&1) + 2 (ey&1)
    [+ 4 (ez&1)], element x fastest, and the [start, end) range of each
    non-empty colour in that order."""
    nel = int(np.prod(m_el))
    e = np.arange(nel)
    colour = np.zeros(nel, dtype=np.int64)
    stride = 1
    for d, m in enumerate(m_el):
        colour += (((e // stride) % m) & 1) << d
        stride *= m
    order = np.argsort(colour, kind="stable")
    counts = np.bincount(colour, minlength=2 ** len(m_el))
    ends = np.cumsum(counts)
    bounds = tuple((int(e0 - c), int(e0)) for c, e0 in zip(counts, ends)
                   if c > 0)
    return order, bounds


def _bmv(A, x):
    """Batched matrix-vector product: (nel, m, n) x (nel, n) -> (nel, m)."""
    return torch.bmm(A, x.unsqueeze(2)).squeeze(2)


def _scatter_into(y, idx, vals, bounds):
    """y[idx] += vals, one colour at a time (unique indices per colour)."""
    for s, e in bounds:
        y.index_add_(0, idx[s:e].reshape(-1), vals[s:e].reshape(-1))
    return y


def _to_device(a, order_t, device):
    """Element batch (element order, numpy) -> colour-ordered tensor."""
    return torch.as_tensor(np.ascontiguousarray(a), device=device)[order_t]


@dataclass(frozen=True)
class SaddleOperator:
    """Masked element-block saddle operator.

    A11: (nel, nud, nud); A12: (nel, nud, npb); A21: (nel, npb, nud);
    A22: (nel, npb, npb) (zeros for Stokes); elements in colour order.
    bc_mask: (ndof,) 1.0 at constrained dofs else 0.0 (pressure rows never
    constrained). order: numpy array, order[k] is the original index of
    stored element k; bounds: the colour ranges (element_colours)."""
    A11: torch.Tensor
    A12: torch.Tensor
    A21: torch.Tensor
    A22: torch.Tensor
    u_el_dofs: torch.Tensor
    p_el_nodes: torch.Tensor
    bc_mask: torch.Tensor
    nu: int
    np_: int
    order: np.ndarray
    bounds: tuple

    @property
    def ndof(self):
        return self.nu + self.np_

    @property
    def device(self):
        return self.A11.device

    def mult(self, x):
        """y = A x (matrix-free element apply)."""
        xu = x[: self.nu]
        xp = x[self.nu:]
        xue = xu[self.u_el_dofs]                     # (nel, nud)
        xpe = xp[self.p_el_nodes]                    # (nel, npb)
        yue = _bmv(self.A11, xue) + _bmv(self.A12, xpe)
        ype = _bmv(self.A21, xue) + _bmv(self.A22, xpe)
        y = torch.zeros_like(x)
        _scatter_into(y, self.u_el_dofs, yue, self.bounds)
        _scatter_into(y[self.nu:], self.p_el_nodes, ype, self.bounds)
        return y + self.bc_mask * x                  # unit diagonal on BC rows

    # --- block applies (for PCFIELDSPLIT sub-solves; the blocks of the
    # BC-eliminated matrix, as PETSc's MatCreateSubMatrix would extract) ----
    def mult_u(self, xu):
        """A00 xu (velocity block, unit diagonal on BC rows)."""
        yue = _bmv(self.A11, xu[self.u_el_dofs])
        yu = _scatter_into(torch.zeros_like(xu), self.u_el_dofs, yue,
                           self.bounds)
        return yu + self.bc_mask[: self.nu] * xu

    def mult_up(self, xp):
        """A01 xp (gradient block, BC rows zeroed)."""
        yue = _bmv(self.A12, xp[self.p_el_nodes])
        return _scatter_into(xp.new_zeros(self.nu), self.u_el_dofs, yue,
                             self.bounds)

    def mult_pu(self, xu):
        """A10 xu (divergence block, BC columns zeroed)."""
        ype = _bmv(self.A21, xu[self.u_el_dofs])
        return _scatter_into(xu.new_zeros(self.np_), self.p_el_nodes, ype,
                             self.bounds)

    def mult_p(self, xp):
        """A11 (pressure-pressure) block: zero for Stokes, -1/lambda mass for
        Lame."""
        ype = _bmv(self.A22, xp[self.p_el_nodes])
        return _scatter_into(torch.zeros_like(xp), self.p_el_nodes, ype,
                             self.bounds)

    def diagonal(self):
        """Assembled matrix diagonal (for PCJACOBI)."""
        d11 = self.A11.diagonal(dim1=1, dim2=2)
        d22 = self.A22.diagonal(dim1=1, dim2=2)
        d = torch.zeros_like(self.bc_mask)
        _scatter_into(d, self.u_el_dofs, d11, self.bounds)
        _scatter_into(d[self.nu:], self.p_el_nodes, d22, self.bounds)
        return d + self.bc_mask

    # --- host-side conversions (setup path) -------------------------------
    def _host(self, t):
        """A colour-ordered element tensor as numpy, in element order."""
        a = t.cpu().numpy()
        out = np.empty_like(a)
        out[self.order] = a
        return out

    def to_dense(self):
        """Assembled dense (ndof, ndof) numpy array (setup/debug only)."""
        n = self.ndof
        A = np.zeros((n, n))
        ue = self._host(self.u_el_dofs)
        pe = self._host(self.p_el_nodes) + self.nu
        A11 = self._host(self.A11)
        A12 = self._host(self.A12)
        A21 = self._host(self.A21)
        A22 = self._host(self.A22)
        for e in range(ue.shape[0]):
            A[np.ix_(ue[e], ue[e])] += A11[e]
            A[np.ix_(ue[e], pe[e])] += A12[e]
            A[np.ix_(pe[e], ue[e])] += A21[e]
            A[np.ix_(pe[e], pe[e])] += A22[e]
        A[np.arange(n), np.arange(n)] += self.bc_mask.cpu().numpy()
        return A

    def to_csr(self):
        """Assembled scipy CSR (setup path for ILU/orderings)."""
        import scipy.sparse as sp
        ue = self._host(self.u_el_dofs)
        pe = self._host(self.p_el_nodes) + self.nu
        rows = []
        cols = []
        vals = []

        def add(r, c, v):
            rows.append(np.broadcast_to(r[:, :, None], v.shape).ravel())
            cols.append(np.broadcast_to(c[:, None, :], v.shape).ravel())
            vals.append(v.ravel())

        add(ue, ue, self._host(self.A11))
        add(ue, pe, self._host(self.A12))
        add(pe, ue, self._host(self.A21))
        add(pe, pe, self._host(self.A22))
        n = self.ndof
        rows.append(np.arange(n))
        cols.append(np.arange(n))
        vals.append(self.bc_mask.cpu().numpy())
        A = sp.coo_matrix((np.concatenate(vals),
                           (np.concatenate(rows), np.concatenate(cols))),
                          shape=(n, n)).tocsr()
        A.sum_duplicates()
        return A


def apply_dirichlet_elimination(mesh, elmats, bc_idx, bc_vals, device):
    """Build a masked SaddleOperator on `device` + rhs_diri from raw element
    matrices.

    Mirrors MatAssemble_Saddle's BC handling (femixedspace.c:2634-2645):
      rhs_diri = -(A_raw x_bc) with BC rows zeroed;
      A <- zero BC rows+cols, 1.0 on BC diagonal.

    Returns (op, rhs_diri (ndof,), bc_mask (ndof,), x_bc (ndof,)); the last
    three are numpy.
    """
    nu, np_ = mesh.nu, mesh.np_
    bc_mask_u = np.zeros(nu)
    bc_mask_u[bc_idx] = 1.0
    x_bc_u = np.zeros(nu)
    x_bc_u[bc_idx] = bc_vals

    A11 = np.asarray(elmats["A11"])
    A12 = np.asarray(elmats["A12"])
    A22 = elmats["A22"]
    if A22 is None:
        A22 = np.zeros((mesh.nel, mesh.p_basis, mesh.p_basis))
    else:
        A22 = np.asarray(A22)
    A21 = np.transpose(A12, (0, 2, 1)).copy()

    # rhs_diri = -(A_raw x_bc); x_bc is zero at pressure dofs.
    xbe = x_bc_u[mesh.u_el_dofs]
    yue = np.einsum("eij,ej->ei", A11, xbe)
    ype = np.einsum("eij,ej->ei", A21, xbe)
    rhs = np.zeros(mesh.ndof)
    np.add.at(rhs, mesh.u_el_dofs.ravel(), yue.ravel())
    np.add.at(rhs[nu:], mesh.p_el_nodes.ravel(), ype.ravel())
    rhs = -rhs
    rhs[:nu][bc_idx] = 0.0   # zero BC rows of the correction

    # mask element blocks (in-place second factor: the chained broadcast
    # materializes a second full-size temporary with strided access)
    keep = 1.0 - bc_mask_u[mesh.u_el_dofs]          # (nel, nud)
    A11m = A11 * keep[:, :, None]
    A11m *= keep[:, None, :]
    A12m = A12 * keep[:, :, None]
    A21m = A21 * keep[:, None, :]

    bc_mask = np.concatenate([bc_mask_u, np.zeros(np_)])
    order, bounds = element_colours(mesh.m_el)
    order_t = torch.as_tensor(order, device=device)
    op = SaddleOperator(
        A11=_to_device(A11m, order_t, device),
        A12=_to_device(A12m, order_t, device),
        A21=_to_device(A21m, order_t, device),
        A22=_to_device(A22, order_t, device),
        u_el_dofs=_to_device(mesh.u_el_dofs.astype(np.int64), order_t,
                             device),
        p_el_nodes=_to_device(mesh.p_el_nodes.astype(np.int64), order_t,
                              device),
        bc_mask=torch.as_tensor(bc_mask, device=device),
        nu=nu, np_=np_, order=order, bounds=bounds)
    x_bc = np.concatenate([x_bc_u, np.zeros(np_)])
    return op, rhs, bc_mask, x_bc


@dataclass(frozen=True)
class PressureOperator:
    """Element-block operator on the pressure (Q1) space -- the scaled mass
    matrix Mpscaled used as the user Schur preconditioner matrix
    (exSaddle.c:315-318). Elements in colour order, as SaddleOperator."""
    S: torch.Tensor            # (nel, npb, npb)
    p_el_nodes: torch.Tensor
    n: int
    order: np.ndarray
    bounds: tuple

    @classmethod
    def build(cls, mesh, Sel, device):
        """From numpy element blocks Sel (nel, npb, npb) in element order."""
        order, bounds = element_colours(mesh.m_el)
        order_t = torch.as_tensor(order, device=device)
        return cls(S=_to_device(Sel, order_t, device),
                   p_el_nodes=_to_device(mesh.p_el_nodes.astype(np.int64),
                                         order_t, device),
                   n=mesh.np_, order=order, bounds=bounds)

    def mult(self, x):
        ye = _bmv(self.S, x[self.p_el_nodes])
        return _scatter_into(torch.zeros_like(x), self.p_el_nodes, ye,
                             self.bounds)

    def diagonal(self):
        d = self.S.diagonal(dim1=1, dim2=2)
        return _scatter_into(d.new_zeros(self.n), self.p_el_nodes, d,
                             self.bounds)

    def to_csr(self):
        import scipy.sparse as sp
        pe = np.empty(tuple(self.p_el_nodes.shape), dtype=np.int64)
        pe[self.order] = self.p_el_nodes.cpu().numpy()
        S = np.empty(tuple(self.S.shape))
        S[self.order] = self.S.cpu().numpy()
        rows = np.broadcast_to(pe[:, :, None], S.shape).ravel()
        cols = np.broadcast_to(pe[:, None, :], S.shape).ravel()
        A = sp.coo_matrix((S.ravel(), (rows, cols)),
                          shape=(self.n, self.n)).tocsr()
        A.sum_duplicates()
        return A

    def to_dense(self):
        return self.to_csr().toarray()
