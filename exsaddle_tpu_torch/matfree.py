"""Matrix-free factored saddle operator in the parity layout, in PyTorch.

The port of exsaddle_tpu/matfree.py. On the uniform box meshes every element
shares its geometry, so the element stiffness factors as
A11[e] = Bs^T diag(s_e) Bs with one shared strain matrix Bs, and the
velocity-pressure couplings as Dm^T diag(fac) Np. The apply is

    y_u = A00 x_u  (K1: gather -> Bs -> scale -> Bs^T -> scatter)
        - scatter(((Np gather(x_p)) * fac) @ Dm)
    y_p = -scatter_q1(((Dm gather(x_u)) * fac) @ Np) [- Lame mass term]

with Dirichlet elimination y = keep * A(keep * x) + mask * x. The A00 term is
the hand-written kernel (kernels/a00.py) on CUDA tensors; the couplings stay
plain PyTorch in this slice.

Vectors are ONE contiguous flat tensor in parity-permuted dof order
[u parity classes | p natural]; per-class grids and the pressure grid are
views of it (to_tree). The JAX package kept pytrees of subgrids because flat
vectors paid TPU relayouts; a flat tensor with views costs nothing here.

The host half (factored_host, parity_permutation, the nnz models) is numpy,
copied from the JAX package so both build the same numbers.

MatFreeSaddleOperator is the same factored apply in the natural dof order
through the strided grid gathers of grid_ops; its A11 term computes K1's
function in plain PyTorch (on the TPU that term was XLA, not Pallas)."""

import itertools
from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from exsaddle_tpu_torch.grid_ops import (split_u_parity, gather_u_parity,
                                         scatter_u_parity, _gather_q1,
                                         _scatter_q1, _gather_q2, _scatter_q2)
from exsaddle_tpu_torch.kernels.a00 import a00_apply, node_gather_table

def _strain_matrix(G, nd, nbu):
    """Shared strain operator rows.

    G: (nqp, nd, nbu) global basis derivatives (element-independent).
    Returns (B (nqp*ncomp, nd*nbu), wc (ncomp,)) with engineering-strain
    rows: normal strains weight 2, shear strains weight 1 (the 2 eta / 1 eta
    split of MatAssemble_Saddle, femixedspace.c:2530-2560)."""
    nqp = G.shape[0]
    pairs = [(a, b) for a in range(nd) for b in range(a + 1, nd)]
    ncomp = nd + len(pairs)
    B = np.zeros((nqp, ncomp, nd * nbu))
    wc = np.zeros(ncomp)
    for a in range(nd):
        B[:, a, a::nd] = G[:, a, :]
        wc[a] = 2.0
    for r, (a, b) in enumerate(pairs):
        B[:, nd + r, a::nd] = G[:, b, :]
        B[:, nd + r, b::nd] = G[:, a, :]
        wc[nd + r] = 1.0
    return B.reshape(nqp * ncomp, nd * nbu), wc


def factored_host(mesh, fes, coeff_qp, lame=False):
    """Host-side (numpy float64) factored operator data for the uniform
    box mesh: the quantities every matrix-free apply AND the whole ABF
    setup derive from (A11[e] = Bs^T diag(scale[e]) Bs exactly).

    Returns dict with Bs (nqp*ncomp, nud), Dm (nqp, nud), Np (nqp, npb),
    fac (nqp,), scale (nel, nqp*ncomp) FLAT, facp_lam, wc (ncomp,)."""
    nd = mesh.ndim
    G = fes.dNu_glob
    # uniform-geometry check: an O(nel) corner-span test over EVERY
    # element plus full-derivative checks on sampled elements
    nel = mesh.nel
    xu = mesh.u_el_coords
    span = xu[:, -1] - xu[:, 0]
    smax = np.abs(span[0]).max() + 1e-300
    if np.abs(span - span[0]).max() > 1e-12 * smax:
        raise ValueError("matrix-free path requires uniform element geometry")
    samp = np.unique(np.linspace(0, nel - 1, 8).astype(np.int64))
    gmax = np.abs(G[0]).max()
    for e in samp:
        if np.abs(G[e] - G[0]).max() > 1e-12 * gmax:
            raise ValueError(
                "matrix-free path requires uniform element geometry")
    G0 = np.asarray(G[0])                          # (nqp, nd, nbu)
    detJ0 = float(fes.detJ_u[0, 0])
    Bs, wc = _strain_matrix(G0, nd, mesh.u_basis)
    fac = fes.wq * detJ0                           # (nqp,)
    # Dm[q, nd*i+a] = G0[q, a, i]
    Dm = np.zeros((fes.nqp, nd * mesh.u_basis))
    for a in range(nd):
        Dm[:, a::nd] = G0[:, a, :]

    visc = coeff_qp["mu"] if lame else coeff_qp["eta"]
    scale = (fac[None, :, None] * np.asarray(visc)[:, :, None]
             * wc[None, None, :])                  # (nel, nqp, ncomp)
    scale = np.ascontiguousarray(scale.reshape(nel, -1))

    if lame:
        facp = fes.wq[None, :] * fes.detJ_p
        facp_lam = facp / np.asarray(coeff_qp["lambda"])
    else:
        facp_lam = np.zeros((1, 1))
    return {"Bs": Bs, "Dm": Dm, "Np": np.asarray(fes.Np), "fac": fac,
            "scale": scale, "facp_lam": facp_lam, "wc": wc}


def _cast(a, dtype, device):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


@dataclass(frozen=True)
class MatFreeSaddleOperator:
    """Uniform-geometry factored saddle operator (Stokes or Lame) in the
    natural dof order, tensors on one device. Bs (nqp*ncomp, nud), Dm
    (nqp, nud), Np (nqp, npb), scale_visc (nel, nqp*ncomp), fac (nqp,),
    facp_lam ((nel, nqp) Lame, else (1, 1)), keep / bc_mask (ndof,)."""
    Bs: torch.Tensor
    Dm: torch.Tensor
    Np: torch.Tensor
    scale_visc: torch.Tensor
    fac: torch.Tensor
    facp_lam: torch.Tensor
    keep: torch.Tensor
    bc_mask: torch.Tensor
    m_el: tuple
    nn_u: tuple
    nn_p: tuple
    nu: int
    np_: int
    ncomp: int
    nqp: int

    @classmethod
    def build(cls, mesh, fes, coeff_qp, bc_mask, *, device, lame=False,
              dtype=torch.float32):
        """bc_mask: natural-order (ndof,) 0/1 Dirichlet mask."""
        fd = factored_host(mesh, fes, coeff_qp, lame=lame)
        bc_mask = np.asarray(bc_mask)
        return cls(
            Bs=_cast(fd["Bs"], dtype, device),
            Dm=_cast(fd["Dm"], dtype, device),
            Np=_cast(fd["Np"], dtype, device),
            scale_visc=_cast(fd["scale"], dtype, device),
            fac=_cast(fd["fac"], dtype, device),
            facp_lam=_cast(fd["facp_lam"], dtype, device),
            keep=_cast(1.0 - bc_mask, dtype, device),
            bc_mask=_cast(bc_mask, dtype, device), m_el=tuple(mesh.m_el),
            nn_u=tuple(mesh.nn_u), nn_p=tuple(mesh.nn_p), nu=mesh.nu,
            np_=mesh.np_, ncomp=len(fd["wc"]), nqp=fes.nqp)

    @property
    def ndof(self):
        return self.nu + self.np_

    @property
    def lame(self):
        return self.facp_lam.shape[0] > 1

    def mult(self, x):
        """y = A x, both in the natural dof order."""
        nd = len(self.m_el)
        xk = self.keep * x
        x_grid = xk[: self.nu].view(tuple(reversed(self.nn_u)) + (nd,))
        p_grid = xk[self.nu:].view(tuple(reversed(self.nn_p)))
        xe = _gather_q2(x_grid, self.m_el)            # (nel, nud)
        pe = _gather_q1(p_grid, self.m_el)            # (nel, npb)

        # A11: strain -> viscosity scale -> strain^T
        yue = ((xe @ self.Bs.T) * self.scale_visc) @ self.Bs
        # A12 / A21: divergence coupling, weight -w detJ
        ptmp = pe @ self.Np.T                         # (nel, nqp)
        yue = yue - (ptmp * self.fac[None, :]) @ self.Dm
        div = xe @ self.Dm.T                          # (nel, nqp)
        ype = -(div * self.fac[None, :]) @ self.Np
        if self.lame:                                 # A22 = -1/lambda mass
            ype = ype - (ptmp * self.facp_lam) @ self.Np

        yu = _scatter_q2(yue, self.m_el, self.nn_u, nd).reshape(-1)
        yp = _scatter_q1(ype, self.m_el, self.nn_p).reshape(-1)
        return self.keep * torch.cat([yu, yp]) + self.bc_mask * x


def _s_q2q2(m):
    """1D Q2 grid, 2m+1 nodes: sum of per-node neighbour counts."""
    tot = 0
    for i in range(2 * m + 1):
        if i % 2 == 0:
            lo = max(i - 2, 0)
            hi = min(i + 2, 2 * m)
        else:
            lo = i - 1
            hi = i + 1
        tot += hi - lo + 1
    return tot


def _s_q2q1(m):
    tot = 0
    for i in range(2 * m + 1):
        e0 = max(i // 2 - (1 if i % 2 == 0 else 0), 0)
        e1 = min(i // 2, m - 1)
        tot += (e1 - e0 + 1) + 1
    return tot


def _s_q1q1(m):
    tot = 0
    for i in range(m + 1):
        tot += min(i + 1, m) - max(i - 1, 0) + 1
    return tot


def assembled_nnz(mesh):
    """Exact nonzero count of the assembled saddle matrix (the cost model
    an explicit SpMV would pay). Tensor-product structure: the neighbor
    count of a grid node is the product of per-dimension 1D neighbor
    counts, so total pairs = product of 1D pair sums."""
    d = mesh.ndim
    nnz_uu = d * d * int(np.prod([_s_q2q2(m) for m in mesh.m_el]))
    nnz_up = d * int(np.prod([_s_q2q1(m) for m in mesh.m_el]))
    nnz_pp = int(np.prod([_s_q1q1(m) for m in mesh.m_el]))
    return nnz_uu + 2 * nnz_up + nnz_pp


def coupling_nnz(mesh):
    """Nonzeros of one velocity-pressure coupling block (A10 = A01^T)."""
    return mesh.ndim * int(np.prod([_s_q2q1(m) for m in mesh.m_el]))


def allocated_nnz(mesh):
    """The reference's PREALLOCATED nonzero count for the saddle matrix
    (SaddlePreallocation_SEQ, femixedspace.c:181-286): per-row estimates by
    Q2 node parity class using UNCLIPPED interior stencil spans (5 nodes per
    even direction, 3 per odd for velocity; 3/2 for pressure coupling), and
    the full interior span for every pressure row. Reproduces e.g.
    'allocated nonzeros=1585590' for mx=6 3D and 542628 for mx=4 3D."""
    d = mesh.ndim
    total = 0
    # velocity rows: d dofs per Q2 node
    for parity in itertools.product((0, 1), repeat=d):
        nnodes = 1
        span_u = 1
        span_p = 1
        for m, par in zip(mesh.m_el, parity):
            nnodes *= (m + 1) if par == 0 else m
            span_u *= 5 if par == 0 else 3
            span_p *= 3 if par == 0 else 2
        total += d * nnodes * (d * span_u + span_p)
    # pressure rows: full interior span
    total += mesh.n_p_nodes * (d * 5 ** d + 3 ** d)
    return total


def _parity_classes(nn):
    """Per-class node index grids for a structured grid with nn nodes/dim.
    Returns list over class p of int64 arrays of node linear indices with
    shape (*rev(cls_nn)), plus the class shapes."""
    nd = len(nn)
    classes = []
    shapes = []
    for p in range(2 ** nd):
        ax = [np.arange((p >> a) & 1, nn[a], 2) for a in range(nd)]
        if nd == 2:
            jj, ii = np.meshgrid(ax[1], ax[0], indexing="ij")
            lin = ii + jj * nn[0]
        else:
            kk, jj, ii = np.meshgrid(ax[2], ax[1], ax[0], indexing="ij")
            lin = ii + jj * nn[0] + kk * nn[0] * nn[1]
        classes.append(lin.astype(np.int64))
        shapes.append(lin.shape)
    return classes, shapes


def parity_permutation(mesh):
    """Dof permutation: natural order -> [u parity classes | p natural].
    Returns (perm, iperm) with x_parity = x_natural[perm]."""
    nd = mesh.ndim
    classes, _ = _parity_classes(mesh.nn_u)
    u_nodes = np.concatenate([c.ravel() for c in classes])
    u_dofs = (nd * u_nodes[:, None] + np.arange(nd)[None, :]).ravel()
    perm = np.concatenate([u_dofs, mesh.nu + np.arange(mesh.np_)])
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(perm.size)
    return perm, iperm


@dataclass(frozen=True)
class ParityMatFreeOperator:
    """Factored saddle operator data on one device, parity-permuted dofs.

    Bs (nqp*ncomp, nud), Dm (nqp, nud), Np (nqp, npb), scale_visc
    (nel, nqp*ncomp), fac (nqp,), facp_lam ((nel, nqp) Lame, else (1, 1)),
    keep / bc_mask (ndof,) permuted."""
    Bs: torch.Tensor
    Dm: torch.Tensor
    Np: torch.Tensor
    scale_visc: torch.Tensor
    fac: torch.Tensor
    facp_lam: torch.Tensor
    keep: torch.Tensor
    bc_mask: torch.Tensor
    m_el: tuple
    nn_u: tuple
    nn_p: tuple
    nu: int
    np_: int
    ncomp: int
    nqp: int
    cls_shapes: tuple

    @classmethod
    def build(cls, mesh, fes, coeff_qp, bc_mask, *, device, lame=False,
              dtype=torch.float32, host=None):
        """bc_mask: natural-order (ndof,) 0/1 Dirichlet mask. host: optional
        precomputed factored_host() dict (reused across dtypes)."""
        fd = host if host is not None else factored_host(
            mesh, fes, coeff_qp, lame=lame)
        return cls.from_arrays(fd["Bs"], fd["Dm"], fd["Np"], fd["scale"],
                               fd["fac"], fd["facp_lam"],
                               1.0 - np.asarray(bc_mask),
                               np.asarray(bc_mask), mesh, dtype=dtype,
                               device=device)

    @classmethod
    def from_matfree(cls, mf, mesh):
        """Permute an existing MatFreeSaddleOperator into the parity layout
        on its device (keeps its dtype)."""
        perm, _ = parity_permutation(mesh)
        _, shapes = _parity_classes(mesh.nn_u)
        perm_t = torch.as_tensor(perm, device=mf.keep.device)
        return cls(Bs=mf.Bs, Dm=mf.Dm, Np=mf.Np, scale_visc=mf.scale_visc,
                   fac=mf.fac, facp_lam=mf.facp_lam, keep=mf.keep[perm_t],
                   bc_mask=mf.bc_mask[perm_t], m_el=mf.m_el, nn_u=mf.nn_u,
                   nn_p=mf.nn_p, nu=mf.nu, np_=mf.np_, ncomp=mf.ncomp,
                   nqp=mf.nqp, cls_shapes=tuple(tuple(s) for s in shapes))

    @classmethod
    def from_arrays(cls, Bs, Dm, Np, scale, fac, facp_lam, keep, bc_mask,
                    mesh, *, dtype, device, permuted=False):
        """Cast host arrays to `dtype` on `device`; keep/bc_mask are natural
        order unless `permuted`."""
        perm, _ = parity_permutation(mesh)
        _, shapes = _parity_classes(mesh.nn_u)

        def cast(a):
            return _cast(a, dtype, device)
        keep = np.asarray(keep)
        bc_mask = np.asarray(bc_mask)
        if not permuted:
            keep, bc_mask = keep[perm], bc_mask[perm]
        return cls(Bs=cast(Bs), Dm=cast(Dm), Np=cast(Np),
                   scale_visc=cast(scale), fac=cast(fac),
                   facp_lam=cast(facp_lam), keep=cast(keep),
                   bc_mask=cast(bc_mask), m_el=tuple(mesh.m_el),
                   nn_u=tuple(mesh.nn_u), nn_p=tuple(mesh.nn_p),
                   nu=mesh.nu, np_=mesh.np_, ncomp=Bs.shape[0] // Dm.shape[0],
                   nqp=Dm.shape[0],
                   cls_shapes=tuple(tuple(s) for s in shapes))

    @property
    def ndim(self):
        return len(self.m_el)

    @property
    def lame(self):
        return self.facp_lam.shape[0] > 1

    @property
    def p_shape(self):
        return tuple(reversed(self.nn_p))

    @cached_property
    def node_table(self):
        """K1's node gather table (kernels/a00.py:node_gather_table) on this
        operator's device, built at its first CUDA apply."""
        return torch.as_tensor(node_gather_table(self.m_el),
                               device=self.Bs.device)

    @property
    def ndof(self):
        return self.nu + self.np_

    def split_u(self, xu):
        """Flat u vector -> list of per-class grid views."""
        return split_u_parity(xu, self.cls_shapes, self.ndim)

    def mult(self, x):
        """y = A x, both flat in the parity-permuted layout: mult_tree, so
        the u-u term is K1 on CUDA."""
        return mult_tree(self, tree_aux(self), x)

    def diagonal(self):
        """The assembled matrix diagonal in the parity layout (for
        PCJACOBI): the element diagonals of Bs^T diag(s_e) Bs (and of the
        Lame mass term) summed per dof, BC rows 1."""
        ks, ms, kp, mp = tree_aux(self)
        du = scatter_u_parity(self.scale_visc @ self.Bs ** 2, self.m_el,
                              self.cls_shapes)
        dp = torch.zeros(self.p_shape, dtype=du.dtype, device=du.device)
        if self.lame:
            dp = _scatter_q1(-(self.facp_lam @ self.Np ** 2), self.m_el,
                             self.nn_p)
        return torch.cat([du * ks + ms, (dp * kp + mp).reshape(-1)])


def tree_aux(op):
    """(keep_u, mask_u, keep_p grid, mask_p grid) for the block applies:
    velocity parts flat (nu,), pressure parts (*rev(nn_p)) views."""
    ks = op.keep[: op.nu]
    ms = op.bc_mask[: op.nu]
    kp = op.keep[op.nu:].view(op.p_shape)
    mp = op.bc_mask[op.nu:].view(op.p_shape)
    return (ks, ms, kp, mp)


def to_tree(op, x):
    """Flat parity-layout vector -> (list of u-class grid views, p grid
    view): the JAX package's tree structure, sharing x's storage."""
    return (op.split_u(x[: op.nu]), x[op.nu:].view(op.p_shape))


def from_tree(tree):
    subs, pg = tree
    return torch.cat([s.reshape(-1) for s in subs] + [pg.reshape(-1)])


def tree_dot(a, b):
    """Dot product of two flat parity-layout vectors (the port's tree form;
    a device scalar, no host read)."""
    return torch.dot(a, b)


def tree_norm(a):
    return torch.linalg.vector_norm(a)


def mult_tree(op, aux, x):
    """y = A x for the flat parity-layout vector x (ndof,); returns a new
    flat vector. The u-u term is K1 (kernels/a00.py)."""
    ks, ms, kp, mp = aux
    xu = x[: op.nu]
    pg = x[op.nu:].view(op.p_shape)
    xk = xu * ks
    pe = _gather_q1(pg * kp, op.m_el)
    ptmp = pe @ op.Np.T
    xe = gather_u_parity(op.split_u(xk), op.m_el)
    div = xe @ op.Dm.T
    ype = -(div * op.fac[None, :]) @ op.Np
    if op.lame:
        ype = ype - (ptmp * op.facp_lam) @ op.Np
    yu = a00_apply(op, xk)
    yu += scatter_u_parity(-((ptmp * op.fac[None, :]) @ op.Dm), op.m_el,
                           op.cls_shapes)
    yp = _scatter_q1(ype, op.m_el, op.nn_p)
    y = torch.empty_like(x)
    y[: op.nu] = yu * ks + ms * xu
    y[op.nu:] = (yp * kp + mp * pg).reshape(-1)
    return y
