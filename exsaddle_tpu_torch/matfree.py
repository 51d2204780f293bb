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

The host half (factored_host, parity_permutation) is numpy, copied from the
JAX package so both build the same numbers."""

from dataclasses import dataclass

import numpy as np
import torch

from exsaddle_tpu_torch.grid_ops import (split_u_parity, gather_u_parity,
                                         scatter_u_parity, _gather_q1,
                                         _scatter_q1)
from exsaddle_tpu_torch.kernels.a00 import a00_apply

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
    def from_arrays(cls, Bs, Dm, Np, scale, fac, facp_lam, keep, bc_mask,
                    mesh, *, dtype, device, permuted=False):
        """Cast host arrays to `dtype` on `device`; keep/bc_mask are natural
        order unless `permuted`."""
        perm, _ = parity_permutation(mesh)
        _, shapes = _parity_classes(mesh.nn_u)

        def cast(a):
            return torch.as_tensor(np.array(a), dtype=dtype,
                                   device=device)
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

    def split_u(self, xu):
        """Flat u vector -> list of per-class grid views."""
        return split_u_parity(xu, self.cls_shapes, self.ndim)


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
