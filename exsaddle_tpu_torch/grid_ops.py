"""Element data movement on the structured grids, in PyTorch.

The port of exsaddle_tpu/grid_ops.py (`_gather_q2` / `_scatter_q2`,
`_gather_q1` / `_scatter_q1`, `GridSaddleOperator`) and of the parity-layout
helpers of exsaddle_tpu/matfree.py (`split_u_parity`, `gather_u_parity`,
`scatter_u_parity`). Every gather is a stack of (strided) slices and every
scatter a sequence of in-place slice adds in the same order as the JAX
package's pad-adds: within one local node the slice touches each grid node
once, so the sums are deterministic on CUDA and the plain results match the
JAX package bit for bit.

Layout: a velocity vector is ONE flat tensor in parity-permuted dof order
(matfree.parity_permutation): the 2^nd parity classes one after another,
each a (z, y, x, nd) grid raveled. Per-class grids are views of it. The
natural-order helpers (`_gather_q2`, `_scatter_q2`, GridSaddleOperator) take
the node grid (z, y, x, nd) of the natural order instead."""

from dataclasses import dataclass

import numpy as np
import torch


def split_u_parity(xu, cls_shapes, nd):
    """Flat parity-permuted u vector -> list of per-class grid VIEWS
    (*cls_shape, nd)."""
    subs = []
    off = 0
    for s in cls_shapes:
        n = int(np.prod(s))
        subs.append(xu[off * nd:(off + n) * nd].view(tuple(s) + (nd,)))
        off += n
    return subs


def _locals(nd):
    """Element-local Q2 nodes, x-fastest:
    (slab index, class p, shifts (sa, sb[, sc]))."""
    out = []
    if nd == 2:
        for lb in range(3):
            for la in range(3):
                out.append((la + 3 * lb, (la & 1) | ((lb & 1) << 1),
                            (la >> 1, lb >> 1)))
        return out
    for lc in range(3):
        for lb in range(3):
            for la in range(3):
                out.append((la + 3 * lb + 9 * lc,
                            (la & 1) | ((lb & 1) << 1) | ((lc & 1) << 2),
                            (la >> 1, lb >> 1, lc >> 1)))
    return out


def _window(shifts, m_el):
    """Slices (z, y, x order) of the element window shifted by
    (sa, sb[, sc])."""
    nd = len(m_el)
    return tuple(slice(shifts[nd - 1 - d],
                       shifts[nd - 1 - d] + m_el[nd - 1 - d])
                 for d in range(nd))


def gather_u_parity(subs, m_el):
    """Parity subgrids -> (nel, 3^nd * nd) element dof values (column
    nd * local_node + component, local node x-fastest)."""
    nd = len(m_el)
    slabs = [subs[p][_window(sh, m_el)] for _, p, sh in _locals(nd)]
    xe = torch.stack(slabs, dim=nd)
    return xe.reshape(int(np.prod(m_el)), 3 ** nd * nd)


def scatter_u_parity(ye, m_el, cls_shapes):
    """Transpose of gather_u_parity: element contributions -> a NEW flat
    parity-permuted u vector (slice adds, conflict-free per local node)."""
    nd = len(m_el)
    n = sum(int(np.prod(s)) for s in cls_shapes) * nd
    out = torch.zeros(n, dtype=ye.dtype, device=ye.device)
    outs = split_u_parity(out, cls_shapes, nd)
    yel = ye.reshape(tuple(reversed(m_el)) + (3 ** nd, nd))
    for li, p, sh in _locals(nd):
        outs[p][_window(sh, m_el)] += yel[..., li, :]
    return out


def _q1_locals(nd):
    if nd == 2:
        return [(la + 2 * lb, (la, lb)) for lb in range(2) for la in range(2)]
    return [(la + 2 * lb + 4 * lc, (la, lb, lc))
            for lc in range(2) for lb in range(2) for la in range(2)]


def _gather_q1(p_grid, m_el):
    """p_grid: (*rev(nn_p),) -> (nel, 2^nd)."""
    nd = len(m_el)
    slabs = [p_grid[_window(sh, m_el)] for _, sh in _q1_locals(nd)]
    return torch.stack(slabs, dim=nd).reshape(int(np.prod(m_el)), 2 ** nd)


def _scatter_q1(ye, m_el, nn):
    """(nel, 2^nd) element contributions -> a new (*rev(nn),) grid."""
    nd = len(m_el)
    yel = ye.reshape(tuple(reversed(m_el)) + (2 ** nd,))
    out = torch.zeros(tuple(reversed(nn)), dtype=ye.dtype, device=ye.device)
    for li, sh in _q1_locals(nd):
        out[_window(sh, m_el)] += yel[..., li]
    return out


def _q2_window(loc, m_el):
    """Stride-2 slices (z, y, x order) of the Q2 nodes at element-local
    position (la, lb[, lc]) of every element."""
    nd = len(m_el)
    return tuple(slice(loc[nd - 1 - d], loc[nd - 1 - d]
                       + 2 * m_el[nd - 1 - d] - 1, 2) for d in range(nd))


def _q2_locals(nd):
    """(local node index, (la, lb[, lc])), x fastest."""
    if nd == 2:
        return [(la + 3 * lb, (la, lb)) for lb in range(3) for la in range(3)]
    return [(la + 3 * lb + 9 * lc, (la, lb, lc))
            for lc in range(3) for lb in range(3) for la in range(3)]


def _gather_q2(x_grid, m_el):
    """x_grid: (*rev(nn_u), d) -> (nel, 3^nd * d) element dof values,
    local node x-fastest, component fastest within node."""
    nd = len(m_el)
    slabs = [x_grid[_q2_window(loc, m_el)] for _, loc in _q2_locals(nd)]
    xe = torch.stack(slabs, dim=nd)             # (*rev(m_el), 3^nd, d)
    return xe.reshape(int(np.prod(m_el)), 3 ** nd * x_grid.shape[-1])


def _scatter_q2(ye, m_el, nn, d):
    """(nel, 3^nd * d) element contributions -> a new (*rev(nn), d) grid
    (stride-2 slice adds, one local node at a time)."""
    nd = len(m_el)
    yel = ye.reshape(tuple(reversed(m_el)) + (3 ** nd, d))
    out = torch.zeros(tuple(reversed(nn)) + (d,), dtype=ye.dtype,
                      device=ye.device)
    for li, loc in _q2_locals(nd):
        out[_q2_window(loc, m_el)] += yel[..., li, :]
    return out


def _bmv(A, x):
    """(nel, m, n) x (nel, n) -> (nel, m)."""
    return torch.bmm(A, x.unsqueeze(2)).squeeze(2)


@dataclass(frozen=True)
class GridSaddleOperator:
    """Stencil-structured saddle operator: the element blocks of
    operator.SaddleOperator (in element order) applied through strided
    slices and slice adds, natural dof order."""
    A11: torch.Tensor          # (nel, nud, nud)
    A12: torch.Tensor          # (nel, nud, npb)
    A21: torch.Tensor          # (nel, npb, nud)
    A22: torch.Tensor          # (nel, npb, npb)
    bc_mask: torch.Tensor      # (ndof,)
    m_el: tuple
    nn_u: tuple
    nn_p: tuple
    nu: int
    np_: int

    @classmethod
    def from_operator(cls, mesh, op):
        """From an operator.SaddleOperator on its device, in its dtype: its
        colour-ordered element blocks are put back in element order."""
        inv = np.empty_like(op.order)
        inv[op.order] = np.arange(op.order.size)
        inv_t = torch.as_tensor(inv, device=op.device)
        return cls(A11=op.A11[inv_t], A12=op.A12[inv_t], A21=op.A21[inv_t],
                   A22=op.A22[inv_t], bc_mask=op.bc_mask,
                   m_el=tuple(mesh.m_el), nn_u=tuple(mesh.nn_u),
                   nn_p=tuple(mesh.nn_p), nu=mesh.nu, np_=mesh.np_)

    @property
    def ndof(self):
        return self.nu + self.np_

    def mult(self, x):
        nd = len(self.m_el)
        x_grid = x[: self.nu].reshape(tuple(reversed(self.nn_u)) + (nd,))
        p_grid = x[self.nu:].reshape(tuple(reversed(self.nn_p)))
        xe = _gather_q2(x_grid, self.m_el)          # (nel, nud)
        pe = _gather_q1(p_grid, self.m_el)          # (nel, npb)
        yue = _bmv(self.A11, xe) + _bmv(self.A12, pe)
        ype = _bmv(self.A21, xe) + _bmv(self.A22, pe)
        yu = _scatter_q2(yue, self.m_el, self.nn_u, nd).reshape(-1)
        yp = _scatter_q1(ype, self.m_el, self.nn_p).reshape(-1)
        return torch.cat([yu, yp]) + self.bc_mask * x
