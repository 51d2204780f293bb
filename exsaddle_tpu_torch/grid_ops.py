"""Element data movement on the structured grids, in PyTorch.

The port's counterparts of exsaddle_tpu/grid_ops.py `_gather_q1` /
`_scatter_q1` and of the parity-layout helpers of exsaddle_tpu/matfree.py
(`split_u_parity`, `gather_u_parity`, `scatter_u_parity`). Every gather is a
stack of unit-stride slices and every scatter a sequence of in-place slice
adds in the same order as the JAX package's pad-adds, so the plain results
match it bit for bit.

Layout: a velocity vector is ONE flat tensor in parity-permuted dof order
(matfree.parity_permutation): the 2^nd parity classes one after another,
each a (z, y, x, nd) grid raveled. Per-class grids are views of it."""

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
