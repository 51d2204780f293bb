"""Structured Q2-Q1 (Taylor-Hood) mesh and DOF management.

Capability parity with the reference's DMCreate_SaddleQ2Q1 + element/node maps
(femixedspace.c:852-1363), re-expressed as flat index arithmetic over the
global structured grids instead of PETSc DMDA objects:

  - Q2 velocity grid: (2*mx+1) x (2*my+1) [x (2*mz+1)] nodes, ndim dofs/node.
  - Q1 pressure grid: (mx+1) x (my+1) [x (mz+1)] nodes, 1 dof/node.
  - Node linear index: i + j*nx + k*nx*ny (x fastest) -- DMDA "natural" order.
  - Global dof order (single shard): [all u dofs, interleaved per node | all p].
  - Elements ordered ei + ej*mx + ek*mx*my.

All maps are precomputed numpy int32 arrays (a copy of exsaddle_tpu/mesh.py
for the PyTorch port, which cannot import the JAX package).
"""

from dataclasses import dataclass, field
from functools import cached_property

import numpy as np


def _node_grid_indices(nn):
    """Return (prod(nn), ndim) int array of structured grid coordinates,
    x fastest."""
    ndim = len(nn)
    if ndim == 2:
        jj, ii = np.meshgrid(np.arange(nn[1]), np.arange(nn[0]), indexing="ij")
        return np.stack([ii.ravel(), jj.ravel()], axis=1)
    kk, jj, ii = np.meshgrid(np.arange(nn[2]), np.arange(nn[1]),
                             np.arange(nn[0]), indexing="ij")
    return np.stack([ii.ravel(), jj.ravel(), kk.ravel()], axis=1)


def _element_node_map(m_el, nn, order, stride):
    """Element -> node map for a tensor grid.

    m_el:  elements per dimension (mx, my[, mz])
    nn:    nodes per dimension
    order: nodes per element per dimension (2 for Q1, 3 for Q2)
    stride: node stride per element (1 for Q1, 2 for Q2)
    Returns (nel, order^ndim) int32, element x fastest, node x fastest.
    """
    ndim = len(m_el)
    # element origins in node coordinates
    ogrids = [stride * np.arange(m_el[d]) for d in range(ndim)]
    # local offsets
    loffs = [np.arange(order) for _ in range(ndim)]

    if ndim == 2:
        ej, ei = np.meshgrid(ogrids[1], ogrids[0], indexing="ij")
        origins = np.stack([ei.ravel(), ej.ravel()], axis=1)  # (nel, 2)
        lj, li = np.meshgrid(loffs[1], loffs[0], indexing="ij")
        local = np.stack([li.ravel(), lj.ravel()], axis=1)    # (nl, 2)
    else:
        ek, ej, ei = np.meshgrid(ogrids[2], ogrids[1], ogrids[0], indexing="ij")
        origins = np.stack([ei.ravel(), ej.ravel(), ek.ravel()], axis=1)
        lk, lj, li = np.meshgrid(loffs[2], loffs[1], loffs[0], indexing="ij")
        local = np.stack([li.ravel(), lj.ravel(), lk.ravel()], axis=1)

    coords = origins[:, None, :] + local[None, :, :]  # (nel, nl, ndim)
    return _lin_index(coords, nn).astype(np.int32)


def _lin_index(coords, nn):
    idx = coords[..., 0].copy()
    mult = nn[0]
    for d in range(1, len(nn)):
        idx += coords[..., d] * mult
        mult *= nn[d]
    return idx


@dataclass(frozen=True)
class SaddleMesh:
    """Q2-Q1 structured box mesh.

    Parameters mirror the reference driver flags -mx/-my/-mz and
    -size_x/-size_y/-size_z (exSaddle.c:178-185).
    """
    ndim: int
    m_el: tuple          # (mx, my[, mz]) element counts
    size: tuple          # box dimensions

    def __post_init__(self):
        assert self.ndim in (2, 3)
        assert len(self.m_el) == self.ndim
        assert len(self.size) == self.ndim

    # --- grid sizes -------------------------------------------------------
    @cached_property
    def nn_u(self):
        """Q2 node counts per dimension."""
        return tuple(2 * m + 1 for m in self.m_el)

    @cached_property
    def nn_p(self):
        """Q1 node counts per dimension."""
        return tuple(m + 1 for m in self.m_el)

    @property
    def n_u_nodes(self):
        return int(np.prod(self.nn_u))

    @property
    def n_p_nodes(self):
        return int(np.prod(self.nn_p))

    @property
    def nu(self):
        """Number of velocity dofs."""
        return self.ndim * self.n_u_nodes

    @property
    def np_(self):
        """Number of pressure dofs."""
        return self.n_p_nodes

    @property
    def ndof(self):
        return self.nu + self.np_

    @property
    def nel(self):
        return int(np.prod(self.m_el))

    @property
    def u_basis(self):
        return 3 ** self.ndim

    @property
    def p_basis(self):
        return 2 ** self.ndim

    # --- coordinates ------------------------------------------------------
    @cached_property
    def u_coords(self):
        """(n_u_nodes, ndim) float64 coordinates of Q2 nodes (uniform box)."""
        g = _node_grid_indices(self.nn_u).astype(np.float64)
        h = np.array([self.size[d] / (self.nn_u[d] - 1)
                      for d in range(self.ndim)])
        return g * h

    @cached_property
    def p_coords(self):
        g = _node_grid_indices(self.nn_p).astype(np.float64)
        h = np.array([self.size[d] / (self.nn_p[d] - 1)
                      for d in range(self.ndim)])
        return g * h

    # --- element -> node / dof maps --------------------------------------
    @cached_property
    def u_el_nodes(self):
        """(nel, 3^ndim) int32 Q2 node indices per element."""
        return _element_node_map(self.m_el, self.nn_u, 3, 2)

    @cached_property
    def p_el_nodes(self):
        """(nel, 2^ndim) int32 Q1 node indices per element."""
        return _element_node_map(self.m_el, self.nn_p, 2, 1)

    @cached_property
    def u_el_dofs(self):
        """(nel, ndim*3^ndim) int32 velocity dof indices (interleaved per
        node: dof = ndim*node + component), matching the reference's
        el_u_idx construction (femixedspace.c:2458-2461)."""
        nodes = self.u_el_nodes
        nd = self.ndim
        dofs = (nd * nodes[:, :, None]
                + np.arange(nd, dtype=np.int32)[None, None, :])
        return dofs.reshape(nodes.shape[0], -1).astype(np.int32)

    @cached_property
    def u_el_coords(self):
        """(nel, 3^ndim, ndim) coordinates of element Q2 nodes."""
        return self.u_coords[self.u_el_nodes]

    @cached_property
    def p_el_coords(self):
        return self.p_coords[self.p_el_nodes]

    # --- boundary faces ---------------------------------------------------
    @cached_property
    def _u_grid(self):
        return _node_grid_indices(self.nn_u)

    def u_face_nodes(self, dim, end):
        """Q2 node indices on the face where coordinate `dim` is at its
        min (end=0) or max (end=1)."""
        g = self._u_grid
        val = 0 if end == 0 else self.nn_u[dim] - 1
        return np.nonzero(g[:, dim] == val)[0].astype(np.int32)

    def split(self, x):
        """Split a full dof vector into (u, p) parts."""
        return x[..., :self.nu], x[..., self.nu:]
