"""Cartesian N-D domain decomposition over a device grid, with PER-SHARD
assembly (the port of exsaddle_tpu/parallel/cart.py).

The reference splits the node grid along EVERY dimension into a cartesian
rank grid (femixedspace.c:1154-1161) with macro-element-aligned ownership
(femixedspace.c:1102-1124). Here:

  - element boxes are mloc[d] = m_el[d] / dev_shape[d] per shard
    (divisibility enforced like the reference's errors);
  - interface node planes are stored on both neighbours along every
    decomposed axis (the DMDA ghosted-local pattern), so element gathers
    need no communication;
  - after each element scatter, interface partial sums are exchanged ONE
    AXIS AT A TIME (shard_mesh.halo_add_axis); sequential exchanges carry
    edge and corner sums along because the accumulation is additive;
  - dots weight each plane by the product of per-axis ownership weights and
    reduce with the mesh's psum;
  - setup is per shard: each box's element blocks come from its own local
    FE space (quadrature points shifted to global coordinates), so the
    dominant setup memory scales with 1/ndev.

Vectors of CartOperator are ShardVecs of flat local vectors in the natural
order: the local velocity node grid (z, y, x, d) raveled, then the local
pressure grid. The shards follow shard_mesh.ShardMesh's stack order."""

import itertools
from dataclasses import dataclass

import numpy as np
import torch

from exsaddle_tpu_torch import compiled
from exsaddle_tpu_torch.grid_ops import (_gather_q1, _gather_q2, _scatter_q1,
                                         _scatter_q2)
from exsaddle_tpu_torch.parallel.shard_mesh import (ShardMesh,
                                                    ghost_extend_axis,
                                                    halo_add_axis,
                                                    owned_weight,
                                                    stack_boxes)
from exsaddle_tpu_torch.treeops import ShardVec, first, make_dots, smap

__all__ = ["CartPartition", "CartOperator", "assemble_local_blocks",
           "halo_add_axis", "ghost_extend_axis", "halo_add_all",
           "owned_weight", "cart_dot", "cart_norm", "make_cart_mult",
           "make_cart_fgmres"]


class CartPartition:
    """Host-side cartesian layout of a SaddleMesh over a device grid.

    dev_shape: devices per grid dimension, (px, py[, pz]); every m_el[d]
    must divide by dev_shape[d]."""

    def __init__(self, mesh, dev_shape):
        self.mesh = mesh
        self.dev_shape = tuple(dev_shape)
        assert len(self.dev_shape) == mesh.ndim
        for m, p in zip(mesh.m_el, self.dev_shape):
            if m % p:
                raise ValueError(
                    f"element count {m} not divisible by {p} devices "
                    "(macro-element alignment, femixedspace.c:1102-1124)")
        self.mloc = tuple(m // p for m, p in zip(mesh.m_el, self.dev_shape))
        self.nn_u_loc = tuple(2 * m + 1 for m in self.mloc)
        self.nn_p_loc = tuple(m + 1 for m in self.mloc)
        self.nel_loc = int(np.prod(self.mloc))
        self.ndev = int(np.prod(self.dev_shape))

    def dev_boxes(self):
        """Device boxes (ix, iy[, iz]) in the JAX package's iteration
        order (the order setup accumulates in)."""
        return list(itertools.product(*[range(p) for p in self.dev_shape]))

    def _stack_shape(self):
        """Leading device axes of stacked host arrays: reversed (z-major),
        so stacked[tuple(reversed(box))] is the box's block and the flat
        stack index is the ShardMesh shard index."""
        return tuple(reversed(self.dev_shape))

    def device_mesh(self, devices):
        """ShardMesh of this layout over `devices`, one per shard of this
        process: in a torch.distributed group of W processes process r
        holds the shards multihost.local_shards gives it, 1/W of the grid
        along its outermost axis; in one process, every shard."""
        from exsaddle_tpu_torch.parallel import multihost
        world, rank = multihost.process_identity()
        return ShardMesh(self.dev_shape, devices,
                         shards=multihost.local_shards(self, rank, world))

    def unstack(self, a):
        """Stacked host array (stack dims leading) -> per-shard list in
        shard order."""
        a = np.asarray(a)
        return list(a.reshape((self.ndev,) + a.shape[self.mesh.ndim:]))

    # --- global <-> per-shard conversions (setup/check path) -------------
    def _grid_slices(self, box, nodes_per_el, extra):
        """Per-dimension slices of a device's local node box inside the
        global grid (array layout: reversed dims)."""
        sl = []
        for d in reversed(range(self.mesh.ndim)):
            start = nodes_per_el * box[d] * self.mloc[d]
            count = nodes_per_el * self.mloc[d] + 1
            sl.append(slice(start, start + count))
        return tuple(sl) + extra

    def shard_vector(self, x):
        """Global natural (ndof,) -> per-shard flat local vectors (u grid
        then p grid, interface planes duplicated), shard order."""
        mesh = self.mesh
        nd = mesh.ndim
        x = np.asarray(x)
        xu = x[: mesh.nu].reshape(tuple(reversed(mesh.nn_u)) + (nd,))
        xp = x[mesh.nu:].reshape(tuple(reversed(mesh.nn_p)))
        return [np.concatenate([
            xu[self._grid_slices(box, 2, (slice(None),))].reshape(-1),
            xp[self._grid_slices(box, 1, ())].reshape(-1)])
            for box in stack_boxes(self.dev_shape)]

    def unshard_vector(self, parts):
        """Inverse of shard_vector (a ShardVec or a list of host arrays,
        every shard's); both copies of an interface plane hold the same
        value for a consistent vector."""
        mesh = self.mesh
        nd = mesh.ndim
        if isinstance(parts, ShardVec):
            parts = [p.cpu().numpy() for p in parts.parts]
        if len(parts) != self.ndev:
            raise ValueError(f"{len(parts)} parts for {self.ndev} shards")
        nu_loc = int(np.prod(self.nn_u_loc)) * nd
        xu = np.zeros(tuple(reversed(mesh.nn_u)) + (nd,), parts[0].dtype)
        xp = np.zeros(tuple(reversed(mesh.nn_p)), parts[0].dtype)
        for box, v in zip(stack_boxes(self.dev_shape), parts):
            xu[self._grid_slices(box, 2, (slice(None),))] = v[:nu_loc].reshape(
                tuple(reversed(self.nn_u_loc)) + (nd,))
            xp[self._grid_slices(box, 1, ())] = v[nu_loc:].reshape(
                tuple(reversed(self.nn_p_loc)))
        return np.concatenate([xu.reshape(-1), xp.reshape(-1)])

    def natural_weight(self, smesh):
        """ShardVec of ownership weights of the flat natural local layout
        (each shard's by its global index; smesh places the local ones)."""
        nd = self.mesh.ndim
        out = []
        for i in range(smesh.ndev):
            wu = owned_weight(smesh, i, tuple(reversed(self.nn_u_loc)))
            wp = owned_weight(smesh, i, tuple(reversed(self.nn_p_loc)))
            out.append(np.concatenate([np.repeat(wu.reshape(-1), nd),
                                       wp.reshape(-1)]))
        return smesh.shard(out)


# --- collectives over all axes ----------------------------------------------

def halo_add_all(smesh, grids):
    """Sequential per-axis halo-add (array dim k <-> grid axis nd-1-k, z
    first, as the JAX package orders it); in place, returns grids."""
    nd = smesh.nd
    for k in range(nd):
        halo_add_axis(smesh, grids, nd - 1 - k)
    return grids


def cart_dot(weight, smesh, a, b):
    """Global dot of two sharded vectors under the ownership `weight`."""
    return make_dots(weight=weight, psum=smesh.psum)[0](a, b)


def cart_norm(weight, smesh, a):
    return smap(torch.sqrt, cart_dot(weight, smesh, a, a))


# --- per-shard assembly -------------------------------------------------------

def ghost_ring_coefficients(part, ctx, box):
    """Model coefficients of device box `box`'s elements: a LOCAL FESpace
    on the box's element range EXTENDED by one ghost-element ring (clipped
    at the domain boundary), its quadrature points shifted to global
    coordinates, the model evaluated there and Q1-projected locally. The
    lumped qp->Q1 projection only couples a node to its adjacent elements,
    so one ghost ring reproduces the GLOBAL projection exactly.

    Returns (efes, coeff_ext, owned): the extended FESpace, its qp
    coefficient dict, and owned(a), which cuts an (nel_ext, ...) array to
    the box's own elements."""
    from exsaddle_tpu_torch import driver, models as emodels
    from exsaddle_tpu_torch.assembly import (FESpace, interp_q1_to_qp,
                                             project_qp_to_q1)
    from exsaddle_tpu_torch.mesh import SaddleMesh

    mesh, mloc = part.mesh, part.mloc
    nd = mesh.ndim
    cell = [s / m for s, m in zip(mesh.size, mesh.m_el)]
    e0 = [box[d] * mloc[d] for d in range(nd)]
    lo = [1 if e0[d] > 0 else 0 for d in range(nd)]
    hi = [1 if e0[d] + mloc[d] < mesh.m_el[d] else 0 for d in range(nd)]
    m_ext = tuple(mloc[d] + lo[d] + hi[d] for d in range(nd))
    origin = np.array([cell[d] * (e0[d] - lo[d]) for d in range(nd)])
    emesh = SaddleMesh(nd, m_ext, tuple(cell[d] * m_ext[d] for d in range(nd)))
    efes = FESpace(emesh)
    pts = efes.qp_coords.reshape(-1, nd) + origin[None, :]
    c = emodels.evaluate_coefficients(ctx, pts).reshape(
        emesh.nel, efes.nqp, -1)
    coeff_ext = driver._qp_dict(ctx, interp_q1_to_qp(
        efes, project_qp_to_q1(efes, c)))
    sl = tuple(slice(lo[d], lo[d] + mloc[d]) for d in reversed(range(nd)))

    def owned(a):
        a = np.asarray(a)
        return a.reshape(tuple(reversed(m_ext))
                         + a.shape[1:])[sl].reshape((-1,) + a.shape[1:])
    return efes, coeff_ext, owned


def assemble_local_blocks(part, ctx, lame=False):
    """PER-SHARD assembly (femixedspace.c:2306-2647's per-rank loop): for
    every device box, assemble the ghost-ring-extended local FE space
    (ghost_ring_coefficients) and keep the owned elements' blocks. Returns
    stacked (dev..., nel_loc, ...) host arrays."""
    from exsaddle_tpu_torch.assembly import assemble_element_matrices

    blocks = {}
    for box in part.dev_boxes():
        efes, coeff, owned = ghost_ring_coefficients(part, ctx, box)
        elm = assemble_element_matrices(efes, coeff, lame=lame)
        out = {}
        for name in ("A11", "A12", "A22"):
            if elm[name] is None:               # Stokes: A22 = 0
                npb = efes.mesh.p_basis
                out[name] = np.zeros((part.nel_loc, npb, npb))
            else:
                out[name] = owned(elm[name])
        blocks[tuple(reversed(box))] = out
    out = {}
    for name in ("A11", "A12", "A22"):
        first_blk = blocks[next(iter(blocks))][name]
        arr = np.empty(part._stack_shape() + first_blk.shape,
                       first_blk.dtype)
        for dev_idx, elm in blocks.items():
            arr[dev_idx] = elm[name]
        out[name] = arr
    return out


def _bmv(A, x):
    return torch.bmm(A, x.unsqueeze(2)).squeeze(2)


@dataclass(frozen=True)
class CartOperator:
    """Per-shard element blocks + BC masks over a ShardMesh (ShardVecs of
    (nel_loc, ...) blocks and flat natural local masks), and the ownership
    weight of the flat natural layout."""
    A11: ShardVec
    A12: ShardVec
    A21: ShardVec
    A22: ShardVec
    mask: ShardVec
    weight: ShardVec
    smesh: ShardMesh
    m_el_loc: tuple
    nn_u_loc: tuple
    nn_p_loc: tuple

    @classmethod
    def from_blocks(cls, part, smesh, A11, A12, A21, A22, bc):
        """From stacked host element blocks (BC rows and columns already
        zeroed) and the global natural bc mask (ndof,)."""
        def put(a):
            return smesh.shard(part.unstack(a))
        return cls(A11=put(A11), A12=put(A12), A21=put(A21), A22=put(A22),
                   mask=smesh.shard(part.shard_vector(bc)),
                   weight=part.natural_weight(smesh), smesh=smesh,
                   m_el_loc=part.mloc, nn_u_loc=part.nn_u_loc,
                   nn_p_loc=part.nn_p_loc)

    @classmethod
    def build(cls, part, ctx, bc_idx, smesh, lame=False):
        """Per-shard assembly + symmetric Dirichlet elimination applied to
        the LOCAL element blocks (rows and columns of constrained dofs
        zeroed elementwise; the unit diagonal rides on `mask`)."""
        mesh = part.mesh
        nd = mesh.ndim
        blocks = assemble_local_blocks(part, ctx, lame=lame)
        bc = np.zeros(mesh.ndof)
        bc[np.asarray(bc_idx)] = 1.0
        A11 = np.asarray(blocks["A11"])
        A12 = np.asarray(blocks["A12"])
        A21 = A12.swapaxes(-1, -2).copy()       # raw A21 = A12^T
        A22 = np.asarray(blocks["A22"])
        nu_loc = int(np.prod(part.nn_u_loc)) * nd
        for i, keep in enumerate(part.shard_vector(1.0 - bc)):
            di = np.unravel_index(i, part._stack_shape())
            ku = _gather_q2(torch.as_tensor(keep[:nu_loc]).view(
                tuple(reversed(part.nn_u_loc)) + (nd,)), part.mloc).numpy()
            kp = _gather_q1(torch.as_tensor(keep[nu_loc:]).view(
                tuple(reversed(part.nn_p_loc))), part.mloc).numpy()
            m = A11[di] * ku[:, :, None]
            m *= ku[:, None, :]
            A11[di] = m
            A12[di] = A12[di] * ku[:, :, None] * kp[:, None, :]
            A21[di] = A21[di] * kp[:, :, None] * ku[:, None, :]
            A22[di] = A22[di] * kp[:, :, None] * kp[:, None, :]
        return cls.from_blocks(part, smesh, A11, A12, A21, A22, bc)

    def _raw(self, A11, A12, A21, A22, x):
        """One shard's element apply without halos: (u grid, p grid)."""
        m_el = self.m_el_loc
        nd = len(m_el)
        nu = int(np.prod(self.nn_u_loc)) * nd
        xe = _gather_q2(x[:nu].view(tuple(reversed(self.nn_u_loc)) + (nd,)),
                        m_el)
        pe = _gather_q1(x[nu:].view(tuple(reversed(self.nn_p_loc))), m_el)
        yue = _bmv(A11, xe) + _bmv(A12, pe)
        ype = _bmv(A21, xe) + _bmv(A22, pe)
        return (_scatter_q2(yue, m_el, self.nn_u_loc, nd),
                _scatter_q1(ype, m_el, self.nn_p_loc))

    def mult(self, x):
        """y = A x on a ShardVec of flat natural local vectors."""
        yu, yp = smap(self._raw, self.A11, self.A12, self.A21, self.A22, x)
        yu = halo_add_all(self.smesh, yu)
        yp = halo_add_all(self.smesh, yp)
        y = smap(lambda u, p: torch.cat([u.reshape(-1), p.reshape(-1)]),
                 yu, yp)
        return y + self.mask * x


def make_cart_mult(smesh):
    """Distributed y = A x: mult(op, x) on ShardVecs over `smesh`."""
    def mult(op, x):
        assert op.smesh is smesh
        return op.mult(x)
    return mult


def make_cart_fgmres(smesh, k):
    """Fixed FGMRES(k) cycle with Jacobi preconditioning over the device
    grid: solve(op, inv_diag, F, x0) -> (x, rnorm), ownership-weighted psum
    Gram-Schmidt, per-axis halos, no host read (compiled.py's cycle with
    the mesh's dots). rnorm is a 0-d tensor on the first shard's device."""
    def solve(op, inv_diag, F, x0):
        assert op.smesh is smesh
        dots = make_dots(weight=op.weight, psum=smesh.psum)
        x, rnorm = compiled._fgmres_cycle(op.mult, lambda v: inv_diag * v,
                                          k, F, x0, dots=dots)
        return x, first(rnorm)
    return solve
