"""Slab domain decomposition over a device grid (the port of
exsaddle_tpu/parallel/slab.py): the 1-D special case of parallel/cart.py.

  - 1D slab partition along the slowest grid axis (z in 3D, y in 2D),
    element-aligned like the reference's macro-element ownership rule
    (femixedspace.c:1102-1124): m_el[-1] must divide by the device count,
    mirroring the reference's divisibility errors.
  - Interface node planes are stored on both neighbours, so the operator
    gather needs no communication; after the local apply the two interface
    planes' partial sums are exchanged and added (shard_mesh.halo_add_axis,
    the analogue of DMLocalToGlobal ADD_VALUES).
  - Dots mask the lower interface plane on all but the first shard and
    reduce with the mesh's psum (the MPI_Allreduce of every VecDot).

Vectors are ShardVecs of flat local vectors in the natural order (local u
grid, then local p grid), one per slab."""

import numpy as np
import torch

from exsaddle_tpu_torch.parallel.cart import (CartOperator, CartPartition,
                                              make_cart_fgmres,
                                              make_cart_mult)
from exsaddle_tpu_torch.parallel.shard_mesh import (ShardMesh, halo_add_axis,
                                                    owned_weight)
from exsaddle_tpu_torch.treeops import make_dots, smap

AXIS = "z"


def check_slabs(mesh, ndev):
    """Elements per slab along the slowest axis; raises the reference's
    divisibility error when ndev does not divide it."""
    m_last = mesh.m_el[-1]
    if m_last % ndev:
        raise ValueError(
            f"element count {m_last} along the slab axis is not divisible "
            f"by {ndev} devices (macro-element alignment, "
            "femixedspace.c:1102-1124)")
    return m_last // ndev


class SlabPartition(CartPartition):
    """Host-side slab layout for a SaddleMesh over ndev devices: a
    CartPartition whose device grid splits only the slowest axis."""

    def __init__(self, mesh, ndev):
        check_slabs(mesh, ndev)
        super().__init__(mesh, (1,) * (mesh.ndim - 1) + (ndev,))

    def shard_elements(self, a):
        """(nel, ...) element array -> (ndev, nel_loc, ...). Elements are
        ordered x-fastest, slab axis slowest, so slabs are contiguous."""
        a = np.asarray(a)
        return a.reshape((self.ndev, self.nel_loc) + a.shape[1:])


# --- per-shard collectives ---------------------------------------------------

def halo_add(smesh, grids):
    """Exchange-and-add interface-plane partial sums with both neighbours
    along the slab axis (in place on the ShardVec of local grids)."""
    return halo_add_axis(smesh, grids, smesh.nd - 1)


def owned_mask_factor(smesh, i, nzl):
    """(nzl,) weight of shard i: plane 0 counts only on shard 0 (elsewhere
    it is the redundant copy of the lower neighbour's top plane)."""
    return owned_weight(smesh, i, (nzl,) + (1,) * (smesh.nd - 1),
                        axes=(smesh.nd - 1,)).reshape(-1)


def dist_dot(op, a, b):
    """Global dot of two sharded vectors of `op`'s layout."""
    return make_dots(weight=op.weight, psum=op.smesh.psum)[0](a, b)


def dist_norm(op, a):
    return smap(torch.sqrt, dist_dot(op, a, a))


class SlabOperator(CartOperator):
    """Per-slab element blocks + BC masks of a global element-batched
    operator."""

    @classmethod
    def build(cls, part, op, smesh):
        """From a (BC-masked) element-batched operator.SaddleOperator: its
        colour-ordered blocks are put back in element order, sliced into
        slabs and placed on the mesh's devices."""
        inv = np.empty_like(op.order)
        inv[op.order] = np.arange(op.order.size)
        inv_t = torch.as_tensor(inv, device=op.device)
        stack = part._stack_shape()

        def slabs(a):
            a = part.shard_elements(a[inv_t].cpu().numpy())
            return a.reshape(stack + a.shape[1:])
        return cls.from_blocks(part, smesh, slabs(op.A11), slabs(op.A12),
                               slabs(op.A21), slabs(op.A22),
                               op.bc_mask.cpu().numpy())


# a SlabOperator is a CartOperator: the JAX package's slab names for the
# cartesian apply and fixed FGMRES(k) cycle (no host read)
make_dist_mult = make_cart_mult
make_dist_fgmres = make_cart_fgmres


__all__ = ["AXIS", "SlabPartition", "SlabOperator", "ShardMesh", "dist_dot",
           "dist_norm", "halo_add", "owned_mask_factor", "make_dist_mult",
           "make_dist_fgmres"]
