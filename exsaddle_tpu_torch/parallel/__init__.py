"""Distributed runtime of the port: slab and cartesian domain decomposition
over a device grid, with halo adds between neighbouring shards and psum
reductions (shard_mesh.py), one process driving every shard.

See slab.py for the 1-D layout; the serial<->sharded conversions live on
SlabPartition and the per-shard element apply on SlabOperator."""

from exsaddle_tpu_torch.parallel.slab import (AXIS, SlabPartition,
                                              SlabOperator, dist_dot,
                                              dist_norm, halo_add,
                                              make_dist_mult,
                                              make_dist_fgmres)

__all__ = ["AXIS", "SlabPartition", "SlabOperator", "dist_dot", "dist_norm",
           "halo_add", "make_dist_mult", "make_dist_fgmres"]
