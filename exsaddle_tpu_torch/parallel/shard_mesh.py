"""The shard model of the port's multi-device runtime, and its collectives.

The JAX package runs its distributed solvers as one shard_map program over a
jax.sharding.Mesh: each device runs the per-shard body, halos move with
lax.ppermute and dots reduce with lax.psum. Here ONE process drives every
shard in turn (single controller, like the JAX runtime):

  - a ShardMesh holds the device grid shape and one torch.device per shard,
    in the JAX package's z-major stack order (parallel/cart.py
    CartPartition._stack_shape: shard i is box (ix, iy[, iz]) with
    i = ix + px * (iy + py * iz)). A device may repeat: 4 shards on cuda:0
    are the counterpart of 4 virtual devices, and with several CUDA devices
    shard i may sit on cuda:i;
  - sharded data is a treeops.ShardVec, one tensor per shard on its device;
    replicated data holds one copy per distinct device, shared by the shards
    on it;
  - the collectives are plain tensor ops and deterministic: halo_add_axis /
    ghost_extend_axis copy planes between neighbouring shards and add them
    in place; psum sums the per-shard partials in shard order on the first
    shard's device and hands the total back to every device.

Nothing here reads a device value on the host."""

import numpy as np
import torch

from exsaddle_tpu_torch.treeops import ShardVec

# the sharded solves run in float64 (the JAX package's distributed path)
DTYPE = torch.float64


def stack_boxes(dev_shape):
    """Device boxes (ix, iy[, iz]) in stack order: shard i is the box whose
    reversed index tuple ravels to i in the stack shape reversed(dev_shape)
    (x fastest)."""
    stack = tuple(reversed(dev_shape))
    return tuple(tuple(int(c) for c in reversed(np.unravel_index(i, stack)))
                 for i in range(int(np.prod(stack))))


class ShardMesh:
    """Device grid `dev_shape` (devices per grid dimension, x first) over
    `devices` (one per shard in stack order; repeats allowed)."""

    def __init__(self, dev_shape, devices):
        self.dev_shape = tuple(int(p) for p in dev_shape)
        self.ndev = int(np.prod(self.dev_shape))
        devices = [torch.device(d) for d in devices]
        if len(devices) < self.ndev:
            raise ValueError(f"device grid {self.dev_shape} needs "
                             f"{self.ndev} devices, got {len(devices)}")
        self.devices = tuple(devices[: self.ndev])
        self.distinct = tuple(dict.fromkeys(self.devices))
        self.boxes = stack_boxes(self.dev_shape)
        self._index = {b: i for i, b in enumerate(self.boxes)}

    @property
    def nd(self):
        return len(self.dev_shape)

    def neighbour(self, i, d, step):
        """Shard index of shard i's neighbour along grid axis d (step -1 or
        +1), or None at the edge of the device grid."""
        b = list(self.boxes[i])
        b[d] += step
        return self._index.get(tuple(b))

    def pairs(self, d):
        """(lower, upper) shard pairs that share an interface along d."""
        out = []
        for i in range(self.ndev):
            j = self.neighbour(i, d, 1)
            if j is not None:
                out.append((i, j))
        return out

    # --- placement -------------------------------------------------------
    def shard(self, arrays):
        """Per-shard host arrays (stack order) -> ShardVec of float64 copies
        on the devices (never views of the host arrays, which halos would
        write)."""
        return ShardVec(torch.tensor(a, dtype=DTYPE, device=dev)
                        for a, dev in zip(arrays, self.devices))

    def replicate(self, t):
        """Tensor t, one copy per distinct device (t itself on its own
        device), shared by the shards on that device."""
        copies = {dev: t.to(dev) for dev in self.distinct}
        return ShardVec(copies[dev] for dev in self.devices)

    def per_device(self, fn, *args):
        """Replicated fn(*args): computed once per distinct device on the
        first shard of that device's arguments, shared by its shards (the
        redundant coarse work of PCREDUNDANT)."""
        done = {}
        for i, dev in enumerate(self.devices):
            if dev not in done:
                done[dev] = fn(*[a.parts[i] if isinstance(a, ShardVec) else a
                                 for a in args])
        return ShardVec(done[dev] for dev in self.devices)

    # --- collectives -----------------------------------------------------
    def psum(self, partials):
        """Sum of per-shard partials (a ShardVec of equal shapes), in shard
        order on the first shard's device, replicated back: bitwise the same
        on every call."""
        parts = partials.parts
        s = parts[0]
        for p in parts[1:]:
            s = s + p.to(s.device)
        return self.replicate(s)


def halo_add_axis(mesh, grids, d):
    """Exchange-and-add the two interface planes along grid axis d (array
    dim nd-1-d of every part) with the neighbours on that axis; both copies
    of an interface plane then hold the assembled sum (the ppermute pair of
    the JAX package's halo_add_axis). In place on `grids` (a ShardVec of
    local grids or views of them), which it returns."""
    if mesh.dev_shape[d] == 1:
        return grids
    k = mesh.nd - 1 - d
    g = grids.parts
    sent = [(lo, hi, g[lo].select(k, -1).to(g[hi].device, copy=True),
             g[hi].select(k, 0).to(g[lo].device, copy=True))
            for lo, hi in mesh.pairs(d)]
    for lo, hi, from_left, from_right in sent:
        g[hi].select(k, 0).add_(from_left)
        g[lo].select(k, -1).add_(from_right)
    return grids


def ghost_extend_axis(mesh, grids, d):
    """New local grids with one ghost plane on each side of grid axis d:
    the left ghost is the left neighbour's plane m-1 (its [-2]), the right
    ghost the right neighbour's plane 1; a side with no neighbour gets
    zeros -- the zero padding a domain-boundary stencil apply needs."""
    k = mesh.nd - 1 - d
    g = grids.parts
    out = []
    for i, a in enumerate(g):
        zero = torch.zeros_like(a.narrow(k, 0, 1))
        lo, hi = mesh.neighbour(i, d, -1), mesh.neighbour(i, d, 1)
        left = (zero if lo is None else
                g[lo].narrow(k, g[lo].shape[k] - 2, 1).to(a.device))
        right = zero if hi is None else g[hi].narrow(k, 1, 1).to(a.device)
        out.append(torch.cat([left, a, right], dim=k))
    return ShardVec(out)


def owned_weight(mesh, i, shape, axes=None):
    """Ownership weight of shard i for a local grid of `shape` (reversed
    spatial dims first; trailing dims broadcast): plane 0 along each grid
    axis in `axes` (default all) counts only on the first shard of that
    axis -- elsewhere it duplicates the lower neighbour's top plane. Host
    float64 array of shape shape[:nd]."""
    nd = mesh.nd
    w = np.ones(tuple(shape[:nd]))
    for d in range(nd) if axes is None else axes:
        if mesh.boxes[i][d] > 0:
            idx = [slice(None)] * nd
            idx[nd - 1 - d] = 0
            w[tuple(idx)] = 0.0
    return w
