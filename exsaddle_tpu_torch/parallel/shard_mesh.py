"""The shard model of the port's multi-device runtime, and its collectives.

The JAX package runs its distributed solvers as one shard_map program over a
jax.sharding.Mesh: each device runs the per-shard body, halos move with
lax.ppermute and dots reduce with lax.psum. Here each process drives the
shards of its own devices in turn (single controller per process, like the
JAX runtime):

  - a ShardMesh holds the device grid shape, the process identity (rank,
    world size) and one torch.device per LOCAL shard, in the JAX package's
    z-major stack order (parallel/cart.py CartPartition._stack_shape: shard
    i is box (ix, iy[, iz]) with i = ix + px * (iy + py * iz)). Process r of
    W owns the contiguous block of shards [r * n, (r + 1) * n), n = ndev / W
    (multihost.local_shards: the outermost grid axis is the host axis). A
    device may repeat: 4 shards on cuda:0 are the counterpart of 4 virtual
    devices, and with several CUDA devices shard i may sit on cuda:i;
  - sharded data is a treeops.ShardVec, one tensor per local shard on its
    device; replicated data holds one copy per distinct local device,
    shared by the shards on it;
  - the collectives are deterministic and give the same bits in any number
    of processes: halo_add_axis / ghost_extend_axis move planes between
    neighbouring shards (copies inside a process; one host-staged
    torch.distributed message per peer process and call across processes)
    and add them in place; psum gathers every shard's partial and sums them
    in global shard order on the first local device, then hands the total
    back to every local device.

Nothing here reads a device value on the host within one process (with
every shard on one CUDA device the collectives can be captured in a CUDA
graph: ShardMesh.capturable); across processes every exchanged plane and
partial is staged through host memory (the group is gloo).

With one shard on each of several CUDA cards of one process, a card's
view of the mesh (CardMesh) runs the same collectives as peer-to-peer
kernels (kernels/peer.py): each card's solve is then its own CUDA graph,
the cards meeting in those kernels, and the results are the one-card
mesh's bits (psum's fold in global shard order, the halo's adds in the
order of its moves)."""

import itertools
import threading

import numpy as np
import torch
import torch.distributed as dist

from exsaddle_tpu_torch import graphs
from exsaddle_tpu_torch.kernels import peer
from exsaddle_tpu_torch.trace import span
from exsaddle_tpu_torch.treeops import ShardVec

for _c in peer.COUNTERS:
    graphs.track(_c)
# the cards' views count from one thread each under a ThreadGroup
_COUNTING = threading.Lock()


def count(counter, k=1):
    """counter.n += k under the lock the cards' threads share."""
    with _COUNTING:
        counter.n += k


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
    `devices` (one per local shard in stack order; repeats allowed).

    shards: the global indices of this process's shards (default: every
    shard, one process), the contiguous block [rank * n, (rank + 1) * n)
    of a group of world = ndev / n processes, which sets this process's
    rank. `traffic` counts what crossed processes: point-to-point messages
    and bytes sent, gathers issued and bytes contributed."""

    def __init__(self, dev_shape, devices, shards=None):
        self.dev_shape = tuple(int(p) for p in dev_shape)
        self.ndev = int(np.prod(self.dev_shape))
        self.shards = tuple(range(self.ndev) if shards is None else shards)
        nloc = len(self.shards)
        self.rank, self.world = self.shards[0] // nloc, self.ndev // nloc
        if (self.ndev % nloc or self.shards != tuple(
                range(self.rank * nloc, (self.rank + 1) * nloc))):
            raise ValueError(f"shards {self.shards} of {self.ndev} are not "
                             "one process's block of the stack")
        devices = [torch.device(d) for d in devices]
        if len(devices) < nloc:
            raise ValueError(f"device grid {self.dev_shape} needs "
                             f"{nloc} devices per process, got "
                             f"{len(devices)}")
        self.devices = tuple(devices[:nloc])
        self.distinct = tuple(dict.fromkeys(self.devices))
        self.boxes = stack_boxes(self.dev_shape)
        self._index = {b: i for i, b in enumerate(self.boxes)}
        self.traffic = dict.fromkeys(("messages", "bytes", "gathers",
                                      "gather_bytes"), 0)

    @property
    def nd(self):
        return len(self.dev_shape)

    @property
    def one_per_card(self):
        """True when one process holds every shard, each on its own CUDA
        card: the mesh the cards' device loop takes (CardMesh views over a
        kernels.peer group), where every pair of cards has peer access."""
        return (self.world == 1 and self.ndev > 1
                and len(self.distinct) == self.ndev
                and all(d.type == "cuda" for d in self.distinct))

    @property
    def capturable(self):
        """True when one process holds every shard and all of them share
        one CUDA device: every collective here (psum, all_parts, replicate,
        exchange, halo_add_axes, ghost_extend_axis) is then device ops on
        that device with no host read, so a CUDA graph can capture them.
        Across processes the planes and partials are staged through host
        memory over the group, which no graph holds."""
        return (self.world == 1 and len(self.distinct) == 1
                and self.distinct[0].type == "cuda")

    def is_local(self, i):
        return self.shards[0] <= i <= self.shards[-1]

    def owner(self, i):
        """Rank of the process that holds global shard i."""
        return i // len(self.shards)

    def part(self, sv, i):
        """Global shard i's part of a ShardVec over this mesh (local i)."""
        return sv.parts[i - self.shards[0]]

    def device_of(self, i):
        return self.devices[i - self.shards[0]]

    def neighbour(self, i, d, step):
        """Shard index of shard i's neighbour along grid axis d (step -1 or
        +1), or None at the edge of the device grid."""
        b = list(self.boxes[i])
        b[d] += step
        return self._index.get(tuple(b))

    def pairs(self, d):
        """(lower, upper) shard pairs that share an interface along d, over
        the whole grid."""
        out = []
        for i in range(self.ndev):
            j = self.neighbour(i, d, 1)
            if j is not None:
                out.append((i, j))
        return out

    # --- placement -------------------------------------------------------
    def shard(self, arrays):
        """Per-shard host arrays of the WHOLE grid (stack order) -> ShardVec
        of float64 copies of this process's ones on its devices (never
        views of the host arrays, which halos would write)."""
        arrays = list(arrays)
        if len(arrays) != self.ndev:
            raise ValueError(f"{len(arrays)} arrays for {self.ndev} shards")
        return ShardVec(torch.tensor(arrays[i], dtype=DTYPE, device=dev)
                        for i, dev in zip(self.shards, self.devices))

    def replicate(self, t):
        """Tensor t, one copy per distinct local device (t itself on its
        own device), shared by the shards on that device."""
        copies = {dev: t.to(dev) for dev in self.distinct}
        return ShardVec(copies[dev] for dev in self.devices)

    def per_device(self, fn, *args):
        """Replicated fn(*args): computed once per distinct local device on
        the first shard of that device's arguments, shared by its shards
        (the redundant coarse work of PCREDUNDANT)."""
        done = {}
        for i, dev in enumerate(self.devices):
            if dev not in done:
                done[dev] = fn(*[a.parts[i] if isinstance(a, ShardVec) else a
                                 for a in args])
        return ShardVec(done[dev] for dev in self.devices)

    # --- collectives -----------------------------------------------------
    def all_parts(self, sv, device=None):
        """Every shard's part of `sv` (parts of equal shape), in global
        shard order, on `device` (default: the first local shard's): the
        local parts moved there, the other processes' all-gathered through
        host memory."""
        device = self.devices[0] if device is None else torch.device(device)
        if self.world == 1:
            return [p.to(device) for p in sv.parts]
        dev0 = self.devices[0]
        mine = torch.stack([p.to(dev0) for p in sv.parts]).cpu()
        got = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(got, mine)
        self.traffic["gathers"] += 1
        self.traffic["gather_bytes"] += mine.numel() * mine.element_size()
        stacked = torch.cat(got).to(device)
        return list(stacked.unbind(0))

    def psum(self, partials):
        """Sum of per-shard partials (a ShardVec of equal shapes): a left
        fold in global shard order on the first local device, replicated
        back -- bitwise the same on every call and in any number of
        processes."""
        parts = self.all_parts(partials)
        s = parts[0]
        for p in parts[1:]:
            s = s + p
        return self.replicate(s)

    def exchange(self, moves):
        """Plane moves between shards: moves[n] = (grids, src, dst, take)
        sends take(src's part of the ShardVec `grids`) to shard dst. Returns
        one tensor per move on dst's device (None where dst is in another
        process), every plane read before the caller writes any. Inside a
        process a move is a copy; across processes the planes to one peer
        travel as one host-staged message each way, in the order of
        `moves` (every process lists the same moves)."""
        out = [None] * len(moves)
        send, recv = {}, {}
        for n, (g, src, dst, take) in enumerate(moves):
            if self.is_local(src) and self.is_local(dst):
                out[n] = take(self.part(g, src)).to(self.device_of(dst),
                                                    copy=True)
            elif self.is_local(src):
                send.setdefault(self.owner(dst), []).append(
                    take(self.part(g, src)))
            elif self.is_local(dst):
                recv.setdefault(self.owner(src), []).append(
                    (n, take(self.part(g, dst))))
        if not send and not recv:
            return out
        reqs, bufs = [], {}
        for peer, planes in sorted(send.items()):
            flat = [p.reshape(-1) for p in planes]
            buf = torch.cat([f.to(flat[0].device) for f in flat]).cpu()
            reqs.append(dist.isend(buf, peer))
            self.traffic["messages"] += 1
            self.traffic["bytes"] += buf.numel() * buf.element_size()
        for peer, items in sorted(recv.items()):
            bufs[peer] = torch.empty(sum(like.numel() for _, like in items),
                                     dtype=items[0][1].dtype)
            reqs.append(dist.irecv(bufs[peer], peer))
        for r in reqs:
            r.wait()
        for peer, items in recv.items():
            on = {}
            off = 0
            for n, like in items:
                if like.device not in on:
                    on[like.device] = bufs[peer].to(like.device)
                out[n] = on[like.device][off:off + like.numel()].view(
                    like.shape)
                off += like.numel()
        return out


def halo_add_axes(mesh, grid_list, d):
    """halo_add_axis of several ShardVecs along one axis d in one exchange
    (one message per peer process for all of them; one peer ADD on a
    CardMesh, CardMesh.halo_add_merged along d alone); in place, returns
    grid_list."""
    if mesh.dev_shape[d] == 1:
        return grid_list
    if isinstance(mesh, CardMesh):
        mesh.halo_add_merged({d: grid_list})
        return grid_list
    k = mesh.nd - 1 - d
    top = lambda a: a.select(k, -1)
    bottom = lambda a: a.select(k, 0)
    moves = []
    for g in grid_list:
        for lo, hi in mesh.pairs(d):
            moves += [(g, lo, hi, top), (g, hi, lo, bottom)]
    got = mesh.exchange(moves)
    for (g, src, dst, _), plane in zip(moves, got):
        if plane is not None:
            (bottom if dst > src else top)(mesh.part(g, dst)).add_(plane)
    return grid_list


def halo_add_axis(mesh, grids, d):
    """Exchange-and-add the two interface planes along grid axis d (array
    dim nd-1-d of every part) with the neighbours on that axis; both copies
    of an interface plane then hold the assembled sum (the ppermute pair of
    the JAX package's halo_add_axis). In place on `grids` (a ShardVec of
    local grids or views of them), which it returns."""
    halo_add_axes(mesh, [grids], d)
    return grids


def halo_add_every_axis(mesh, per_axis):
    """halo_add_axes of the ShardVecs per_axis[d] along each grid axis d in
    turn (a grid listed on several axes: its edges and corners take the
    later axes' sums after the earlier ones'); in place. On a CardMesh
    one peer exchange does every split axis at once
    (CardMesh.halo_add_merged), each card's bits the sequence's."""
    axes = [d for d, grids in enumerate(per_axis)
            if grids and mesh.dev_shape[d] > 1]
    if not isinstance(mesh, CardMesh):
        for d in axes:
            halo_add_axes(mesh, per_axis[d], d)
    elif axes:
        mesh.halo_add_merged({d: per_axis[d] for d in axes})


def ghost_extend_axis(mesh, grids, d):
    """New local grids with one ghost plane on each side of grid axis d:
    the left ghost is the left neighbour's plane m-1 (its [-2]), the right
    ghost the right neighbour's plane 1; a side with no neighbour gets
    zeros -- the zero padding a domain-boundary stencil apply needs."""
    k = mesh.nd - 1 - d
    moves = []
    for lo, hi in mesh.pairs(d):
        moves += [(grids, lo, hi, lambda a: a.narrow(k, a.shape[k] - 2, 1)),
                  (grids, hi, lo, lambda a: a.narrow(k, 1, 1))]
    got = mesh.exchange(moves)
    ghosts = {(dst, dst > src): plane
              for (_, src, dst, _), plane in zip(moves, got)
              if plane is not None}
    out = []
    for i, a in zip(mesh.shards, grids.parts):
        zero = torch.zeros_like(a.narrow(k, 0, 1))
        out.append(torch.cat([ghosts.get((i, True), zero), a,
                              ghosts.get((i, False), zero)], dim=k))
    return ShardVec(out)


def ghost_extend(mesh, grids):
    """ghost_extend_axis along every grid axis, the last first, so that a
    later axis's ghost planes carry the earlier ones' ghosts (the corners
    and edges: a diagonal neighbour's values, zeros where there is none).
    On a CardMesh one peer exchange brings every ghost at once, each from
    the neighbour whose values the sequence would have put there
    (CardMesh.ghost_extend): the same bits, half the exchanges over a
    2 x 2 grid."""
    if isinstance(mesh, CardMesh):
        return mesh.ghost_extend(grids)
    for d in reversed(range(mesh.nd)):
        grids = ghost_extend_axis(mesh, grids, d)
    return grids


def ghost_moves(mesh):
    """The moves of a ghost extension along every grid axis at once, in
    the order every card lists them: (src, dst, offset), src the shard at
    dst's box + offset (an offset per grid axis in {-1, 0, 1}, not all 0)
    wherever that box exists."""
    nd = mesh.nd
    offsets = [o for o in np.ndindex(*(3,) * nd) if any(c != 1 for c in o)]
    moves = []
    for dst in range(mesh.ndev):
        for o in offsets:
            box = tuple(b + c - 1 for b, c in zip(mesh.boxes[dst], o))
            src = mesh._index.get(box)
            if src is not None:
                moves.append((src, dst, tuple(c - 1 for c in o)))
    return moves


def ghost_regions(nd, offset, shape):
    """(the source's region of its raw grid, the destination's region of
    its extended grid) of a ghost move at `offset` (per grid axis, the
    source's box less the destination's), as index tuples over the array
    dims (grid axis d is array dim nd-1-d; trailing dims whole): along an
    axis where the source lies below, its plane m-1 (its [-2]) into the
    lower ghost; above, its plane 1 into the upper ghost; level, the whole
    extent into the interior."""
    src, dst = [], []
    for k in range(nd):
        c = offset[nd - 1 - k]
        n = shape[k]
        src.append(slice(n - 2, n - 1) if c < 0 else slice(1, 2) if c > 0
                   else slice(None))
        dst.append(slice(0, 1) if c < 0 else slice(n + 1, n + 2) if c > 0
                   else slice(1, n + 1))
    return tuple(src), tuple(dst)


def owned_weight(mesh, i, shape, axes=None):
    """Ownership weight of global shard i for a local grid of `shape`
    (reversed spatial dims first; trailing dims broadcast): plane 0 along
    each grid axis in `axes` (default all) counts only on the first shard
    of that axis -- elsewhere it duplicates the lower neighbour's top plane.
    Host float64 array of shape shape[:nd]."""
    nd = mesh.nd
    w = np.ones(tuple(shape[:nd]))
    for d in range(nd) if axes is None else axes:
        if mesh.boxes[i][d] > 0:
            idx = [slice(None)] * nd
            idx[nd - 1 - d] = 0
            w[tuple(idx)] = 0.0
    return w


class CardMesh(ShardMesh):
    """Card i's view of a ShardMesh whose shards sit one per CUDA card of
    one process (ShardMesh.one_per_card), or one per thread of a
    peer.ThreadGroup on the CPU: a mesh of the one shard i on its device
    (world 1, so capturable on CUDA), whose collectives meet the other
    cards' in the peer `group` (card c of the group is shard c):

      psum        every card's partial, folded in global shard order
                  (peer FOLD): ShardMesh.psum's bits on every card;
      all_parts   every shard's part on this card (peer COPY): the L-2
                  gather, summed by the caller in shard order;
      exchange    the planes moved into this shard (peer COPY; the ghost
                  planes of ghost_extend_axis);
      ghost_extend  every axis's ghosts in one peer COPY (ghost_extend);
      halo_add_merged  halo_add_axes along one axis, or along several in
                  turn, as one peer ADD (halo_add_axes,
                  halo_add_every_axis).

    Every card lists the same moves; each sender packs its planes in that
    order (peer.plan), every shard's parts having the same shape. Each
    collective is a device span of `trace` ("psum" for the reductions,
    "halo" for the exchanges) and is counted in peer.COUNTERS (a halo
    over two or more axes in HALOS and MERGED_HALOS). In a warm-up run before a capture
    (group.rehearsal()) it meets no peer: FOLD and COPY give zeros and
    nothing is launched or counted."""

    def __init__(self, mesh, i, group, trace=None):
        self.dev_shape, self.ndev = mesh.dev_shape, mesh.ndev
        self.shards, self.rank, self.world = (i,), 0, 1
        self.devices = self.distinct = (mesh.devices[i],)
        self.boxes, self._index = mesh.boxes, mesh._index
        self.traffic = dict.fromkeys(mesh.traffic, 0)
        self.index, self.group, self.trace = i, group, trace

    def _collective(self, kind, what, mode, outs, ins):
        if self.group.rehearsal():
            for t, _ in ins:
                if mode != peer.ADD:
                    t.zero_()
            return
        halo = kind in ("halo", "merged")
        with span(self.trace, "halo" if halo else "psum"):
            self.group.collective(self.index, what, mode, outs, ins)
        if halo:
            count(peer.HALOS)
            if kind == "merged":
                count(peer.MERGED_HALOS)
        else:
            count(peer.PSUMS)
            if kind == "psum":
                count(peer.PSUM_VALUES, outs[0][0].numel())

    def psum(self, partials):
        p = partials.parts[0]
        out = torch.empty_like(p, memory_format=torch.contiguous_format)
        self._collective("psum", f"psum of {p.numel()}", peer.FOLD,
                         [(p, 0)], [(out, [(None, 0, None)])])
        return ShardVec([out])

    def all_parts(self, sv, device=None):
        p = sv.parts[0]
        if device is not None and torch.device(device) != self.devices[0]:
            raise ValueError(f"a card's view gathers onto its own card "
                             f"{self.devices[0]}, not {device}")
        got = [p if c == self.index else
               torch.empty_like(p, memory_format=torch.contiguous_format)
               for c in range(self.ndev)]
        self._collective("gather", f"gather of {p.numel()}", peer.COPY,
                         [(p, 0)], [(t, [(c, 0, None)])
                                    for c, t in enumerate(got)
                                    if c != self.index])
        return got

    def exchange(self, moves):
        out = [None] * len(moves)
        if not moves:
            return out
        me = self.index
        planes = [take(self.part(g, me)) for g, _, _, take in moves]
        offs = peer.plan([(src, t.numel()) for (_, src, _, _), t in
                          zip(moves, planes)])
        outs = [(t, off) for (_, src, _, _), t, off in
                zip(moves, planes, offs) if src == me]
        ins = []
        for n, ((_, src, dst, _), off) in enumerate(zip(moves, offs)):
            if dst == me:
                out[n] = torch.empty_like(
                    planes[n], memory_format=torch.contiguous_format)
                ins.append((out[n], [(src, off, None)]))
        self._collective("halo", "ghost", peer.COPY, outs, ins)
        return out

    def ghost_extend(self, grids):
        """ghost_extend(self, grids) in one peer exchange (COPY): the
        extended grid zeroed, this shard's grid copied into its interior,
        then every neighbour's ghost values (ghost_moves, ghost_regions)
        copied into their places."""
        nd, me = self.nd, self.index
        a = grids.parts[0]
        out = torch.zeros(tuple(n + 2 for n in a.shape[:nd]) + a.shape[nd:],
                          dtype=a.dtype, device=a.device)
        out[tuple(slice(1, n + 1) for n in a.shape[:nd])].copy_(a)
        moves = ghost_moves(self)
        if moves:
            regions = [ghost_regions(nd, o, a.shape) for _, _, o in moves]
            offs = peer.plan([(src, a[r[0]].numel()) for (src, _, _), r in
                              zip(moves, regions)])
            outs = [(a[r[0]], off) for (src, _, _), r, off in
                    zip(moves, regions, offs) if src == me]
            ins = [(out[r[1]], [(src, off, None)]) for (src, dst, _), r, off
                   in zip(moves, regions, offs) if dst == me]
            self._collective("halo", "ghost", peer.COPY, outs, ins)
        return ShardVec([out])

    def halo_add_merged(self, per_axis):
        """halo_add_axes(self, per_axis[d], d) for each split axis d of the
        dict `per_axis` in turn, as one peer ADD: site "halo axis d" for one
        axis, "halo axes d+e..." for more, counted in MERGED_HALOS. Every
        card packs the planes the sequence's moves send, in the order of
        those moves (peer.plan), before any add. A
        value on one exchanged plane takes its neighbour's; where k planes
        meet (an edge, a corner) the value sums the 2^k cards around it as
        the sequence does, pairwise in axis order: (own + y) + (z +
        diagonal) on an edge. The destinations are the regions of such
        values (faces less their edges, edges less their corners, corners,
        _merged_items), so none overlaps another."""
        nd, me, axes = self.nd, self.index, list(per_axis)
        grids = []
        for d in axes:
            grids += [g for g in per_axis[d] if all(g is not h for h in grids)]
        sizes, keys = [], []
        for d in axes:
            for g in per_axis[d]:
                u = next(i for i, h in enumerate(grids) if h is g)
                n = self.part(g, me).select(nd - 1 - d, 0).numel()
                for lo, hi in self.pairs(d):
                    sizes += [(lo, n), (hi, n)]
                    keys += [(d, u, lo, 1), (d, u, hi, -1)]
        offs = dict(zip(keys, peer.plan(sizes)))
        outs = [(grids[u].parts[0].select(nd - 1 - d, -1 if side > 0 else 0),
                 off) for (d, u, src, side), off in offs.items() if src == me]
        ins = []
        for u, g in enumerate(grids):
            on = [d for d in axes if any(g is h for h in per_axis[d])]
            ins += self._merged_items(g.parts[0], u, on, offs)
        kind, what = (("halo", f"halo axis {axes[0]}") if len(axes) == 1
                      else ("merged", "halo axes " + "+".join(map(str, axes))))
        self._collective(kind, what, peer.ADD, outs, ins)

    def _merged_items(self, a, u, on, offs):
        """The destinations in this shard's grid `a` (grids[u] of
        halo_add_merged, exchanged along the axes `on`) with their sources.
        Along each axis of `on` a value lies on the lower plane (-1), the
        upper (+1), where that neighbour exists, or neither (0); a region
        holds the values of one such choice. Its sources are the other
        cards around those values, card b + sum over S of the choices'
        steps for each nonempty subset S of the chosen axes A, listed
        with S's bits in A's order as the leaves of the pairwise sum; each
        is read from the plane that card packed along the first axis of S
        (the one facing this card), with a stride, its coordinates along
        the axes of S flipped (a lower plane there is its upper one)."""
        nd, me, shape = self.nd, self.index, a.shape
        sides = {d: [s for s in (-1, 1) if self.neighbour(me, d, s)
                     is not None] for d in on}
        if any(shape[nd - 1 - d] < 2 for d in on):
            raise ValueError(f"a merged halo needs 2 or more planes along "
                             f"each exchanged axis, not {tuple(shape)}")
        items = []
        for choice in itertools.product(*[[0] + sides[d] for d in on]):
            pick = {d: c for d, c in zip(on, choice) if c}
            if not pick:
                continue
            region = []
            for k, n in enumerate(shape):
                d = nd - 1 - k
                if d in pick:
                    region.append(slice(0, 1) if pick[d] < 0 else
                                  slice(n - 1, n))
                else:
                    near = sides.get(d, ())
                    region.append(slice(int(-1 in near),
                                        n - int(1 in near)))
            if any(r.stop <= r.start for r in region):
                continue
            chosen = sorted(pick)
            srcs = []
            for leaf in range(1, 2 ** len(chosen)):
                S = [d for j, d in enumerate(chosen) if leaf >> j & 1]
                box = list(self.boxes[me])
                for d in S:
                    box[d] += pick[d]
                c = self._index[tuple(box)]
                kf = nd - 1 - S[0]
                strides = [int(np.prod([m for f, m in enumerate(shape[k + 1:],
                                                               k + 1)
                                        if f != kf])) if k != kf else 0
                           for k in range(len(shape))]
                flip = {nd - 1 - d for d in S}
                base = offs[(S[0], u, c, -pick[S[0]])] + sum(
                    (n - 1 - r.start if k in flip else r.start) * st
                    for k, (n, r, st) in enumerate(zip(shape, region,
                                                       strides)))
                srcs.append((c, base, strides))
            items.append((a[tuple(region)], srcs))
        return items
