"""Multi-host scaffolding for the cartesian distributed solver (the port of
exsaddle_tpu/parallel/multihost.py).

The reference scales across nodes with plain MPI ranks (SURVEY.md section 5,
PETSc stash exchange + VecScatter over the interconnect). The port runs one
process per host (or per group of devices), joined in a torch.distributed
group -- what jax.distributed joins in the JAX package. Each process drives
the shards of its own devices (shard_mesh.py):

  - `initialize()` wraps torch.distributed.init_process_group (gloo). It is
    a no-op in one process.
  - `host_partition()` builds the CartPartition whose OUTERMOST grid axis
    (z in 3D, the slowest axis of the shard stack) is the host axis, so a
    halo crosses processes on at most that one axis.
  - `local_boxes()` gives each process the element boxes of its own
    devices and `local_shards()` their shard indices: per-shard setup
    (cart_abf.build_cart_abf) assembles only those boxes, the process's
    ShardMesh (CartPartition.device_mesh) places only those shards, and
    the solve's halos, psums and L-2 gathers cross processes through the
    group (shard_mesh.ShardMesh.exchange / all_parts);
  - `HostComm` sums the additive setup partials across processes (PETSc's
    MatAssemblyBegin/End stash exchange, femixedspace.c:2624-2625).
"""

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from exsaddle_tpu_torch.parallel.cart import CartPartition
from exsaddle_tpu_torch.parallel.shard_mesh import stack_boxes


def initialize(init_method=None, world_size=None, rank=None, timeout=None):
    """Join the torch.distributed group of a multi-process run; a no-op in
    one process.

    Multi-process mode is entered when any argument is given or the
    standard environment (MASTER_ADDR with WORLD_SIZE > 1) announces one;
    the group uses the gloo backend (the setup reductions and the solve's
    exchanges are staged through host memory). timeout: seconds after which
    a collective or message that never completes raises (torch's default
    when None). Returns (world size, rank) after the possible
    initialization."""
    explicit = (init_method is not None or world_size is not None
                or rank is not None)
    env = ("MASTER_ADDR" in os.environ
           and int(os.environ.get("WORLD_SIZE", "1")) > 1)
    if (explicit or env) and not dist.is_initialized():
        kw = {} if timeout is None else {
            "timeout": datetime.timedelta(seconds=timeout)}
        dist.init_process_group(
            "gloo", init_method=init_method or "env://",
            world_size=-1 if world_size is None else world_size,
            rank=-1 if rank is None else rank, **kw)
    return process_identity()


def process_identity():
    """(world size, rank) of this process's torch.distributed group, or
    (1, 0) outside one."""
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def host_devices(device="cuda"):
    """This process's devices in order for `device` ("cuda" or "cpu"):
    every visible CUDA device, which must exist, or the CPU when asked (the
    rule of driver.resolve_device). The port's solve is single-controller
    per process, so there is no global device list (jax.devices() in the
    JAX package)."""
    if device == "cpu":
        return [torch.device("cpu")]
    if device != "cuda":
        raise ValueError(f"host_devices({device!r}): expected cuda or cpu")
    n = torch.cuda.device_count()
    if not n:
        raise RuntimeError("host_devices: no CUDA device is visible; ask "
                           "for host_devices('cpu') to run on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def host_partition(mesh, n_hosts, chips_per_host, chip_shape=None):
    """CartPartition over (n_hosts * chips_per_host) devices with the host
    axis on the OUTERMOST grid dimension.

    chip_shape: device grid per host over the remaining dims (innermost
    first), e.g. (2, 2) for 4 chips in 3D -> dev_shape (2, 2, n_hosts).
    Default: all chips along the second-outermost axis. The shard stack is
    z-major, so shards [h*chips_per_host : (h+1)*chips_per_host] are host
    h's slab."""
    nd = mesh.ndim
    if chip_shape is None:
        chip_shape = (1,) * (nd - 2) + (chips_per_host,)
    if int(np.prod(chip_shape)) != chips_per_host:
        raise ValueError(f"chip_shape {chip_shape} does not hold "
                         f"{chips_per_host} chips")
    dev_shape = tuple(chip_shape) + (n_hosts,)
    if len(dev_shape) != nd:
        raise ValueError(f"chip_shape must have {nd - 1} dims")
    return CartPartition(mesh, dev_shape)


class HostComm:
    """Multi-host reduction context for per-shard setup.

    Owns the process identity (which element boxes this process assembles,
    via `local_boxes`) and the cross-process sums of the additive setup
    partials. The default uses the torch.distributed group (all_reduce of a
    float64 CPU tensor) and is the identity in one process; tests inject an
    `allreduce(arr, tag)` callable to drive the same constructor path on a
    simulated multi-host topology."""

    def __init__(self, n_hosts=None, process_id=None, allreduce=None,
                 apply_others=None):
        grouped = dist.is_initialized()
        self.n_hosts = ((dist.get_world_size() if grouped else 1)
                        if n_hosts is None else n_hosts)
        self.process_id = ((dist.get_rank() if grouped else 0)
                           if process_id is None else process_id)
        self._allreduce = allreduce
        # simulated topologies: tag -> the OTHER hosts' partial operator
        # closures (apply_partial_sum evaluates them in-process where a
        # real run all-reduces the result vector)
        self._apply_others = apply_others

    def allreduce_dense(self, arr, tag):
        """Sum a dense numpy partial across processes. `tag` names the
        quantity (the same on every process) so injected test reducers can
        match partials without relying on call order or shape."""
        if self._allreduce is not None:
            return self._allreduce(arr, tag)
        if self.n_hosts == 1:
            return arr
        t = torch.tensor(np.asarray(arr), dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t.numpy()

    def apply_partial_sum(self, v, local_fn, tag):
        """Distributed y = sum_h A_h(v): this process's partial operator on
        v plus the other processes' contributions (one dense all-reduce of
        the O(nodes) result vector; the element data behind local_fn never
        leaves the process). Simulated topologies evaluate the other hosts'
        injected closures in-process."""
        y = np.asarray(local_fn(v))
        if self._apply_others is not None:
            for f in self._apply_others.get(tag, ()):
                y = y + f(v)
            return y
        return self.allreduce_dense(y, tag)

    def place_shards(self, stack, tag):
        """Device-stacked per-box slabs: each process fills only its own
        boxes, so the sum over processes of the disjoint writes IS the
        placement (the JAX package's addressable-shard placement; here it
        rides the same channel as allreduce_dense)."""
        return self.allreduce_dense(stack, tag)

    def allreduce_minmax(self, bounds):
        """Reduce a [lo, hi] bracket across processes: min over lo, max over
        hi (the p-block spectrum bracket of cart_abf). Injected test
        reducers receive it under the "p_elbounds" tag."""
        if self._allreduce is not None:
            return np.asarray(self._allreduce(np.asarray(bounds),
                                              "p_elbounds"))
        if self.n_hosts == 1:
            return np.asarray(bounds)
        lo = torch.tensor([float(bounds[0])], dtype=torch.float64)
        hi = torch.tensor([float(bounds[1])], dtype=torch.float64)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        return np.array([lo.item(), hi.item()])


def simulated_comm(part, ctx, bc_idx, P_f, grids, n_hosts,
                   process_id=0, lame=False):
    """HostComm for a SIMULATED multi-host topology in one process: the
    other hosts' partials are assembled locally up front and summed through
    the same tag-keyed allreduce hook a real cross-host reduction uses."""
    from exsaddle_tpu_torch.abf import stencil_from_csr
    from exsaddle_tpu_torch.parallel.cart_abf import (assemble_host_local,
                                                      local_element_partials)
    mesh = part.mesh
    nd = mesh.ndim
    lvl1 = tuple(reversed(grids[-2]))
    others = [assemble_host_local(part, ctx, bc_idx, P_f, grids,
                                  lame=lame,
                                  boxes=local_boxes(part, h, n_hosts))
              for h in range(n_hosts) if h != process_id]

    def allreduce(arr, tag):
        for o in others:
            if tag == "A1_stencil":
                arr = arr + stencil_from_csr(o["A1"], lvl1, nd)
            elif tag == "Mp_stencil":
                arr = arr + stencil_from_csr(
                    o["Mp"], tuple(reversed(mesh.nn_p)), 1)
            elif tag == "p_elbounds":
                arr = np.array([min(arr[0], o[tag][0]),
                                max(arr[1], o[tag][1])])
            else:
                arr = arr + o[tag]
        return arr

    # the other hosts' O(local) partial operators (fine esteig probe and
    # rhs_diri rows): a real run sums the result vectors across processes
    apply_others = {"fine_esteig": [], "rhs_diri": []}
    for o in others:
        ua, rr = local_element_partials(mesh, o["el_ids_loc"],
                                        o["sv_loc"], bc_idx)
        apply_others["fine_esteig"].append(ua)
        apply_others["rhs_diri"].append(rr)

    return HostComm(n_hosts=n_hosts, process_id=process_id,
                    allreduce=allreduce, apply_others=apply_others)


def local_boxes(part, process_id, n_hosts):
    """The (ix, iy[, iz]) element boxes owned by `process_id`'s devices
    under a `host_partition` layout (host axis = outermost dim)."""
    pz = part.dev_shape[-1]
    if pz % n_hosts:
        raise ValueError(f"outer device axis {pz} not divisible by "
                         f"{n_hosts} hosts")
    per_host = pz // n_hosts
    lo = process_id * per_host
    hi = lo + per_host
    return [b for b in part.dev_boxes() if lo <= b[-1] < hi]


def local_shards(part, process_id, n_hosts):
    """Shard-stack indices of `process_id`'s boxes (local_boxes): the
    contiguous block of the z-major stack a process's ShardMesh holds."""
    mine = set(local_boxes(part, process_id, n_hosts))
    return [i for i, b in enumerate(stack_boxes(part.dev_shape))
            if b in mine]
