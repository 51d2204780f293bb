"""Processes of the port's two-process gloo runs on localhost
(tests/test_torch_multihost.py, tests/test_torch_multihost_solve.py). It
imports only torch and the port, so a spawned child starts without JAX.

Each entry point is rank `rank` of N_HOSTS processes joined on
`init_method`, and saves what it got to `out_dir`:

  - `run`: the cartesian ABF setup of the mx=4 pseudoice problem over a
    2 hosts x 4 devices layout with a real HostComm (so it assembles only
    its own boxes and the partials ride torch.distributed);
  - `run_collectives`: the ShardMesh collectives (halo_add_axis,
    ghost_extend_axis, psum, all_parts) on seeded grids over a 2x2x2 grid;
  - `run_solve`: the sharded ABF solve of the pseudoice problem over
    host_partition(mesh, 2, chips) on the CPU or a card, with the setup
    built by every process alone (multihost=None) and with a real HostComm
    (`one_process` solves it over the same shards in one process);
  - `run_driver`: driver.saddle_solve inside the group, and the errors of
    a layout whose host axis does not divide and of unequal device
    counts.

`spawn` starts the processes and fails after a deadline."""

import os
import socket
import time

import numpy as np
import torch
import torch.multiprocessing as mp

N_HOSTS, CHIPS = 2, 4
# a message or collective that never completes raises after this long
GROUP_TIMEOUT = 120
PSEUDOICE = ["-model", "11", "-size_x", "0.1"]
# the sinker at mx=4 under the abf.opts flags: a few outer iterations
DRIVER_ARGS = ["-model", "2", "-mx", "4", "-device", "cpu",
               "-saddle_ksp_monitor_short", "-saddle_ksp_converged_reason"]


def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(fn, out_dir, *args, timeout=240):
    """Run fn(rank, init_method, out_dir, *args) in N_HOSTS processes
    joined on localhost; fails after `timeout` seconds or when a process
    fails."""
    init = f"tcp://localhost:{_free_port()}"
    ctx = mp.spawn(fn, args=(init, str(out_dir)) + args, nprocs=N_HOSTS,
                   join=False)
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "two-process run timed out"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()


def problem(m_el=(4, 4, 4), args=PSEUDOICE, size=(0.1, 1.0, 1.0)):
    """(ctx, mesh, bc_idx, bc_vals) of one 3D problem (default the mx=4
    pseudoice problem)."""
    from exsaddle_tpu_torch import models
    from exsaddle_tpu_torch.mesh import SaddleMesh
    from exsaddle_tpu_torch.options import Options
    ctx = models.ModelContext(Options.from_args(list(args)), 3, lame=False,
                              log=lambda *a, **k: None)
    mesh = SaddleMesh(3, tuple(m_el), tuple(size))
    bc_idx, bc_vals = models.create_bc_list(ctx, mesh)
    return ctx, mesh, bc_idx, bc_vals


def rhs(ctx, mesh, bc_idx, bc_vals, rhs_diri):
    """The driver's right-hand side: F with BC values and rhs_diri."""
    from exsaddle_tpu_torch import driver
    from exsaddle_tpu_torch.assembly import (FESpace, assemble_rhs,
                                             scatter_vector)
    fes = FESpace(mesh)
    coeff = driver.fine_coefficients(ctx, fes)
    F = scatter_vector(mesh, *assemble_rhs(fes, coeff["Fu"], coeff["Fp"]))
    F[: mesh.nu][np.asarray(bc_idx)] = np.asarray(bc_vals)
    return F + np.asarray(rhs_diri)


def flatten(ddata, setup):
    """{name: array} of a cart_abf setup's numbers, for np.savez."""
    out = {"rhs_diri": np.asarray(setup["rhs_diri"])}
    for key, v in ddata.items():
        leaves = v if isinstance(v, (list, tuple)) else [v]
        for i, a in enumerate(leaves):
            for j, b in enumerate(a if isinstance(a, tuple) else [a]):
                out[f"{key}.{i}.{j}"] = np.asarray(b)
    return out


def grids_of(seed, shape):
    """Seeded per-shard host grids of one 2x2x2 collective check."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape) for _ in range(8)]


def collectives(smesh):
    """{name: every shard's result} of the ShardMesh collectives on the
    seeded grids (the same calls in one process and in a group)."""
    from exsaddle_tpu_torch.parallel.shard_mesh import (ghost_extend_axis,
                                                        halo_add_axes,
                                                        halo_add_axis)
    out = {}
    for d in range(3):
        g = smesh.shard(grids_of(d, (3, 4, 5, 2)))
        out[f"halo{d}"] = smesh.all_parts(halo_add_axis(smesh, g, d), "cpu")
        pair = [smesh.shard(grids_of(10 + d, (3, 4, 5))),
                smesh.shard(grids_of(20 + d, (3, 4, 5)))]
        out[f"halos{d}"] = [torch.stack(p) for p in zip(*[
            smesh.all_parts(g, "cpu") for g in halo_add_axes(smesh, pair,
                                                             d)])]
        out[f"ghost{d}"] = smesh.all_parts(
            ghost_extend_axis(smesh, smesh.shard(grids_of(30 + d,
                                                          (3, 4, 5))), d),
            "cpu")
    out["psum"] = smesh.all_parts(smesh.psum(smesh.shard(grids_of(40, (7,)))),
                                  "cpu")
    return {k: np.stack([t.numpy() for t in v]) for k, v in out.items()}


def _join(rank, init_method):
    torch.set_num_threads(1)
    from exsaddle_tpu_torch.parallel import multihost
    return multihost.initialize(init_method, N_HOSTS, rank,
                                timeout=GROUP_TIMEOUT)


def run(rank, init_method, out_dir):
    """The setup with a real HostComm, and two probe reductions."""
    from exsaddle_tpu_torch.parallel import multihost
    from exsaddle_tpu_torch.parallel.cart_abf import build_cart_abf
    world, got_rank = _join(rank, init_method)
    try:
        ctx, mesh, bc_idx, bc_vals = problem()
        part = multihost.host_partition(mesh, N_HOSTS, CHIPS,
                                        chip_shape=(2, 2))
        comm = multihost.HostComm()
        _, ddata, setup = build_cart_abf(part, ctx, bc_idx, bc_vals,
                                         nlevels=3, multihost=comm)
        probe = {"sum": comm.allreduce_dense(np.array([rank + 1.0]), "t"),
                 "minmax": comm.allreduce_minmax([rank - 1.0, rank + 0.5])}
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 world=world, rank=got_rank, n_hosts=comm.n_hosts,
                 process_id=comm.process_id, **probe,
                 **flatten(ddata, setup))
    finally:
        torch.distributed.destroy_process_group()


def run_collectives(rank, init_method, out_dir):
    """The collectives over a 2x2x2 grid, 4 shards per process."""
    from exsaddle_tpu_torch.parallel.shard_mesh import ShardMesh
    _join(rank, init_method)
    try:
        smesh = ShardMesh((2, 2, 2), ["cpu"] * CHIPS,
                          shards=range(rank * CHIPS, (rank + 1) * CHIPS))
        np.savez(os.path.join(out_dir, f"coll{rank}.npz"),
                 shards=np.array(smesh.shards), **collectives(smesh),
                 **{f"traffic_{k}": v for k, v in smesh.traffic.items()})
    finally:
        torch.distributed.destroy_process_group()


def solve_result(slv, F):
    """{name: array} of one CartABFSolver solve, with the mesh's traffic
    and the halo count."""
    r = slv.solve(F)
    return {"x": r["x"], "its": r["its"], "state": r["state"],
            "reason": r["reason"], "history": np.array(r["history"]),
            "rnorm": r["rnorm"], "F": F, "shards": np.array(slv.smesh.shards),
            "halos": r["halo_exchanges"],
            **{f"traffic_{k}": v for k, v in slv.smesh.traffic.items()}}


def solve_pseudoice(part, devices, comm=None):
    """solve_result of the pseudoice problem on `part`'s mesh over
    `devices` (this process's shards), the setup of every process alone
    or summed by the HostComm `comm`."""
    from exsaddle_tpu_torch.parallel.cart_abf import CartABFSolver
    ctx, mesh, bc_idx, bc_vals = problem(part.mesh.m_el)
    slv = CartABFSolver(part, ctx, bc_idx, bc_vals, devices, nlevels=3,
                        multihost=comm)
    F = rhs(ctx, mesh, bc_idx, bc_vals, slv.setup["rhs_diri"])
    return solve_result(slv, F)


def one_process(part, mode, device="cpu"):
    """solve_pseudoice in this process over every shard of `part`, a
    host_partition of N_HOSTS hosts; mode "comm" under the simulated
    N_HOSTS-host HostComm (whose two-operand sums are the gloo sums)."""
    from exsaddle_tpu_torch.parallel import multihost
    from exsaddle_tpu_torch.precond_mg import Prolongation
    comm = None
    if mode == "comm":
        ctx, mesh, bc_idx, _ = problem(part.mesh.m_el)
        grids = [tuple(mesh.nn_u)]
        for _ in range(2):
            grids.append(tuple((m + 1) // 2 for m in grids[-1]))
        grids = grids[::-1]
        P_f = Prolongation(grids[-2], grids[-1], 3).to_scipy()
        comm = multihost.simulated_comm(part, ctx, bc_idx, P_f, grids,
                                        n_hosts=N_HOSTS, process_id=0)
    return solve_pseudoice(part, [device] * part.ndev, comm)


def run_solve(rank, init_method, out_dir, chips, chip_shape, device="cpu",
              m_el=(4, 4, 4)):
    """solve_pseudoice over host_partition(mesh, N_HOSTS, chips,
    chip_shape), chips shards on `device` per process, in both setup modes
    (a real HostComm for "comm")."""
    from exsaddle_tpu_torch.parallel import multihost
    _join(rank, init_method)
    try:
        part = multihost.host_partition(problem(m_el)[1], N_HOSTS, chips,
                                        chip_shape=chip_shape)
        for mode in ("none", "comm"):
            comm = multihost.HostComm() if mode == "comm" else None
            np.savez(os.path.join(out_dir, f"solve_{mode}{rank}.npz"),
                     **solve_pseudoice(part, [device] * chips, comm))
    finally:
        torch.distributed.destroy_process_group()


def run_driver(rank, init_method, out_dir):
    """driver.saddle_solve with the abf.opts flags on the sinker at mx=4,
    [cpu] * 4 per rank (8 shards, device grid 2x2x2); then the messages of
    the ValueErrors of -mz 3 with one device per rank (device grid 1x2x1:
    the host axis has extent 1) and of unequal device counts."""
    from exsaddle_tpu_torch import driver
    from exsaddle_tpu_torch.options import Options
    _join(rank, init_method)
    cpu = torch.device("cpu")
    try:
        lines = []
        r = driver.saddle_solve(
            Options.from_args(driver.ABF_OPTS + DRIVER_ARGS), 3,
            log=lines.append, devices=[cpu] * CHIPS)
        errors = []
        for argv, n in ((["-mz", "3"], 1), ([], 1 + rank)):
            try:
                driver.saddle_solve(
                    Options.from_args(driver.ABF_OPTS + DRIVER_ARGS + argv),
                    3, log=lambda *a: None, devices=[cpu] * n)
                errors.append("")
            except ValueError as e:
                errors.append(str(e))
        slv = r["solver"]
        np.savez(os.path.join(out_dir, f"driver{rank}.npz"),
                 X=r["X"], F=r["F"], its=r["its"], reason=r["reason"],
                 history=np.array(r["history"]), mode=r["mode"],
                 dev_shape=np.array(slv.part.dev_shape),
                 shards=np.array(slv.smesh.shards), lines=np.array(lines),
                 errors=np.array(errors))
    finally:
        torch.distributed.destroy_process_group()
