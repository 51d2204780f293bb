"""One process of tests/test_torch_multihost.py's two-process run. It imports
only torch and the port, so a spawned child starts without JAX.

Each rank joins a gloo group on localhost, builds the cartesian ABF setup
of the mx=4 pseudoice problem over a 2 hosts x 4 devices layout with a
real HostComm (so it assembles only its own boxes and the partials ride
torch.distributed), and saves what it got (`run`); or drives the driver's
sharded solve inside the group and saves the error it raised
(`run_driver`)."""

import os

import numpy as np
import torch

N_HOSTS, CHIPS = 2, 4


def problem():
    """(ctx, mesh, bc_idx, bc_vals) of the mx=4 pseudoice problem."""
    from exsaddle_tpu_torch import models
    from exsaddle_tpu_torch.mesh import SaddleMesh
    from exsaddle_tpu_torch.options import Options
    ctx = models.ModelContext(
        Options.from_args(["-model", "11", "-size_x", "0.1"]), 3,
        lame=False, log=lambda *a, **k: None)
    mesh = SaddleMesh(3, (4, 4, 4), (0.1, 1.0, 1.0))
    bc_idx, bc_vals = models.create_bc_list(ctx, mesh)
    return ctx, mesh, bc_idx, bc_vals


def flatten(ddata, setup):
    """{name: array} of a cart_abf setup's numbers, for np.savez."""
    out = {"rhs_diri": np.asarray(setup["rhs_diri"])}
    for key, v in ddata.items():
        leaves = v if isinstance(v, (list, tuple)) else [v]
        for i, a in enumerate(leaves):
            for j, b in enumerate(a if isinstance(a, tuple) else [a]):
                out[f"{key}.{i}.{j}"] = np.asarray(b)
    return out


def run(rank, init_method, out_dir):
    """Entry point of rank `rank` (torch.multiprocessing.spawn's first
    argument)."""
    torch.set_num_threads(1)
    from exsaddle_tpu_torch.parallel import multihost
    from exsaddle_tpu_torch.parallel.cart_abf import build_cart_abf
    world, got_rank = multihost.initialize(init_method, N_HOSTS, rank)
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


def run_driver(rank, init_method, out_dir):
    """Entry point of rank `rank` for the driver in a group: the abf.opts
    tree at mx=4 handed two CPU devices. Saves the message of the
    RuntimeError the driver raised ("" when it solved)."""
    torch.set_num_threads(1)
    from exsaddle_tpu_torch import driver
    from exsaddle_tpu_torch.options import Options
    from exsaddle_tpu_torch.parallel import multihost
    multihost.initialize(init_method, N_HOSTS, rank)
    try:
        opts = Options.from_args(driver.ABF_OPTS + [
            "-model", "11", "-size_x", "0.1", "-mx", "4", "-device", "cpu"])
        try:
            driver.saddle_solve(opts, 3, log=lambda *a: None,
                                devices=[torch.device("cpu")] * 2)
            msg = ""
        except RuntimeError as e:
            msg = str(e)
        np.savez(os.path.join(out_dir, f"driver{rank}.npz"), msg=msg)
    finally:
        torch.distributed.destroy_process_group()
