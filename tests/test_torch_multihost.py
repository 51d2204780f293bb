"""The port's multi-host scaffolding (exsaddle_tpu_torch/parallel/
multihost.py) against the JAX package's (exsaddle_tpu/parallel/
multihost.py): the single-process no-op, the host-axis layout and box
ownership, the additive host-local assembly, the simulated two-host
constructor path, a real two-process gloo run on localhost whose
reductions equal the simulated ones, and the driver's sharded solve in a
two-process group (tests/test_torch_multihost_solve.py holds the solver's
own two-process runs)."""

import os

import numpy as np
import pytest
import torch

from exsaddle_tpu import driver as jdriver
from exsaddle_tpu.mesh import SaddleMesh as JSaddleMesh
from exsaddle_tpu.options import Options as JOptions
from exsaddle_tpu.parallel import multihost as jmultihost
from exsaddle_tpu.parallel.cart import CartPartition as JCartPartition
from exsaddle_tpu.parallel.cart_abf import (
    assemble_host_local as j_assemble_host_local)
from exsaddle_tpu.precond_mg import Prolongation as JProlongation

from exsaddle_tpu_torch import driver as tdriver
from exsaddle_tpu_torch.options import Options as TOptions
from exsaddle_tpu_torch.parallel import multihost
from exsaddle_tpu_torch.parallel.cart import CartPartition
from exsaddle_tpu_torch.parallel.cart_abf import (CartABFSolver,
                                                  assemble_host_local,
                                                  build_cart_abf)
from exsaddle_tpu_torch.precond_mg import Prolongation

import torch_multihost_worker as worker
from torch_parallel_common import PSEUDOICE, problems, rhs

N_HOSTS, CHIPS = worker.N_HOSTS, worker.CHIPS


@pytest.fixture(scope="module")
def layout():
    """(jax problem, port problem, port host partition, 3-level grids and
    the fine -> L-2 interpolation)."""
    j, t = problems(3, (4, 4, 4), PSEUDOICE, size=(0.1, 1.0, 1.0))
    part = multihost.host_partition(t[1], N_HOSTS, CHIPS, chip_shape=(2, 2))
    grids = [tuple(t[1].nn_u)]
    for _ in range(2):
        grids.append(tuple((m + 1) // 2 for m in grids[-1]))
    grids = grids[::-1]
    P_f = Prolongation(grids[-2], grids[-1], 3).to_scipy()
    return j, t, part, grids, P_f


def test_initialize_single_process_noop():
    assert multihost.initialize() == (1, 0)
    assert not torch.distributed.is_initialized()
    comm = multihost.HostComm()
    assert (comm.n_hosts, comm.process_id) == (1, 0)
    a = np.arange(3.0)
    assert comm.allreduce_dense(a, "x") is a


def test_host_partition_and_boxes_match_jax(layout):
    j, t, part, *_ = layout
    jpart = jmultihost.host_partition(j[1], N_HOSTS, CHIPS,
                                      chip_shape=(2, 2))
    assert part.dev_shape == jpart.dev_shape == (2, 2, N_HOSTS)
    assert part._stack_shape() == jpart._stack_shape() == (N_HOSTS, 2, 2)
    assert part.dev_boxes() == jpart.dev_boxes()
    smesh = part.device_mesh(["cpu"] * part.ndev)
    for h in range(N_HOSTS):
        mine = multihost.local_boxes(part, h, N_HOSTS)
        assert mine == jmultihost.local_boxes(jpart, h, N_HOSTS)
        # host h's boxes are shards h*CHIPS .. (h+1)*CHIPS-1 of the stack
        assert sorted(smesh.boxes.index(b) for b in mine) == list(
            range(h * CHIPS, (h + 1) * CHIPS))
    for bad in ((3,), (1, 2)):
        with pytest.raises(ValueError) as je:
            jmultihost.host_partition(j[1], N_HOSTS, CHIPS, chip_shape=bad)
        with pytest.raises(ValueError) as te:
            multihost.host_partition(t[1], N_HOSTS, CHIPS, chip_shape=bad)
        assert str(te.value) == str(je.value)


def test_host_local_assembly_additive_and_matches_jax(layout):
    """Per-host partials sum to the single-shot assembly (exactly for the
    disjoint per-box data) and equal the JAX package's partials."""
    j, t, part, grids, P_f = layout
    jpart = jmultihost.host_partition(j[1], N_HOSTS, CHIPS,
                                      chip_shape=(2, 2))
    jP_f = JProlongation(grids[-2], grids[-1], 3).to_scipy()
    full = assemble_host_local(part, t[0], t[4], P_f, grids)
    parts = []
    for h in range(N_HOSTS):
        acc = assemble_host_local(
            part, t[0], t[4], P_f, grids,
            boxes=multihost.local_boxes(part, h, N_HOSTS))
        jacc = j_assemble_host_local(
            jpart, j[0], j[4], jP_f, grids,
            boxes=jmultihost.local_boxes(jpart, h, N_HOSTS))
        for key in ("diag_u", "dmp", "sv_stack", "ps_stack", "p_elbounds",
                    "el_ids_loc", "sv_loc"):
            assert np.array_equal(acc[key], np.asarray(jacc[key])), key
        for key in ("A1", "Mp"):
            assert abs(acc[key] - jacc[key]).max() == 0.0, key
        parts.append(acc)
    for key in ("sv_stack", "ps_stack"):
        assert np.array_equal(sum(p[key] for p in parts), full[key])
    for key in ("diag_u", "dmp"):
        np.testing.assert_allclose(sum(p[key] for p in parts), full[key],
                                   rtol=1e-13, atol=1e-300)
    for key in ("A1", "Mp"):
        diff = abs(sum(p[key] for p in parts) - full[key])
        assert (diff.max() if diff.nnz else 0.0) <= \
            1e-13 * abs(full[key]).max()
    assert sorted(np.concatenate([p["el_ids_loc"] for p in parts])) == \
        list(range(t[1].nel))


def test_simulated_comm_matches_single_process(layout):
    """build_cart_abf with a simulated two-host HostComm: process 0
    assembles only its own boxes, every cross-host payload is node-sized or
    a stencil form, and the setup equals the one-process build; the solve
    (the sinker, a few iterations) matches the one-process solver's."""
    _, t, part, grids, P_f = layout
    comm = multihost.simulated_comm(part, t[0], t[4], P_f, grids,
                                    n_hosts=N_HOSTS, process_id=0)
    recorded = []
    inner = comm._allreduce

    def recording(arr, tag):
        recorded.append((tag, np.asarray(arr).nbytes))
        return inner(arr, tag)
    comm._allreduce = recording
    _, dd, st = build_cart_abf(part, t[0], *t[4:], nlevels=3,
                               multihost=comm)
    _, dd1, st1 = build_cart_abf(part, t[0], *t[4:], nlevels=3)
    got, want = worker.flatten(dd, st), worker.flatten(dd1, st1)
    assert sorted(got) == sorted(want)
    for key in want:
        scale = max(np.abs(want[key]).max(initial=0.0), 1e-300)
        assert np.abs(got[key] - want[key]).max(initial=0.0) <= \
            1e-13 * scale, key
    placement = {"sv_stack", "ps_stack", "fl_stack"}
    sums = {tag for tag, _ in recorded} - placement
    assert sums <= {"diag_u", "dmp", "A1_stencil", "Mp_stencil",
                    "p_elbounds", "fine_esteig", "rhs_diri"}, sums
    el_bytes = t[1].nel * 27 * 6 * 8
    assert all(n < el_bytes / 2 for tag, n in recorded
               if tag not in placement | {"A1_stencil", "Mp_stencil"})

    _, ts = problems(3, (4, 4, 4), ["-model", "2"])
    tpart = multihost.host_partition(ts[1], N_HOSTS, CHIPS,
                                     chip_shape=(2, 2))
    tcomm = multihost.simulated_comm(tpart, ts[0], ts[4], P_f, grids,
                                     n_hosts=N_HOSTS, process_id=1)
    devs = ["cpu"] * tpart.ndev
    slv = CartABFSolver(tpart, ts[0], *ts[4:], devs, nlevels=3,
                        multihost=tcomm)
    ref = CartABFSolver(CartPartition(ts[1], (2, 2, 2)), ts[0], *ts[4:],
                        devs, nlevels=3)
    F = rhs(ts, ref.setup["rhs_diri"])
    a, b = slv.solve(F), ref.solve(F)
    assert a["its"] == b["its"] and a["reason"] == "CONVERGED_RTOL"
    assert np.linalg.norm(a["x"] - b["x"]) <= 1e-10 * np.linalg.norm(b["x"])


def test_two_process_gloo_run_matches_simulated(layout, tmp_path):
    """Two processes on localhost (gloo): each builds the setup with a real
    HostComm, assembling its own boxes; its numbers equal the simulated
    two-host build for the same process id, bitwise (each sum has two
    operands), and the probe reductions are the sums / min-max."""
    _, t, part, grids, P_f = layout
    worker.spawn(worker.run, tmp_path)
    for rank in range(N_HOSTS):
        got = dict(np.load(os.path.join(tmp_path, f"rank{rank}.npz")))
        assert (int(got.pop("world")), int(got.pop("rank"))) == \
            (N_HOSTS, rank)
        assert (int(got.pop("n_hosts")), int(got.pop("process_id"))) == \
            (N_HOSTS, rank)
        assert got.pop("sum").tolist() == [3.0]
        assert got.pop("minmax").tolist() == [-1.0, 1.5]
        comm = multihost.simulated_comm(part, t[0], t[4], P_f, grids,
                                        n_hosts=N_HOSTS, process_id=rank)
        want = worker.flatten(*build_cart_abf(part, t[0], *t[4:], nlevels=3,
                                           multihost=comm)[1:])
        assert sorted(got) == sorted(want)
        for key in want:
            assert np.array_equal(got[key], want[key]), (rank, key)


@pytest.fixture(scope="module")
def driver_group(tmp_path_factory):
    """Each rank's saved driver run (worker.run_driver) and the one-process
    driver's result over [cpu] * 8."""
    out = tmp_path_factory.mktemp("driver")
    worker.spawn(worker.run_driver, out)
    ranks = [dict(np.load(out / f"driver{r}.npz")) for r in range(N_HOSTS)]
    one = tdriver.saddle_solve(
        TOptions.from_args(tdriver.ABF_OPTS + worker.DRIVER_ARGS), 3,
        log=lambda *a: None, devices=[torch.device("cpu")] * 8)
    return ranks, one


def test_driver_solves_in_a_group(driver_group):
    """driver.saddle_solve in a two-process group, [cpu] * 4 per rank: a
    2x2x2 device grid, each rank holding its 4 shards; both ranks return
    the same X, bitwise the one-process solve over the same shards with the
    same (HostComm) setup -- the one-process run under simulated_comm --
    and the one-process driver's (setup summed in one process) and the JAX
    driver's (-tpu 1 on 8 virtual devices) to 1e-10, with the JAX lines."""
    ranks, one = driver_group
    for rank, r in enumerate(ranks):
        assert str(r["mode"]) == "cart"
        assert r["dev_shape"].tolist() == [2, 2, 2]
        assert r["shards"].tolist() == list(range(4 * rank, 4 * rank + 4))
        assert np.array_equal(r["X"], ranks[0]["X"])
        assert np.array_equal(r["history"], ranks[0]["history"])
    r = ranks[0]
    # the same shards and setup in one process
    ctx, mesh, bc_idx, bc_vals = worker.problem(args=["-model", "2"],
                                                size=(1.0, 1.0, 1.0))
    part = one["solver"].part
    grids = [tuple(mesh.nn_u)]
    for _ in range(2):
        grids.append(tuple((m + 1) // 2 for m in grids[-1]))
    grids = grids[::-1]
    comm = multihost.simulated_comm(
        part, ctx, bc_idx, Prolongation(grids[-2], grids[-1], 3).to_scipy(),
        grids, n_hosts=N_HOSTS)
    _, ddata, setup = build_cart_abf(part, ctx, bc_idx, bc_vals, nlevels=3,
                                     multihost=comm)
    assert np.array_equal(worker.rhs(ctx, mesh, bc_idx, bc_vals,
                                     setup["rhs_diri"]), r["F"])
    sim = CartABFSolver.from_parts(part, one["solver"].dcfg, ddata, setup,
                                   ["cpu"] * 8).solve(r["F"])
    assert int(r["its"]) == sim["its"] == one["its"]
    assert str(r["reason"]) == sim["reason"] == one["reason"] == \
        "CONVERGED_RTOL"
    assert np.array_equal(r["history"], np.array(sim["history"]))
    assert np.array_equal(r["X"], sim["x"])
    X1 = one["X"]
    assert np.linalg.norm(r["X"] - X1) <= 1e-10 * np.linalg.norm(X1)
    jl = []
    jr = jdriver.saddle_solve(JOptions.from_args(
        tdriver.ABF_OPTS + [a for a in worker.DRIVER_ARGS
                            if a not in ("-device", "cpu")] + ["-tpu", "1"]),
        3, log=jl.append)
    assert r["lines"].tolist() == jl
    assert int(r["its"]) == jr["result"].its
    XJ = np.asarray(jr["X"])
    assert np.linalg.norm(r["X"] - XJ) <= 1e-10 * np.linalg.norm(XJ)


def test_driver_group_refuses_bad_layouts(driver_group):
    """In the group: a device grid whose host axis (the outermost) the
    world size does not divide raises local_boxes' error, as the JAX
    package words it; unequal device counts across ranks raise on every
    rank."""
    ranks, _ = driver_group
    jpart = JCartPartition(JSaddleMesh(3, (4, 4, 3), (1.0, 1.0, 1.0)),
                           (1, 2, 1))
    with pytest.raises(ValueError) as je:
        jmultihost.local_boxes(jpart, 0, N_HOSTS)
    for r in ranks:
        layout, counts = r["errors"].tolist()
        assert layout == str(je.value)
        assert counts == ("every process of the group must hand the same "
                          "number of devices; ranks hand [1, 2]")
