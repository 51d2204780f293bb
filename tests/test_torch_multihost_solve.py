"""The port's sharded ABF solve across processes (exsaddle_tpu_torch/
parallel/: ShardMesh's process identity, its cross-process halos, ghost
planes, psum and gathers) on the CPU, in two gloo processes on localhost.

The same shards in one process and in two give the same bits: every
exchanged plane is copied exactly, and the psum and the L-2 gather fold
every shard's partial in global shard order in both. So the two-process
solve of the mx=4 pseudoice problem over host_partition(mesh, 2, 4,
chip_shape=(2, 2)) -- and over 2 x 1 shards, where every halo crosses --
equals the one-process solve over the same shards bitwise: with the setup
built by every process alone (multihost=None) against the one-process
multihost=None solve, and with a real HostComm against the one-process
solve under simulated_comm (its two-operand sums are the gloo sums). Against
the JAX CartABFSolver over the same partition on conftest's 8 virtual
devices (2 for 2 x 1 shards): the same iteration count and reason, history
and x to 1e-10, the tolerance tests/test_torch_cart_abf.py states for the
one-process port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exsaddle_tpu.mesh import SaddleMesh as JSaddleMesh
from exsaddle_tpu.parallel import multihost as jmultihost
from exsaddle_tpu.parallel.cart import CartPartition as JCartPartition
from exsaddle_tpu.parallel.cart_abf import CartABFSolver as JCartABFSolver

from exsaddle_tpu_torch.mesh import SaddleMesh
from exsaddle_tpu_torch.parallel import multihost
from exsaddle_tpu_torch.parallel.cart import CartPartition
from exsaddle_tpu_torch.parallel.shard_mesh import ShardMesh

import torch_multihost_worker as worker
from torch_parallel_common import PSEUDOICE, assert_same_solve, problems

N_HOSTS = worker.N_HOSTS
# chips per process -> the device grid per process (x, y)
LAYOUTS = {"x4": (4, (2, 2)), "x1": (1, (1, 1))}
MODES = ("none", "comm")


def _load(path):
    return dict(np.load(path))


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def solved(request, tmp_path_factory):
    """(layout, partition, {mode: one-process result}, {mode: [result of
    each rank]}) of one layout."""
    chips, chip_shape = LAYOUTS[request.param]
    out = tmp_path_factory.mktemp(f"solve_{request.param}")
    worker.spawn(worker.run_solve, out, chips, chip_shape)
    part = multihost.host_partition(worker.problem()[1], N_HOSTS, chips,
                                    chip_shape=chip_shape)
    ref = {mode: worker.one_process(part, mode) for mode in MODES}
    got = {mode: [_load(out / f"solve_{mode}{r}.npz") for r in
                  range(N_HOSTS)] for mode in MODES}
    return request.param, part, ref, got


@pytest.mark.parametrize("mode", MODES)
def test_two_process_solve_is_the_one_process_solve(solved, mode):
    """Both ranks: its, reason, history and x bitwise the one-process
    solve's over the same shards, F the same; each rank held its own block
    of shards, and planes and partials crossed processes."""
    layout, part, ref, got = solved
    want = ref[mode]
    chips = part.ndev // N_HOSTS
    assert want["reason"] == "CONVERGED_RTOL"
    for rank, r in enumerate(got[mode]):
        assert r["shards"].tolist() == list(range(rank * chips,
                                                  (rank + 1) * chips))
        assert np.array_equal(r["F"], want["F"]), (layout, rank)
        assert int(r["its"]) == want["its"] and str(r["reason"]) == \
            want["reason"] and int(r["state"]) == want["state"]
        assert np.array_equal(r["history"], want["history"]), (layout, rank)
        assert np.array_equal(r["x"], want["x"]), (layout, rank)
        assert int(r["halos"]) == want["halos"] > 0
        # one host-staged message per halo call at least (the host axis z
        # is the only one that crosses), and the psums' gathers
        assert int(r["traffic_messages"]) >= int(r["halos"])
        assert int(r["traffic_gathers"]) > want["its"]
        assert want["traffic_messages"] == want["traffic_gathers"] == 0


def test_two_process_solve_matches_jax(solved):
    """The JAX CartABFSolver over the same host partition on conftest's
    virtual devices (8, or 2 for 2 x 1 shards): the same its and reason,
    history and x to 1e-10."""
    layout, part, _, got = solved
    chips, chip_shape = LAYOUTS[layout]
    j, _ = problems(3, (4, 4, 4), PSEUDOICE, size=(0.1, 1.0, 1.0))
    jpart = jmultihost.host_partition(j[1], N_HOSTS, chips,
                                      chip_shape=chip_shape)
    jslv = JCartABFSolver(jpart, j[0], *j[4:], jax.devices()[:part.ndev],
                          dtype=jnp.float64, nlevels=3)
    for mode in MODES:
        rj = jslv.solve(got[mode][0]["F"])
        for r in got[mode]:
            assert np.array_equal(r["F"], got[mode][0]["F"])
            assert_same_solve({"its": int(r["its"]), "state": int(r["state"]),
                               "reason": str(r["reason"]),
                               "history": r["history"], "x": r["x"]}, rj)


def test_collectives_across_processes_are_bitwise(tmp_path):
    """halo_add_axis (one grid and two in one exchange), ghost_extend_axis
    along every axis, psum and all_parts over a 2x2x2 grid: two processes
    of 4 shards give every shard the one-process bits."""
    worker.spawn(worker.run_collectives, tmp_path)
    want = worker.collectives(ShardMesh((2, 2, 2), ["cpu"] * 8))
    for rank in range(N_HOSTS):
        got = _load(tmp_path / f"coll{rank}.npz")
        assert got.pop("shards").tolist() == list(range(4 * rank,
                                                        4 * rank + 4))
        assert int(got.pop("traffic_messages")) > 0
        assert int(got.pop("traffic_gathers")) > 0
        got = {k: v for k, v in got.items() if not k.startswith("traffic")}
        assert sorted(got) == sorted(want)
        for key in want:
            assert np.array_equal(got[key], want[key]), (rank, key)


@pytest.mark.parametrize("dev_shape", [(2, 2, 2), (1, 1, 2), (2, 1, 4),
                                       (2, 2, 3)])
def test_local_shards_follow_local_boxes(dev_shape):
    """Process r of W holds the contiguous block of the z-major stack
    whose boxes local_boxes gives it, and a ShardMesh over it takes its
    rank and world from the block; an outer axis W does not divide raises
    the JAX package's error."""
    part = CartPartition(SaddleMesh(3, (4, 4, 12), (0.1, 1.0, 1.0)),
                         dev_shape)
    jpart = JCartPartition(JSaddleMesh(3, (4, 4, 12), (0.1, 1.0, 1.0)),
                           dev_shape)
    for world in (1, 2, 4):
        if dev_shape[-1] % world:
            with pytest.raises(ValueError) as te:
                multihost.local_shards(part, 0, world)
            with pytest.raises(ValueError) as je:
                jmultihost.local_boxes(jpart, 0, world)
            assert str(te.value) == str(je.value)
            continue
        n = part.ndev // world
        for rank in range(world):
            shards = multihost.local_shards(part, rank, world)
            assert shards == list(range(rank * n, (rank + 1) * n))
            smesh = ShardMesh(dev_shape, ["cpu"] * n, shards=shards)
            assert (smesh.rank, smesh.world) == (rank, world)
            assert sorted(smesh.boxes[i] for i in shards) == sorted(
                jmultihost.local_boxes(jpart, rank, world))
    assert part.device_mesh(["cpu"] * part.ndev).shards == tuple(
        range(part.ndev))
    for shards in (range(1, 5), range(3), (0, 2)):
        with pytest.raises(ValueError):
            ShardMesh((2, 2, 2), ["cpu"] * 4, shards=shards)


def test_host_devices_never_falls_back_to_the_cpu(monkeypatch):
    """host_devices: the CPU only when asked; every visible CUDA device
    otherwise, and an error when there is none."""
    assert multihost.host_devices("cpu") == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.host_devices()
    with pytest.raises(ValueError):
        multihost.host_devices("tpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert multihost.host_devices() == multihost.host_devices("cuda") == [
        torch.device("cuda", 0), torch.device("cuda", 1)]
