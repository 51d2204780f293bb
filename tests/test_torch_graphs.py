"""The port's CUDA-graph capture (exsaddle_tpu_torch/graphs.py and the
captured bodies of abf.make_abf_solver), checked on the CPU.

A CUDA graph replays device work only: a body that reads a device value on
the host cannot be captured. The bodies the card captures (FGMRES's
operator mult, the V-cycle mg_pc, the p-block p_solve and, with fixed
V-cycles, the whole fieldsplit pc_apply) are run here with every host read
of a tensor patched to raise.
The CPU never captures: graphs.Captured refuses CPU tensors, and the CPU
solve, composed of the bodies ABFSolver.bodies() returns, gives bitwise the
numbers the port gave before the bodies were split out for capture. The
graphs themselves run on the card (tests/test_torch_gpu.py)."""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from exsaddle_tpu_torch import abf, bench, graphs

torch.set_num_threads(1)

# every way a tensor's value reaches the host
HOST_READS = ("item", "cpu", "numpy", "tolist", "__float__", "__bool__",
              "__int__")


def _host_read(self, *a, **k):
    raise AssertionError("a tensor was read on the host")


@pytest.fixture(scope="module")
def solvers():
    """A 3D mx=4 pseudoice float64 solver (GCR u-block) and one over the
    same setup with 2 fixed V-cycles in place of GCR."""
    p = bench._build_problem(4)
    slv = abf.ABFSolver(p["mesh"], p["fes"], p["coeff"], p["bc_idx"],
                        p["bc_vals"], device="cpu", nlevels=3)
    fixed = abf.ABFSolver.from_parts(
        dataclasses.replace(slv.cfg, u_fixed_vcycles=2), slv.data, slv.setup,
        device="cpu", dtype=torch.float64)
    return slv, fixed


def _input(slv, name):
    op = slv.data["op"]
    shape = {"mult": (op.ndof,), "mg_pc": (op.nu,), "p_solve": op.p_shape,
             "pc_apply": (op.ndof,)}[name]
    rng = np.random.default_rng(3)
    return torch.as_tensor(rng.standard_normal(shape))


@pytest.mark.parametrize("name,which", [("mult", 0), ("mg_pc", 0),
                                        ("p_solve", 0), ("pc_apply", 1)],
                         ids=["mult", "mg_pc", "p_solve", "pc_apply_fixed2"])
def test_captured_bodies_read_nothing_on_the_host(solvers, monkeypatch,
                                                  name, which):
    """Each body the card captures runs to the same result with every host
    read of a tensor raising."""
    slv = solvers[which]
    body = slv.bodies()[name]
    x = _input(slv, name)
    want = body(x)
    for attr in HOST_READS:
        monkeypatch.setattr(torch.Tensor, attr, _host_read)
    got = body(x)
    monkeypatch.undo()
    assert torch.equal(got, want)


def test_host_read_patch_catches_a_read(monkeypatch):
    """The patch of the test above does catch a host read."""
    for attr in HOST_READS:
        monkeypatch.setattr(torch.Tensor, attr, _host_read)
    x = torch.ones(())
    for read in (lambda: x.item(), lambda: float(x), lambda: bool(x),
                 lambda: int(x), lambda: x.tolist()):
        with pytest.raises(AssertionError):
            read()


@pytest.mark.parametrize("inputs", [
    (torch.zeros(3),),
    (np.zeros(3),),
    (),
], ids=["cpu_tensor", "numpy_array", "no_input"])
def test_captured_refuses_what_it_cannot_capture(inputs):
    with pytest.raises(ValueError):
        graphs.Captured(lambda *a: a[0] * 2, *inputs)


@pytest.mark.parametrize("enabled", [True, False])
def test_collector_held_during_a_capture(enabled):
    """graphs.collector_held keeps Python's cyclic collector off for its
    block (a collection inside a capture could finalize a dead graph and
    invalidate the capture) and restores the collector's state after it,
    also when the block raises."""
    import gc
    was = gc.isenabled()
    (gc.enable if enabled else gc.disable)()
    try:
        with graphs.collector_held():
            assert not gc.isenabled()
        assert gc.isenabled() == enabled
        with pytest.raises(RuntimeError):
            with graphs.collector_held():
                raise RuntimeError("capture failed")
        assert gc.isenabled() == enabled
    finally:
        (gc.enable if was else gc.disable)()


def test_cpu_solver_captures_nothing(solvers):
    slv, fixed = solvers
    for s in (slv, fixed):
        assert s.capture_seconds == 0.0
        assert not any(isinstance(b, graphs.Captured)
                       for b in s.bodies().values())
        assert graphs.replays(s.bodies()) == 0


# one float32 IR solve at mx=4 (3 levels, abf.opts schedule, one intra-op
# thread) by the port before its solve was composed of the capturable
# bodies: rounds, inner iterations, sha256 of x's bytes, history (float.hex)
IR_MX4 = (3, 53,
          "027900c68469717ea3f308d45ba40766d62fb2fd966d85694908370bbd9fd066",
          ["0x1.447a8afa2e985p-8", "0x1.b574d62c22f39p-18",
           "0x1.abe87ee6b55bdp-33", "0x1.7fa4462679c56p-46"])


def test_cpu_ir_solve_bitwise_unchanged():
    p = bench._build_problem(4, with_rhs=True)
    slv = abf.ABFSolver(p["mesh"], p["fes"], p["coeff"], p["bc_idx"],
                        p["bc_vals"], device="cpu", dtype=torch.float32,
                        nlevels=3, ir=True)
    r = slv.solve_ir(p["F_raw"] + slv.setup["rhs_diri"], rtol=1e-8)
    rounds, its, digest, history = IR_MX4
    assert (r["rounds"], r["inner_its"]) == (rounds, its)
    assert r["converged"] and not r["stalled"]
    assert hashlib.sha256(np.ascontiguousarray(r["x"]).tobytes()
                          ).hexdigest() == digest
    assert [float(h).hex() for h in r["history"]] == history
