"""The port's tracer (exsaddle_tpu_torch/trace.py) on the CPU, where
ABFSolver(loop="device") runs the plain driver (graphs.run_plain) and the
device spans are read on the host clock.

- a traced solve_ir and solve give the untraced bits (x, rounds or its,
  histories, counts), and an untraced solver emits no mark;
- the span tree: one solve and one solve_call per call, saddle_apply per
  FGMRES iteration and cycle start, vcycle and coarse_solve per GCR step,
  every span inside its parent;
- the set-up stages: EXSADDLE_SETUP_PROFILE=1 prints the stage lines it
  printed before the tracer (the fine esteig total included), with or
  without a trace, and a trace keeps them as host spans under `build`;
- the counts by name, kernel_nodes on the CPU (None), a full buffer."""

import re

import numpy as np
import pytest
import torch

from exsaddle_tpu_torch import abf as tabf
from exsaddle_tpu_torch import bench, graphs
from exsaddle_tpu_torch.trace import Trace, span

torch.set_num_threads(1)

ENTRIES = ("solve_ir", "solve")
_SETUP_LINE = re.compile(r"^\[setup\] (.+): \d+\.\d\d s$")
# the stage lines of a 3-level float32 build with refinement on the CPU
STAGES = ["factored_host", "parity op build", "rhs_diri", "f64 saddle op",
          "prolongations", "fine diagonal", "L-2 Galerkin elements",
          "L-2 stencil + csr", "deep Galerkin RAPs", "esteig level 1",
          "fine esteig join", "fine esteig total (overlapped)",
          "coarse inverse", "Schur-pre assembly", "p-block spectrum",
          "device cast", "ir op64 build"]


def _call(slv, F, entry):
    return slv.solve_ir(F, rtol=1e-8) if entry == "solve_ir" else slv.solve(F)


@pytest.fixture(scope="module")
def solved():
    """Pseudoice mx=4, 3 levels, float32 with refinement: each entry solved
    untraced and then traced (solve ids 1 and 2), with Trace.mark counted
    around each."""
    p = bench._build_problem(4, with_rhs=True)
    base = tabf.ABFSolver(p["mesh"], p["fes"], p["coeff"], p["bc_idx"],
                          p["bc_vals"], device="cpu", nlevels=3,
                          dtype=torch.float32, ir=True, loop="device")
    F = p["F_raw"] + base.setup["rhs_diri"]
    tr = Trace("cpu")
    traced = tabf.ABFSolver.from_parts(base.cfg, base.data, base.setup,
                                       device="cpu", dtype=torch.float32,
                                       ir=True, loop="device", trace=tr)
    calls = []
    mark = Trace.mark

    def counted(self, *a, **k):
        calls.append(a[0])
        return mark(self, *a, **k)

    out = {}
    with pytest.MonkeyPatch.context() as m:
        m.setattr(Trace, "mark", counted)
        for entry in ENTRIES:
            n0 = len(calls)
            untraced = _call(base, F, entry)
            n1 = len(calls)
            out[entry] = (untraced, _call(traced, F, entry), n1 - n0,
                          len(calls) - n1)
    return base, out, tr.collect()


@pytest.mark.parametrize("entry", ENTRIES)
def test_traced_solve_is_bitwise_untraced(solved, entry):
    base, out, _ = solved
    a, b, marks_untraced, marks_traced = out[entry]
    assert base.trace is None and base._dev.ctl.trace is None
    assert marks_untraced == 0 and marks_traced > 0
    assert np.array_equal(a["x"], b["x"])
    assert a["history"] == b["history"]
    assert a["counts"] == b["counts"]
    keys = (("rounds", "inner_its", "stalled", "rnorm") if entry == "solve_ir"
            else ("its", "reason", "rnorm"))
    assert [a[k] for k in keys] == [b[k] for k in keys]


@pytest.mark.parametrize("entry", ENTRIES)
def test_span_tree(solved, entry):
    _, out, col = solved
    res = out[entry][1]
    counts = res["counts"]
    k = ENTRIES.index(entry) + 1
    spans = col["spans"]
    assert col["drops"] == 0 and col["calibration"] == []
    mine = [s for s in spans if s.solve == k]

    def n(name, device=True):
        return sum(s.name == name and s.device == device for s in mine)
    assert n("solve") == 1 and n("solve_call", False) == 1
    assert [s.name for s in mine if not s.device] == [
        "solve_call", "stage_in", "launch", "read_out"]
    assert n("saddle_apply") == counts["fgmres_its"] + counts["fgmres_cycles"]
    assert n("vcycle") == n("coarse_solve") == counts["gcr_steps"] > 0
    assert n("gram_schmidt") == counts["fgmres_its"] + counts["gcr_steps"]
    if entry == "solve_ir":
        assert counts["ir_rounds"] == res["rounds"]
        assert counts["ir_solves"] == 1
        assert counts["fgmres_its"] == res["inner_its"]
    else:
        assert counts["ir_rounds"] == counts["ir_solves"] == 0
        assert counts["fgmres_its"] == res["its"]
    for s in mine:
        assert s.end is not None and s.start <= s.end
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start <= s.start and s.end <= p.end
            assert p.device == s.device
    # the device solve inside the host's launch, on the one clock
    launch = next(s for s in mine if s.name == "launch")
    dev = next(s for s in mine if s.name == "solve")
    assert launch.start <= dev.start and dev.end <= launch.end
    # the pieces are the device solve's children, one after another
    pieces = [s for s in mine if s.device and s.parent is not None
              and spans[s.parent].name == "solve"]
    assert all(a.end <= b.start for a, b in zip(pieces, pieces[1:]))


def test_kernel_nodes_and_host_loop_on_the_cpu(solved):
    base, out, _ = solved
    assert base.kernel_nodes(out["solve_ir"][0]["counts"]) is None
    with pytest.raises(ValueError, match="device and plain loops"):
        tabf.ABFSolver.from_parts(base.cfg, base.data, base.setup,
                                  device="cpu", dtype=torch.float32,
                                  loop="host", trace=Trace("cpu"))


@pytest.mark.parametrize("profile,traced", [(True, False), (True, True),
                                            (False, True), (False, False)],
                         ids=["env", "env+trace", "trace", "neither"])
def test_setup_stages(monkeypatch, capsys, profile, traced):
    """EXSADDLE_SETUP_PROFILE=1 prints the stage lines (STAGES, as before
    the tracer); a trace keeps them as host spans under `build`, the
    esteig total as `esteig` over the stages it overlaps; with neither,
    nothing is printed."""
    if profile:
        monkeypatch.setenv("EXSADDLE_SETUP_PROFILE", "1")
    else:
        monkeypatch.delenv("EXSADDLE_SETUP_PROFILE", raising=False)
    tr = Trace("cpu") if traced else None
    p = bench._build_problem(4)
    capsys.readouterr()
    tabf.ABFSolver(p["mesh"], p["fes"], p["coeff"], p["bc_idx"],
                   p["bc_vals"], device="cpu", nlevels=3,
                   dtype=torch.float32, ir=True, loop="device", trace=tr)
    err = capsys.readouterr().err
    names = [m.group(1) for m in map(_SETUP_LINE.match, err.splitlines())
             if m]
    assert names == (STAGES if profile else [])
    assert ("[setup]" in err) == profile
    if not traced:
        return
    spans = tr.collect()["spans"]
    assert all(not s.device and s.solve is None for s in spans)
    assert spans[0].name == "build" and spans[0].parent is None
    esteig = next(i for i, s in enumerate(spans) if s.name == "esteig")
    kept = [("fine esteig total (overlapped)" if s.name == "esteig"
             else s.name) for s in spans[1:]]
    assert sorted(kept) == sorted(STAGES)
    under = [s.name for s in spans if s.parent == esteig]
    assert under == ["L-2 Galerkin elements", "L-2 stencil + csr",
                     "deep Galerkin RAPs", "esteig level 1",
                     "fine esteig join"]
    for s in spans[1:]:
        parent = spans[s.parent]
        assert parent.start <= s.start <= s.end <= parent.end


def test_marks_only_while_marking_and_a_full_buffer_drops():
    tr = Trace("cpu", capacity=5)
    assert span(None, "x") is span(tr, "x")         # the shared no-op
    with span(tr, "x"):
        pass
    assert tr.marks == 0
    with tr.marking(), span(tr, "solve"):
        with span(tr, "a"):
            pass
        with span(tr, "b"):
            pass
    with tr.marking(), tr.span("solve", entry=True):
        pass
    col = tr.collect()
    # six marks of the first span fit but its end; the second is dropped
    assert tr.marks == 8 and col["marks"] == 5 and col["drops"] == 3
    solve, a, b = col["spans"]
    assert (solve.name, a.name, b.name) == ("solve", "a", "b")
    assert solve.end is None and a.parent == b.parent == 0
    assert a.end <= b.start and solve.solve == a.solve == 0


def test_count_slots_by_name():
    ctl = graphs.Control("cpu", n_count=3)
    assert ctl.count_slots("x", "y") == 0 and ctl.count_slots("z") == 2
    with pytest.raises(ValueError, match="counter slots"):
        ctl.count_slots("w")
    named = ctl.named(np.array([4, 5, 6]))
    assert named == {"x": 4, "y": 5, "z": 6}
    assert ctl.slots(named) == [4, 5, 6]
    assert len(graphs._counter_names()) == len(graphs._counters())
