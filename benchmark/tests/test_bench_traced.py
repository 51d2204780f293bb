"""The tracer's per-layer metrics (benchmark/traced.py and its readers):
on the CPU every reader returns None and the traced pass itself runs at the
harness tests' small size with its sum rules exact on the host's clock; on
the card its seven values are finite and the sum rules hold within the
clock's logged error."""

import copy
import math
import types

import numpy as np
import pytest
import torch

from benchmark import harness, traced
from benchmark import loads as bloads

SEED = 2 ** 31 + 12345
READERS = ("host_io_ms", "graph_gap_ms", "saddle_apply_ms",
           "gram_schmidt_ms", "vcycle_ms", "coarse_solve_ms",
           "kernel_nodes_per_solve")


def _run(device, cell="solcx_ar_mx32.rhs_stream", mx=4, loads=3):
    """A run as harness.run_cell hands it to the readers, at a small size."""
    _, entry, _, config, traffic = harness.cell_files(harness.ROOT, cell)
    config = copy.deepcopy(config)
    config["flags"].update(mx=mx, my=mx, mz=mx)
    config["mg_levels"] = 3
    traffic = dict(traffic, loads=loads)
    problem = harness.reference_problem(config)
    loads_ref = bloads.make_loads(traffic, SEED, problem,
                                  harness.saddle(problem, device))
    sysprob = harness.system_problem(config)
    slv, build_s = harness.build_solver(config, sysprob, device,
                                        traffic["precision"])
    rhs_diri = np.asarray(slv.setup["rhs_diri"])
    lines = []
    return types.SimpleNamespace(
        cell=entry, config=config, traffic=traffic, solver=slv,
        device=device, seed=SEED, build_s=build_s,
        loads=[F + rhs_diri for F in loads_ref], log=lines.append,
        lines=lines)


def test_readers_return_none_on_the_cpu_and_the_pass_runs():
    run = _run(torch.device("cpu"))
    for name in READERS:
        assert harness.metric_reader(name)(run) is None
    assert run.traced_pass is None
    out = traced.measure(run, n=2)
    assert out["drops"] == 0 and out["kernel_nodes_per_solve"] is None
    for name in traced.SPAN_METRICS:
        assert math.isfinite(out[name]) and out[name] >= 0.0
    # one clock: the host's, so both rules hold exactly
    assert out["rule1_worst_ns"] == 0 and out["rule2_worst_ns"] == 0
    assert out["vcycle_ms"] >= out["coarse_solve_ms"] > 0.0
    assert any("traced pass spans" in line for line in run.lines)


@pytest.mark.gpu
def test_traced_pass_on_the_card(card):
    run = _run(card, mx=8)
    out = {name: harness.metric_reader(name)(run) for name in READERS}
    for name, value in out.items():
        assert value is not None and math.isfinite(value), name
    p = run.traced_pass
    assert p["drops"] == 0
    assert p["rule1_worst_ns"] <= p["rule1_allowed_ns"]
    # the piece spans are disjoint and inside the solve: within the
    # %globaltimer step per piece boundary
    assert p["rule2_worst_ns"] <= 0.01 * 1e6 * p["solve_ms"]
    assert out["vcycle_ms"] >= out["coarse_solve_ms"] > 0.0
    assert out["kernel_nodes_per_solve"] > 0
