"""The port's bench (exsaddle_tpu_torch/bench.py) against the JAX package's
bench.py on the CPU: the tuned schedule and its environment overrides, the
level rule, one apply's FLOP, byte and nonzero counts, the power-iteration
rate that scales the timed apply, the tuned IR solve's rounds and inner
iterations, and main()'s one JSON line; the port's bench imports neither
JAX, nor the JAX package, nor bench.py, and refuses to run without CUDA
unless given the CPU. These tests check counts, not times: each schedule is
timed by one solve here (SOLVE_REPS)."""

import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bench as jbench
from exsaddle_tpu import matfree as jmf
from exsaddle_tpu.abf import ABFSolver as JABFSolver

from exsaddle_tpu_torch import bench as tbench
from exsaddle_tpu_torch import matfree as tmf
from exsaddle_tpu_torch.abf import ABFSolver as TABFSolver
from exsaddle_tpu_torch.mesh import SaddleMesh

from test_torch_abf import _jax_solver, _own, _same_solve

torch.set_num_threads(1)

BENCH_ENV = ("BENCH_MX", "BENCH_INNER", "BENCH_REPS", "BENCH_SOLVE_MX",
             "BENCH_SOLVE_RTOL", "BENCH_INNER_RTOL", "BENCH_GCR_RTOL",
             "BENCH_GCR_RESTART", "BENCH_CHEB_PRE")


@pytest.fixture
def clean_env(monkeypatch):
    for k in BENCH_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(tbench, "SOLVE_REPS", 1)
    return monkeypatch


def test_bench_solver_kw_matches_bench_py(clean_env):
    assert tbench.bench_solver_kw(env=False) == jbench.bench_solver_kw(
        env=False)
    assert tbench.bench_solver_kw() == jbench.bench_solver_kw()
    for k, v in (("BENCH_INNER_RTOL", "5e-4"), ("BENCH_GCR_RTOL", "0.05"),
                 ("BENCH_GCR_RESTART", "8"), ("BENCH_CHEB_PRE", "3")):
        clean_env.setenv(k, v)
    got = tbench.bench_solver_kw()
    assert got == jbench.bench_solver_kw()
    assert (got["rtol"], got["gcr_restart"]) == (5e-4, 8)
    assert tbench.bench_solver_kw(env=False) == jbench.bench_solver_kw(
        env=False)


@pytest.mark.parametrize("mx,nlevels", [(8, 3), (16, 3), (32, 4), (64, 5)])
def test_level_rule(mx, nlevels):
    mesh = SaddleMesh(3, (mx, mx, mx), (0.1, 1.0, 1.0))
    assert tbench.bench_nlevels(mesh) == nlevels


def _ops(mx):
    """The float32 parity operators of bench.py's and the port's mx^3
    problem: (JAX mesh, JAX operator, port mesh, port operator)."""
    jp, tp = jbench._build_problem(mx), tbench._build_problem(mx)
    bc = np.zeros(jp["mesh"].ndof)
    bc[jp["bc_idx"]] = 1.0
    jop = jmf.ParityMatFreeOperator.build(jp["mesh"], jp["fes"],
                                          jp["coeff"], bc, dtype=jnp.float32)
    top = tmf.ParityMatFreeOperator.build(tp["mesh"], tp["fes"],
                                          tp["coeff"], bc,
                                          dtype=torch.float32, device="cpu")
    return jp["mesh"], jop, tp["mesh"], top


@pytest.mark.parametrize("mx", [4, 6])
def test_apply_counts_match_bench_py(mx):
    jmesh, jop, tmesh, top = _ops(mx)
    assert tbench._apply_flops_bytes(tmesh, top, 4) == \
        jbench._apply_flops_bytes(jmesh, jop, 4)
    nnz = jmf.assembled_nnz(jmesh)
    assert tmf.assembled_nnz(tmesh) == nnz
    # bench.py:299
    assert tbench._csr_bytes(tmesh) == nnz * 8 + 3 * jmesh.ndof * 4


def test_bench_apply_power_rho_matches_jax():
    """power_rho, the rate folded into the timed operator, is that of 30
    normalised float32 applies of the JAX mult_tree on the same x, to 1e-4;
    the scaled loop is stable and the CPU run says it is eager."""
    out = tbench.bench_apply(4, inner=3, reps=5, device="cpu")
    jmesh, jop, _, _ = _ops(4)
    aux = jmf.tree_aux(jop)
    tree = jmf.to_tree(jop, jnp.asarray(np.random.default_rng(0)
                                        .standard_normal(jmesh.ndof)
                                        .astype(np.float32)))
    for _ in range(30):
        y = jmf.mult_tree(jop, aux, tree)
        n = jmf.tree_norm(y)
        tree = jax.tree.map(lambda a: a / n, y)
    rho = float(n)
    kb = out["kernel_breakdown"]
    assert abs(kb["power_rho"] - rho) <= 1e-4 * rho
    assert 1e-12 < kb["scaled_loop_final_norm"] < 1e12
    assert out["apply_timing"] == "eager" and "roofline" not in kb
    assert out["t_apply_us"] == out["t_apply_eager_us"] > 0
    assert out["assembled_nnz"] == jmf.assembled_nnz(jmesh)
    assert kb["trace_top_ops"]["source"] == "host"


def test_tuned_schedule_float64_matches_jax():
    """The tuned schedule itself, without float32 rounding: the float64
    direct solve at mx=4 (3 levels) gives the JAX reason, iteration count,
    history and x to 1e-8, from the port's own setup."""
    kw = dict(nlevels=3, **jbench.bench_solver_kw(env=False))
    jslv, F = _jax_solver(3, (4, 4, 4), (0.1, 1.0, 1.0), 11, **kw)
    rj = jslv.solve(F)
    assert rj["reason"] == "CONVERGED_RTOL"
    tslv, Ft = _own(3, (4, 4, 4), (0.1, 1.0, 1.0), 11, **kw)
    _same_solve(tslv.solve(Ft), rj)


def test_bench_solve_matches_jax(clean_env):
    """Under the tuned schedule, mx=6 (3 levels): the JAX IR solve's rounds,
    and inner iterations within 20% of its count, the band of the JAX
    package's own bench anchor (test_abf_compiled.py). In float32 this
    count is chaotic: relative perturbations of 1e-7 in F moved it over
    42-51 in the JAX package and 47-52 in the port (6 right-hand sides
    each), so the 2-iteration standard of test_torch_abf_ir.py does not
    apply. Every schedule reaches the true 1e-8, recomputed in float64."""
    out = tbench.bench_solve(6, 1e-8, device="cpu")
    p = jbench._build_problem(6, with_rhs=True)
    jslv = JABFSolver(p["mesh"], p["fes"], p["coeff"], p["bc_idx"],
                      p["bc_vals"], dtype=jnp.float32, nlevels=3, ir=True,
                      **jbench.bench_solver_kw(env=False))
    rj = jslv.solve_ir(p["F_raw"] + jslv.setup["rhs_diri"], rtol=1e-8)
    assert rj["converged"]
    assert out["solve_nlevels"] == 3
    assert out["solve_ir_rounds"] == rj["rounds"]
    assert abs(out["solve_outer_its"] - rj["inner_its"]) <= \
        0.2 * rj["inner_its"]
    for pre in ("solve_", "solve_abfopts_"):
        assert out[pre + "converged"] and not out[pre + "stalled"]
        assert out[pre + "recomputed_rel_resid"] <= 1e-8
        assert len(out[pre + "spread_s"]) == 3


def test_main_prints_one_json_line(clean_env, capsys):
    # a looser true tolerance than the bench's 1e-8 keeps the CPU run short
    for k, v in (("BENCH_MX", "4"), ("BENCH_SOLVE_MX", "4"),
                 ("BENCH_INNER", "2"), ("BENCH_SOLVE_RTOL", "1e-6")):
        clean_env.setenv(k, v)
    tbench.main(device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "extras"}
    assert line["metric"] == "pseudoice3d_abf_solve_mx4_rtol1e-06_cpu"
    assert line["value"] == line["extras"]["solve_seconds"] > 0
    assert line["extras"]["device_name"] == "cpu"


def test_main_needs_cuda_unless_given_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        tbench.main()


def test_bench_imports_no_jax():
    code = ("import sys, exsaddle_tpu_torch.bench;"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'bench', "
            "'exsaddle_tpu') or m.startswith(('jax.', 'exsaddle_tpu.')));"
            "print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.slow
def test_abf_bench_scale_anchor_mx16():
    """The port's counterpart of tests/test_abf_compiled.py's anchor: mx=16
    pseudoice under the committed tuned schedule, 3 +- 1 IR rounds and
    27-41 inner iterations."""
    p = tbench._build_problem(16, with_rhs=True)
    slv = TABFSolver(p["mesh"], p["fes"], p["coeff"], p["bc_idx"],
                     p["bc_vals"], device="cpu", dtype=torch.float32,
                     nlevels=3, ir=True, **tbench.bench_solver_kw(env=False))
    res = slv.solve_ir(p["F_raw"] + slv.setup["rhs_diri"], rtol=1e-8)
    assert res["converged"]
    assert abs(res["rounds"] - 3) <= 1
    assert 27 <= res["inner_its"] <= 41, res["inner_its"]
