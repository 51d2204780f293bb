"""The PyTorch port's driver (abf.opts route) against the JAX driver, its
output flags on both routes, and the port's import boundary.

The same argv goes to both drivers at mx=4 pseudoice: the port with
-device cpu, the JAX driver with -tpu 1 (its jitted ABF dispatch; with the 8
virtual CPU devices of conftest.py that is the cartesian solver, which agrees
with the single-device one to 1e-10). Every printed line must agree, the
residual monitor values to 1e-6 relative."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from exsaddle_tpu import driver as jdriver
from exsaddle_tpu.options import Options as JOptions

from exsaddle_tpu_torch import driver as tdriver
from exsaddle_tpu_torch.options import Options as TOptions

# one intra-op thread: the suite runs several test processes side by
# side, and these small CPU solves gain nothing from more threads
torch.set_num_threads(1)

ARGV = tdriver.ABF_OPTS + (
    "-model 11 -size_x 0.1 -mx 4 -saddle_ksp_monitor_short "
    "-saddle_ksp_converged_reason -tpu 1 -device cpu").split()

_MON = re.compile(r"^\s*(\d+) KSP Residual norm (\S+) $")


def _run(mod, Options, argv):
    lines = []
    r = mod.saddle_solve(Options.from_args(argv), 3,
                         log=lambda *a: lines.append(
                             " ".join(str(x) for x in a)))
    return lines, r


def test_driver_matches_jax_driver():
    jl, jr = _run(jdriver, JOptions, ARGV)
    tl, tr = _run(tdriver, TOptions, ARGV)
    assert len(tl) == len(jl)
    nmon = 0
    for a, b in zip(tl, jl):
        ma, mb = _MON.match(a), _MON.match(b)
        if mb is None:
            assert a == b
            continue
        nmon += 1
        assert ma is not None and ma.group(1) == mb.group(1)
        va, vb = float(ma.group(2)), float(mb.group(2))
        assert abs(va - vb) <= 1e-6 * abs(vb)
    assert nmon == jr["result"].its + 1
    assert tr["its"] == jr["result"].its
    assert tr["reason"] == jr["result"].reason == "CONVERGED_RTOL"
    X = np.asarray(jr["X"])
    assert np.abs(tr["X"] - X).max() <= 1e-6 * np.abs(X).max()


def test_driver_ir_mode_converges():
    """-ir: float32 inner solves, float64 refinement to -rtol_true; monitor
    lines are the true residual per round."""
    lines, r = _run(tdriver, TOptions, tdriver.ABF_OPTS + (
        "-model 11 -size_x 0.1 -mx 4 -ir -rtol_true 1e-9 -device cpu "
        "-saddle_ksp_monitor_short").split())
    res = r["res"]
    assert res["converged"] and not res["stalled"]
    assert res["rnorm"] <= 1e-9 * res["rnorm0"]
    assert len([ln for ln in lines if "KSP Residual norm" in ln]) == \
        res["rounds"] + 1
    assert r["X"].dtype == np.float64


def test_driver_output_flags_run_on_both_routes(tmp_path, monkeypatch):
    """The output flags run on a host-route argv and on the abf.opts argv:
    -view_fields and -dump_solution keep the abf.opts tree on the ABF
    route, -saddle_ksp_view sends it to the host route (as in the JAX
    driver), and each writes its files or prints the tree."""
    monkeypatch.chdir(tmp_path)
    host = ["-mx", "2", "-device", "cpu"]
    abf = tdriver.ABF_OPTS + ["-model", "11", "-size_x", "0.1", "-mx", "4",
                              "-device", "cpu"]
    for flag, made in (("-saddle_ksp_view", None),
                       ("-view_fields", "uvw.vts"),
                       ("-dump_solution", "solution.npy")):
        for argv, abf_route in ((host, False),
                                (abf, flag != "-saddle_ksp_view")):
            for f in os.listdir(tmp_path):
                os.remove(f)
            lines = []
            r = tdriver.saddle_solve(TOptions.from_args(argv + [flag]), 3,
                                     log=lines.append)
            assert ("history" in r) == abf_route, (flag, argv)
            assert r["reason"] == "CONVERGED_RTOL"
            if made is None:
                assert "KSP Object: (saddle_) 1 MPI processes" in lines
            else:
                assert os.path.exists(made), (flag, argv)
                if made == "solution.npy":
                    assert np.array_equal(np.load(made), r["X"])


def test_driver_default_device_is_cuda():
    """No -device means CUDA; without a CUDA device that raises instead of
    falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdriver.saddle_solve(TOptions.from_args(
            tdriver.ABF_OPTS + ["-mx", "2"]), 3)


def test_port_never_imports_jax():
    code = ("import sys, exsaddle_tpu_torch.driver, exsaddle_tpu_torch.abf, "
            "exsaddle_tpu_torch.solver_config, exsaddle_tpu_torch.precond, "
            "exsaddle_tpu_torch.operator, exsaddle_tpu_torch.native, "
            "exsaddle_tpu_torch.ksp_view, exsaddle_tpu_torch.io, "
            "exsaddle_tpu_torch.postproc, exsaddle_tpu_torch.ex23, "
            "exsaddle_tpu_torch.ex42, exsaddle_tpu_torch.compiled, "
            "exsaddle_tpu_torch.grid_ops, exsaddle_tpu_torch.matfree;"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'exsaddle_tpu' or "
            "m.startswith('exsaddle_tpu.'));"
            "print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
