"""The PyTorch port's driver (abf.opts route) against the JAX driver, the
flags it refuses, and the port's import boundary.

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


def test_driver_refuses_other_trees():
    """Every options tree now has a route (the host KSP/PC stack takes the
    non-abf trees); the output flags that are not ported yet are refused
    with an error that names them."""
    for flag in ("-saddle_ksp_view", "-view_fields", "-dump_solution"):
        with pytest.raises(ValueError, match=f"not port.*{flag}"):
            tdriver.saddle_solve(TOptions.from_args(
                ["-mx", "2", "-device", "cpu", flag]), 3)
        with pytest.raises(ValueError, match=f"not port.*{flag}"):
            tdriver.saddle_solve(TOptions.from_args(
                tdriver.ABF_OPTS + ["-mx", "2", "-device", "cpu", flag]), 3)


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
            "exsaddle_tpu_torch.operator, exsaddle_tpu_torch.native;"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'exsaddle_tpu' or "
            "m.startswith('exsaddle_tpu.'));"
            "print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
