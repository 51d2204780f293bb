"""The port's single-device ABF options against the JAX package on the CPU:
the fixed-V-cycle u-block (ABFConfig.u_fixed_vcycles), config_from_dict
carrying it, the setup stage timer behind EXSADDLE_SETUP_PROFILE=1,
ABFSolver.rhs_tree and krylov.fmt_petsc_g."""

import dataclasses
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from exsaddle_tpu import abf as jabf
from exsaddle_tpu import krylov as jkrylov
from exsaddle_tpu import matfree as jmf

from exsaddle_tpu_torch import abf as tabf
from exsaddle_tpu_torch import krylov as tkrylov

from test_torch_abf import _from_jax, _jax_solver, _own, _same_solve

PSEUDOICE = ((0.1, 1.0, 1.0), 11)

_SETUP_LINE = re.compile(r"^\[setup\] (.+): \d+\.\d\d s$")

# setup stages of the JAX package with no counterpart in the port: the JAX
# ABFSolver's background device_put thread (exsaddle_tpu/abf.py:1222; the
# JAX package prints it only on an accelerator)
JAX_ONLY_STAGES = ("device transfer dispatch",)


def test_u_fixed_vcycles_matches_jax():
    """3 fixed V-cycles in place of the u-block GCR, float64 direct solve at
    mx=6 pseudoice, 3 levels: the JAX reason, iteration count, history and x,
    from the JAX build's numbers and from the port's own setup."""
    kw = dict(nlevels=3, u_fixed_vcycles=3)
    jslv, F = _jax_solver(3, (6, 6, 6), *PSEUDOICE, **kw)
    rj = jslv.solve(F)
    assert rj["reason"] == "CONVERGED_RTOL"
    from_jax = _from_jax(jslv, torch.float64)
    assert from_jax.cfg.u_fixed_vcycles == 3
    _same_solve(from_jax.solve(F), rj)
    tslv, Ft = _own(3, (6, 6, 6), *PSEUDOICE, **kw)
    assert tslv.cfg.u_fixed_vcycles == 3
    _same_solve(tslv.solve(Ft), rj)


def test_config_from_dict_carries_u_fixed_vcycles():
    jcfg = jabf.ABFConfig(ndim=3, nlevels=4, u_fixed_vcycles=3,
                          cls_shapes=((2, 2, 2),), m_el=(1, 1, 1),
                          level_grids=((2, 2, 2),))
    tcfg = tabf.config_from_dict(dataclasses.asdict(jcfg))
    assert tcfg.u_fixed_vcycles == 3
    want = {k: v for k, v in dataclasses.asdict(jcfg).items()
            if k not in ("matmul_precision", "pc_matmul_precision")}
    assert dataclasses.asdict(tcfg) == want


def _stage_names(err):
    return [m.group(1) for m in map(_SETUP_LINE.match, err.splitlines())
            if m]


def test_setup_stages_match_jax(monkeypatch, capfd):
    """EXSADDLE_SETUP_PROFILE=1: the port prints the JAX package's setup
    stages, in its order, less JAX_ONLY_STAGES (mx=4, float32 with
    refinement, so the IR operator's stage is among them); unset, the port
    prints none."""
    monkeypatch.setenv("EXSADDLE_SETUP_PROFILE", "1")
    _jax_solver(3, (4, 4, 4), *PSEUDOICE, ir=True, dtype=jnp.float32)
    jnames = _stage_names(capfd.readouterr().err)
    _own(3, (4, 4, 4), *PSEUDOICE, ir=True, dtype=torch.float32)
    tnames = _stage_names(capfd.readouterr().err)
    assert {"factored_host", "esteig level 1", "device cast",
            "ir op64 build"} <= set(jnames)
    assert tnames == [n for n in jnames if n not in JAX_ONLY_STAGES]
    monkeypatch.delenv("EXSADDLE_SETUP_PROFILE")
    _own(3, (4, 4, 4), *PSEUDOICE, ir=True, dtype=torch.float32)
    assert "[setup]" not in capfd.readouterr().err


def test_rhs_tree_and_fmt_petsc_g_match_jax():
    jslv, F = _jax_solver(3, (4, 4, 4), *PSEUDOICE)
    tslv, Ft = _own(3, (4, 4, 4), *PSEUDOICE)
    want = np.asarray(jmf.from_tree(jslv.rhs_tree(F_flat=F)))
    got = tslv.rhs_tree(F_flat=Ft)
    assert got.dtype == torch.float64
    assert np.array_equal(got.numpy(), want)
    for slv in (jslv, tslv):
        with pytest.raises(ValueError, match="pass F_flat"):
            slv.rhs_tree()
    for v in (0.0, 1.0, -2.5e-7, 1234567.0, 3.14159265358979, 1e300,
              float("inf")):
        assert tkrylov.fmt_petsc_g(v) == jkrylov.fmt_petsc_g(v)
