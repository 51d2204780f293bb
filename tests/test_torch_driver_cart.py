"""The port driver's cartesian dispatch (exsaddle_tpu_torch/driver.py)
against the JAX driver's: the device grid _choose_dev_shape picks, the
printed lines of a sharded solve (the port handed devices=[cpu]*8, the JAX
driver with -tpu 1 on conftest's 8 virtual CPU devices), the one-device run
left as it was, and the refusal of fewer than three MG levels."""

import numpy as np
import pytest
import torch

from exsaddle_tpu import driver as jdriver
from exsaddle_tpu.options import Options as JOptions

from exsaddle_tpu_torch import driver as tdriver
from exsaddle_tpu_torch.options import Options as TOptions

import torch_parallel_common  # noqa: F401  (one intra-op thread)

# the sinker at mx=4: a few outer iterations, so eight CPU shards are cheap
ARGV = tdriver.ABF_OPTS + (
    "-model 2 -mx 4 -saddle_ksp_monitor_short -saddle_ksp_converged_reason "
    "-ir").split()

MESHES = [(4, 4, 4), (32, 32, 32), (3, 4, 8), (6, 6, 6), (5, 5, 5),
          (8, 8), (3, 7), (16, 2, 4), (12, 12, 12), (1, 1, 1)]


@pytest.mark.parametrize("m_el", MESHES)
def test_choose_dev_shape_matches_jax(m_el):
    for ndev in range(1, 17):
        assert tdriver._choose_dev_shape(m_el, ndev) == \
            jdriver._choose_dev_shape(m_el, ndev), (m_el, ndev)


def _run(mod, Options, argv, **kw):
    lines = []
    r = mod.saddle_solve(Options.from_args(argv), 3, log=lines.append, **kw)
    return lines, r


def test_sharded_driver_prints_the_jax_lines():
    jl, jr = _run(jdriver, JOptions, ARGV + ["-tpu", "1"])
    tl, tr = _run(tdriver, TOptions, ARGV + ["-device", "cpu"],
                  devices=["cpu"] * 8)
    assert tr["mode"] == "cart"
    assert tr["solver"].part.dev_shape == (2, 2, 2)
    assert any(ln.startswith("# -ir: distributed solve") for ln in tl)
    assert tl == jl
    assert tr["its"] == jr["result"].its
    X = np.asarray(jr["X"])
    assert np.linalg.norm(tr["X"] - X) <= 1e-10 * np.linalg.norm(X)


def test_one_device_run_is_unchanged():
    """devices=[cpu] (and the -device cpu default) keep the single-device
    solver: the same lines and x as before the cartesian dispatch."""
    argv = [a for a in ARGV if a != "-ir"] + ["-device", "cpu"]
    dl, dr = _run(tdriver, TOptions, argv)
    ol, orr = _run(tdriver, TOptions, argv, devices=[torch.device("cpu")])
    assert dr["mode"] == orr["mode"] == "direct"
    assert dl == ol
    assert np.array_equal(dr["X"], orr["X"])


def test_two_mg_levels_fail_as_in_jax():
    argv = ARGV + ["-saddle_fieldsplit_u_pc_mg_levels", "2"]
    with pytest.raises(AssertionError) as je:
        _run(jdriver, JOptions, argv + ["-tpu", "1"])
    with pytest.raises(AssertionError) as te:
        _run(tdriver, TOptions, argv + ["-device", "cpu"],
             devices=["cpu"] * 8)
    assert str(te.value) == str(je.value)
