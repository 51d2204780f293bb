"""Where chip_smoke.py's JAX-side constants come from. The card script
imports nothing of JAX, so it holds the JAX package's counts for its argv as
constants; these tests rerun the JAX package on the CPU (float64) and check
that the script still records what the runs give.

- VIEW_ITS, VIEW_TREE_LINES: the flagship -saddle_ksp_view argv of
  tests/test_regression_abf.py:60-61 at mx=6 (the abf.opts options from
  driver.ABF_OPTS): iterations and the lines from the top KSP object to the
  end of the output.
- EX42_ITS, EX42_ARGV: the ex42 sinker tree of the ex42 phase at
  mx=my=mz=32 (slow: 143,748 dofs, ~40 s and ~3 GiB)."""

import ast
from pathlib import Path

import pytest

from exsaddle_tpu import driver as jdriver
from exsaddle_tpu.ex42 import solve_stokes_3d_coupled as jex42
from exsaddle_tpu.options import Options as JOptions

from exsaddle_tpu_torch import driver as tdriver

from test_torch_ex23_ex42 import MG_TREE
from test_torch_host_compare import _run

VIEW_ARGV = tdriver.ABF_OPTS + ("-model 11 -size_x 0.1 -mx 6 -saddle_ksp_view "
                                "-saddle_ksp_monitor_short").split()
VIEW_ITS, VIEW_TREE_LINES = 21, 289
EX42_ITS = 84


def _smoke_constants():
    """chip_smoke.py's module-level constants, read without importing it."""
    tree = ast.parse((Path(__file__).resolve().parents[1] /
                      "chip_smoke.py").read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            try:
                value = ast.literal_eval(node.value)
            except (ValueError, TypeError):
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    out[tgt.id] = value
                elif isinstance(tgt, ast.Tuple):
                    out.update({t.id: v for t, v in zip(tgt.elts, value)})
    return out


def test_chip_smoke_records_these_counts():
    c = _smoke_constants()
    assert (c["VIEW_ITS"], c["VIEW_TREE_LINES"]) == (VIEW_ITS,
                                                     VIEW_TREE_LINES)
    assert (c["EX42_ITS"], c["EX42_ARGV"]) == (EX42_ITS, MG_TREE)


def test_jax_view_run_gives_view_counts():
    lines, r = _run(jdriver, JOptions, VIEW_ARGV, 3, False, 1)
    start = lines.index("KSP Object: (saddle_) 1 MPI processes")
    assert r["result"].reason == "CONVERGED_RTOL"
    assert (r["result"].its, len(lines) - start) == (VIEW_ITS,
                                                    VIEW_TREE_LINES)


@pytest.mark.slow
def test_jax_ex42_mx32_gives_ex42_its():
    r = jex42(32, 32, 32, JOptions.from_args(MG_TREE.split()),
              log=lambda *a: None)
    assert r["result"].reason == "CONVERGED_RTOL"
    assert r["result"].its == EX42_ITS
