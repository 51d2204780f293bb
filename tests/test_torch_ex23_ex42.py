"""The port's secondary entry points against the JAX package's on the CPU in
float64: ex23 (tridiagonal KSP smoke test) and ex42 (3D Q1-Q1 Bochev-
stabilised Stokes). Mirrors tests/test_ex23_ex42.py: the same options go
through both packages.

Held equal: Ex42Problem's A and F bitwise; reasons and iteration counts;
-stokes_ksp_monitor_blocks lines token for token, numbers to 1e-10 of the
first line's largest (the residual's scale); X to 1e-10 relative; the pvts
files' text; ex23's error per PC (both below 1e-9) and iteration count."""

import re

import numpy as np
import pytest
import torch

from exsaddle_tpu.ex23 import solve_ex23 as jex23
from exsaddle_tpu.ex42 import Ex42Problem as JProblem
from exsaddle_tpu.ex42 import solve_stokes_3d_coupled as jex42
from exsaddle_tpu.options import Options as JOptions

from exsaddle_tpu_torch.ex23 import solve_ex23 as tex23
from exsaddle_tpu_torch.ex42 import Ex42Problem as TProblem
from exsaddle_tpu_torch.ex42 import solve_stokes_3d_coupled as tex42
from exsaddle_tpu_torch import io as tio
from exsaddle_tpu_torch.options import Options as TOptions

from test_torch_outputs import _same_vts

torch.set_num_threads(1)

_LU_SPLIT = ("-stokes_fieldsplit_u_ksp_type preonly "
             "-stokes_fieldsplit_u_pc_type lu "
             "-stokes_fieldsplit_p_ksp_type preonly "
             "-stokes_fieldsplit_p_pc_type jacobi")

# the FGMRES/fieldsplit tree with a 4-level Galerkin MG u-block that the
# card runs at mx=32 (chip_smoke.py, phase ex42)
MG_TREE = ("-model 1 -stokes_ksp_type fgmres -stokes_ksp_rtol 1e-7 "
           "-stokes_fieldsplit_u_ksp_type preonly "
           "-stokes_fieldsplit_u_pc_type mg "
           "-stokes_fieldsplit_u_pc_mg_levels 4 "
           "-stokes_fieldsplit_u_pc_mg_galerkin "
           "-stokes_fieldsplit_u_mg_levels_pc_type jacobi "
           "-stokes_fieldsplit_p_ksp_type preonly "
           "-stokes_fieldsplit_p_pc_type jacobi -stokes_ksp_monitor_blocks")


def _both_ex42(args, m):
    jl, tl = [], []
    jr = jex42(*m, JOptions.from_args(args.split()), log=jl.append)
    tr = tex42(*m, TOptions.from_args(args.split()), log=tl.append,
               device=torch.device("cpu"))
    return jr, jl, tr, tl


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


_NUM = re.compile(r"\d\.\d+e[-+]\d+")


def _same_block_lines(tl, jl):
    tm = [ln for ln in tl if "KSP Component" in ln]
    jm = [ln for ln in jl if "KSP Component" in ln]
    assert len(tm) == len(jm) >= 2
    scale = max(float(v) for v in _NUM.findall(jm[0]))
    for a, b in zip(tm, jm):
        assert _NUM.sub("#", a) == _NUM.sub("#", b), (a, b)
        va = np.array(_NUM.findall(a), dtype=float)
        vb = np.array(_NUM.findall(b), dtype=float)
        assert np.abs(va - vb).max() <= 1e-10 * scale, (a, b)


@pytest.mark.parametrize("args", ["-n 50", "-n 40 -pc_type ildl",
                                  "-n 40 -pc_type ilupack",
                                  "-n 40 -pc_type jacobi",
                                  "-n 40 -pc_type ilu"])
def test_ex23_matches_jax(args):
    jres, jerr = jex23(JOptions.from_args(args.split()), log=lambda *a: None)
    tres, terr = tex23(TOptions.from_args(args.split()), log=lambda *a: None,
                       device=torch.device("cpu"))
    assert terr < 1e-9 and jerr < 1e-9
    assert (tres.its, tres.reason) == (jres.its, jres.reason)


@pytest.mark.parametrize("model,m,stab", [("1", (3, 3, 3), True),
                                          ("0", (4, 4, 4), True),
                                          ("0", (4, 4, 4), False)])
def test_ex42_problem_bitwise(model, m, stab):
    args = ["-model", model] + ([] if stab else ["-no_stab"])
    jp = JProblem(*m, JOptions.from_args(args), log=lambda *a: None)
    tp = TProblem(*m, TOptions.from_args(args), log=lambda *a: None)
    for a, b in ((tp.A, jp.A), (tp.A.T, jp.A.T)):
        a, b = a.tocsr(), b.tocsr()
        assert np.array_equal(a.indptr, b.indptr)
        assert np.array_equal(a.indices, b.indices)
        assert np.array_equal(a.data, b.data)
    assert np.array_equal(tp.F, jp.F)
    assert np.array_equal(tp.p_dofs, jp.p_dofs)


def test_ex42_isoviscous_matches_jax():
    jr, _, tr, _ = _both_ex42("-model 0 -stokes_ksp_rtol 1e-9 " + _LU_SPLIT,
                              (6, 6, 6))
    assert tr["result"].reason == jr["result"].reason == "CONVERGED_RTOL"
    assert tr["result"].its == jr["result"].its
    X = tr["X"].numpy()
    assert _rel(X, np.asarray(jr["X"])) < 1e-10
    prob = tr["prob"]
    assert np.abs((prob.F - prob.A @ X)[3::4]).max() < 1e-8


@pytest.mark.parametrize("args,m", [
    ("-model 1 -stokes_ksp_rtol 1e-6 -stokes_pc_type ilu "
     "-stokes_ksp_max_it 500 -stokes_ksp_monitor_blocks", (5, 5, 5)),
    (MG_TREE, (8, 8, 8))], ids=["ilu_mx5", "mg_tree_mx8"])
def test_ex42_block_monitor_matches_jax(args, m):
    jr, jl, tr, tl = _both_ex42(args, m)
    assert tr["result"].reason == jr["result"].reason == "CONVERGED_RTOL"
    assert tr["result"].its == jr["result"].its
    _same_block_lines(tl, jl)
    assert _rel(tr["X"].numpy(), np.asarray(jr["X"])) < 1e-10


def test_ex42_pvts_pieces_match_jax(tmp_path, monkeypatch):
    """The same .pvts master and .vts pieces (text to print precision, as
    tests/test_torch_outputs.py compares VTS files), and the port's writer
    gives the JAX files byte for byte from the JAX solution."""
    args = "-model 0 -write_pvts -pvts_ranks 3 " + _LU_SPLIT
    files = {}
    for side in ("jax", "torch", "writer"):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        if side == "jax":
            jr = jex42(4, 4, 6, JOptions.from_args(args.split()),
                       log=lambda *a: None)
        elif side == "torch":
            tr = tex42(4, 4, 6, TOptions.from_args(args.split()),
                       log=lambda *a: None, device=torch.device("cpu"))
        else:
            tio.write_pvts_interleaved("ex42-up", tr["prob"].nn,
                                       np.asarray(jr["X"]),
                                       ("Vx", "Vy", "Vz", "P"), nranks=3,
                                       log=lambda *a: None)
        files[side] = {p.name: p.read_text()
                       for p in (tmp_path / side).iterdir()}
    assert sorted(files["torch"]) == sorted(files["jax"]) \
        == sorted(files["writer"])
    assert len(files["torch"]) == 4          # the master and 3 pieces
    assert _rel(tr["X"].numpy(), np.asarray(jr["X"])) < 1e-10
    for name, txt in files["jax"].items():
        assert files["writer"][name] == txt, name
        assert _same_vts(files["torch"][name], txt), name


def test_vts_interleaved_writer_matches_jax(tmp_path, monkeypatch):
    """write_vts_interleaved (the serial DAView3DPVTS piece) writes the JAX
    writer's file byte for byte from the same interleaved vector."""
    from exsaddle_tpu import io as jio
    monkeypatch.chdir(tmp_path)
    nn = (3, 4, 5)
    X = np.random.default_rng(6).standard_normal(4 * int(np.prod(nn)))
    names = ("Vx", "Vy", "Vz", "P")
    jio.write_vts_interleaved("jax.vts", nn, X, names, log=lambda *a: None)
    tio.write_vts_interleaved("torch.vts", nn, torch.as_tensor(X), names,
                              log=lambda *a: None)
    assert (tmp_path / "torch.vts").read_bytes() == \
        (tmp_path / "jax.vts").read_bytes()
