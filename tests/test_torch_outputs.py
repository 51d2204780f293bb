"""The port's output files against the JAX driver's: -view_fields, -view_coeffs
and every -dump_* flag, and postproc on the dumps. Each argv goes through
both drivers on the CPU (the port with -device cpu), each in its own
temporary directory. Both must write the same set of files; .npy/.npz arrays
agree to 1e-12 relative (to the array's largest entry). VTS text is
identical, or equal number by number to the printed precision: two solutions
that agree to 1e-12 can still print one unit apart in the last of the 7
printed digits where a value lies on a rounding boundary. The port's writer
itself is held to the JAX writer byte for byte: it writes the JAX driver's
solution into the same text. postproc.spectrum and postproc.split_fields_2d
give the same results on the two drivers' dumps."""

import os
import re

import numpy as np
import pytest
import torch

from exsaddle_tpu import driver as jdriver
from exsaddle_tpu import postproc as jpost
from exsaddle_tpu.options import Options as JOptions

from exsaddle_tpu_torch import driver as tdriver
from exsaddle_tpu_torch import io as tio
from exsaddle_tpu_torch import postproc as tpost
from exsaddle_tpu_torch.options import Options as TOptions

from test_torch_host_compare import _run

torch.set_num_threads(1)

_FILES = ("-view_fields -view_coeffs -dump_solution -dump_operator ")
_DENSE = "-dump_preconditioner -dump_preconditioned_operator"

CASES = {
    # the 3d_mg_1 tree (2-level saddle MG, GMRES/Jacobi smoothers) at
    # mx=2: the 3D fields, the operators, the smoother and the mass matrix
    "3d_mg": (3, "-model 2 -sinker_n 1 -mx 2 -mg -nlevels 2 "
              "-saddle_ksp_type fgmres -saddle_mg_levels_ksp_type gmres "
              "-saddle_mg_levels_pc_type jacobi "
              "-saddle_mg_levels_ksp_max_it 3 -dump_smoother "
              "-dump_scaled_mass_matrix " + _FILES),
    # 2D SolCx with fieldsplit and -check_solution (adds the ref_ fields):
    # every flag, the dense preconditioner dumps included (one PC apply
    # per column, so they run at this smallest size)
    "2d_fs": (2, "-model 0 -mx 3 -fs -check_solution " + _FILES + _DENSE),
}

_NUM = re.compile(r"^[-+]?\d+\.\d+e[-+]\d+$")


def _drive(mod, Options, argv, ndim, where, monkeypatch):
    os.makedirs(where)
    monkeypatch.chdir(where)
    lines, r = _run(mod, Options, argv, ndim, False, 1)
    return lines, r, sorted(os.listdir(where))


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _numbers(line):
    toks = line.split()
    if toks and all(_NUM.match(t) for t in toks):
        return np.array(toks, dtype=float)
    return None


def _same_vts(a, b):
    """Identical text, or the same lines but for numbers: each within one
    unit of its last printed digit plus 1e-12 of the file's largest number
    (the scale of the .npy comparison)."""
    if a == b:
        return True
    la, lb = a.splitlines(), b.splitlines()
    if len(la) != len(lb):
        return False
    scale = max(np.abs(v).max() for v in map(_numbers, lb) if v is not None)
    for x, y in zip(la, lb):
        if x == y:
            continue
        fx, fy = _numbers(x), _numbers(y)
        if fx is None or fy is None or fx.size != fy.size:
            return False
        ulp = 10.0 ** (np.floor(np.log10(np.maximum(np.abs(fy), 1e-300)))
                       - 6)
        if np.any(np.abs(fx - fy) > 1.001 * ulp + 1e-12 * scale):
            return False
    return True


@pytest.mark.parametrize("name", sorted(CASES))
def test_output_files_match_jax(name, tmp_path, monkeypatch):
    ndim, args = CASES[name]
    argv = args.split()
    jl, jr, jfiles = _drive(jdriver, JOptions, argv, ndim, tmp_path / "jax",
                            monkeypatch)
    tl, tr, tfiles = _drive(tdriver, TOptions, argv + ["-device", "cpu"],
                            ndim, tmp_path / "torch", monkeypatch)
    assert tfiles == jfiles
    for flag, f in (("-dump_solution", "solution.npy"),
                    ("-dump_preconditioner", "preconditioner.npz"),
                    ("-dump_preconditioned_operator",
                     "preconditioned_operator_out.npz"),
                    ("-dump_smoother", "smoother_1.npz"),
                    ("-dump_scaled_mass_matrix", "mpscaled.npz")):
        assert (flag in argv) == (f in tfiles), (flag, f)
    assert any(f.startswith("coeffs_") for f in tfiles)
    assert [ln for ln in tl if ln.startswith(("Dumping", "Finished"))] == \
        [ln for ln in jl if ln.startswith(("Dumping", "Finished"))]
    for f in tfiles:
        a, b = tmp_path / "torch" / f, tmp_path / "jax" / f
        if f.endswith(".vts"):
            assert _same_vts(a.read_text(), b.read_text()), f
        elif f.endswith(".npy"):
            assert _rel(np.load(a), np.load(b)) < 1e-12, f
        else:
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(zb.files), f
            for k in za.files:
                if za[k].dtype.kind in "iu":
                    assert np.array_equal(za[k], zb[k]), (f, k)
                else:
                    assert _rel(za[k], zb[k]) < 1e-12, (f, k)
    # the dumped solution is the returned one, and the dumped operator maps
    # it to the right-hand side less the final residual
    X = np.load(tmp_path / "torch" / "solution.npy")
    assert np.array_equal(X, tr["X"])
    nlev = len(tr["levels"])
    A = tpost.load_operator(tmp_path / "torch" / f"operator_{nlev - 1}.npz")
    op = tr["levels"][-1].op
    r = tr["F"] - op.mult(torch.as_tensor(X)).numpy()
    assert _rel(A @ X, tr["F"] - r) < 1e-12

    # the writer: the JAX driver's solution through the port's view_fields
    # gives the JAX driver's files byte for byte
    os.makedirs(tmp_path / "writer")
    monkeypatch.chdir(tmp_path / "writer")
    tio.view_fields(tr["mesh"], np.asarray(jr["X"]), log=lambda *a: None)
    for f in os.listdir(tmp_path / "writer"):
        assert (tmp_path / "writer" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f

    if "-dump_preconditioned_operator" not in argv:
        return
    BA = [post.load_operator(tmp_path / side /
                             "preconditioned_operator_out.npz")
          for post, side in ((tpost, "torch"), (jpost, "jax"))]
    st, sj = tpost.spectrum(BA[0]), jpost.spectrum(BA[1])
    assert len(st["pos"]) == len(sj["pos"])
    assert len(st["neg"]) == len(sj["neg"])
    assert _rel(st["pos"], sj["pos"]) < 1e-8
    assert st["pos"].size + st["neg"].size == X.size
    if ndim == 2:
        mx = int(argv[argv.index("-mx") + 1])
        for a, b in zip(tpost.split_fields_2d(X, mx),
                        jpost.split_fields_2d(np.asarray(jr["X"]), mx)):
            assert a.shape == b.shape and _rel(a, b) < 1e-12
