"""Card-only tests of the PyTorch port: each hand-written kernel against its
plain PyTorch version on CUDA tensors, the driver on CUDA against the driver
on the CPU (ABF route and host KSP/PC route), and the determinism of the host
route's device operators. They skip where there is no CUDA device.

This file imports nothing of JAX, so it runs on a machine that has only the
port's dependencies; there, skip tests/conftest.py (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import os
import warnings

import numpy as np
import pytest
import torch

from exsaddle_tpu_torch import driver as tdriver
from exsaddle_tpu_torch import matfree as tmf
from exsaddle_tpu_torch import models as tmodels
from exsaddle_tpu_torch.assembly import FESpace
from exsaddle_tpu_torch.kernels import a00
from exsaddle_tpu_torch.mesh import SaddleMesh
from exsaddle_tpu_torch.options import Options
from exsaddle_tpu_torch.precond import PCLU

# cuBLAS is bitwise reproducible under torch.use_deterministic_algorithms
# only with a fixed workspace; read when the first cuBLAS handle is made
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

HOST_MG_1 = ("-model 2 -sinker_n 1 -mx 8 -mg -nlevels 2 "
             "-saddle_ksp_type fgmres -saddle_mg_levels_ksp_type gmres "
             "-saddle_mg_levels_pc_type jacobi "
             "-saddle_mg_levels_ksp_max_it 10").split()

# (nd, m_el, lame, model, size): test_fast_apply.CASES plus an odd 3D shape
# and 4,096 elements, where every persistent block of K1 walks several tiles
CASES = [(2, (5, 4), False, "0", None),
         (3, (3, 4, 2), False, "11", (0.1, 1.0, 1.0)),
         (2, (4, 4), True, "6", None),
         (3, (3, 3, 3), True, "6", None),
         (2, (1, 1), False, "0", None),
         (3, (5, 7, 3), False, "11", (0.1, 1.0, 1.0)),
         (3, (16, 16, 16), False, "11", (0.1, 1.0, 1.0))]

# kernel vs plain: float32 to float32 summation order, float64 to ~ulps
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _operator(case, dtype, device):
    nd, m_el, lame, model, size = case
    opts = Options.from_args(["-model", model])
    ctx = tmodels.ModelContext(opts, nd, lame=lame, log=lambda *a, **k: None)
    mesh = SaddleMesh(nd, m_el, size or (1.0,) * nd)
    fes = FESpace(mesh)
    bci, _ = tmodels.create_bc_list(ctx, mesh)
    coeff = tdriver.fine_coefficients(ctx, fes)
    bc_mask = np.zeros(mesh.ndof)
    bc_mask[:mesh.nu][bci] = 1.0
    return tmf.ParityMatFreeOperator.build(mesh, fes, coeff, bc_mask,
                                           lame=lame, dtype=dtype,
                                           device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_a00_kernel_matches_plain(cuda, case, dtype):
    op = _operator(case, dtype, cuda)
    x = torch.as_tensor(np.random.default_rng(8).standard_normal(op.nu),
                        dtype=dtype, device=cuda)
    n0, a0 = a00.LAUNCHES.n, a00.LAUNCHES.applies
    yk = a00.a00_apply(op, x)
    # one apply: the element kernel and the node gather
    assert a00.LAUNCHES.n == n0 + 2 and a00.LAUNCHES.applies == a0 + 1
    yp = a00.a00_apply_plain(op, x)
    torch.cuda.synchronize()
    assert float((yk - yp).abs().max()) <= TOL[dtype] * float(
        yp.abs().max())
    # the node gather sums in a fixed order, with no atomics: repeated
    # applies are bitwise equal
    assert torch.equal(a00.a00_apply(op, x), yk)


@pytest.mark.gpu
def test_a00_kernel_refuses_bad_input(cuda):
    op = _operator(CASES[1], torch.float32, cuda)
    x = torch.zeros(op.nu, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="x is torch.float64"):
        a00.a00_apply(op, x)
    with pytest.raises(ValueError, match="shape"):
        a00.a00_apply(op, torch.zeros(op.nu + 1, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        a00.a00_apply(op, torch.zeros(2 * op.nu, device=cuda)[::2])


@pytest.mark.gpu
def test_driver_on_cuda_matches_cpu(cuda):
    """The driver's default device runs K1 and reproduces the CPU run's
    iteration count and history (float64, mx=4 pseudoice)."""
    argv = tdriver.ABF_OPTS + "-model 11 -size_x 0.1 -mx 4".split()
    n0 = a00.LAUNCHES.n
    g = tdriver.saddle_solve(Options.from_args(argv), 3,
                             log=lambda *a: None)
    assert a00.LAUNCHES.n > n0
    c = tdriver.saddle_solve(Options.from_args(argv + ["-device", "cpu"]),
                             3, log=lambda *a: None)
    assert g["its"] == c["its"] and g["reason"] == c["reason"]
    assert np.abs(np.array(g["history"]) - np.array(c["history"])).max() \
        <= 1e-8 * max(c["history"])


def _host_history(argv, device):
    """The host route's solve, then the same solve again with a recorder
    in place of the monitor: (its, reason, exact history, x, result)."""
    r = tdriver.saddle_solve(Options.from_args(argv + ["-device", device]),
                             3, log=lambda *a: None)
    hist = []
    ksp = r["ksp"]
    ksp.cfg.monitor = lambda i, rn: hist.append(rn)
    dev = r["levels"][-1].op.device
    res = ksp.solve(torch.as_tensor(r["F"], device=dev))
    assert (res.its, res.reason) == (r["its"], r["reason"])
    return res.its, res.reason, np.array(hist), res.x, r


@pytest.mark.gpu
def test_host_route_on_cuda_matches_cpu(cuda):
    """3d_mg_1 on the host route: identical iteration count and reason on
    CUDA and on the CPU, histories to 1e-10 relative; under
    torch.use_deterministic_algorithms nothing on the path warns."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            g_its, g_reason, g_hist, g_x, _ = _host_history(HOST_MG_1,
                                                            "cuda")
        finally:
            torch.use_deterministic_algorithms(False)
    flagged = [str(w.message) for w in caught
               if "determinis" in str(w.message)]
    assert not flagged, flagged
    c_its, c_reason, c_hist, c_x, _ = _host_history(HOST_MG_1, "cpu")
    assert (g_its, g_reason) == (c_its, c_reason) == (12, "CONVERGED_RTOL")
    assert np.all(np.abs(g_hist - c_hist) <= 1e-10 * c_hist)
    xc = c_x.numpy()
    assert np.abs(g_x.cpu().numpy() - xc).max() <= 1e-8 * np.abs(xc).max()


@pytest.mark.gpu
def test_host_operators_bitwise_repeatable(cuda):
    """SaddleOperator.mult (colour-swept scatter) and Prolongation.restrict
    (ELL gather of P^T) give bitwise-equal results on repeated calls, and
    a repeated solve gives a bitwise-equal x."""
    its, _, _, x, r = _host_history(HOST_MG_1, "cuda")
    op = r["levels"][-1].op
    P = r["ksp"].pc.levels[-1].P
    v = torch.as_tensor(np.random.default_rng(3).standard_normal(op.ndof),
                        device=cuda)
    y = op.mult(v)
    rc = P.restrict(v)
    for _ in range(3):
        assert torch.equal(op.mult(v), y)
        assert torch.equal(P.restrict(v), rc)
    res = r["ksp"].solve(torch.as_tensor(r["F"], device=cuda))
    assert res.its == its and torch.equal(res.x, x)


@pytest.mark.gpu
def test_pclu_on_cuda_matches_cpu(cuda):
    """The coarse-level dense LU of the mx=4 3D saddle operator (2,312
    dofs, the coarse level of the full-size MG tree) on CUDA and on the
    CPU."""
    r = tdriver.saddle_solve(Options.from_args(
        "-model 2 -sinker_n 1 -mx 4 -saddle_pc_type lu -device cpu".split()),
        3, log=lambda *a: None)
    A = r["levels"][-1].op.to_dense()
    b = np.random.default_rng(4).standard_normal(A.shape[0])
    yc = PCLU(A, "cpu").apply(torch.as_tensor(b)).numpy()
    yg = PCLU(A, cuda).apply(torch.as_tensor(b, device=cuda)).cpu().numpy()
    assert np.abs(yg - yc).max() <= 1e-10 * np.abs(yc).max()


def _flagship_parity(mx, device):
    """mx^3 pseudoice parity operator (float64), its Jacobi inverse
    diagonal and a seeded right-hand side, on `device`."""
    op = _operator((3, (mx, mx, mx), False, "11", (0.1, 1.0, 1.0)),
                   torch.float64, device)
    d = op.diagonal()
    inv = 1.0 / torch.where(d == 0.0, torch.ones_like(d), d)
    F = torch.as_tensor(np.random.default_rng(2).standard_normal(op.ndof),
                        device=device)
    return op, inv, F


@pytest.mark.gpu
def test_compiled_tree_cycle_on_cuda_matches_cpu(cuda):
    """The tree-form FGMRES(k) cycle on CUDA: no host synchronisation
    (sync debug mode "error"), 2 x (k + 2) K1 launches, and the CPU
    cycle's residual and x to 1e-10 in float64."""
    from exsaddle_tpu_torch.compiled import make_fgmres_cycle_tree
    k = 12
    cycle = make_fgmres_cycle_tree(k)
    out = {}
    for dev in ("cpu", cuda):
        op, inv, F = _flagship_parity(6, dev)
        aux = tmf.tree_aux(op)
        if dev != "cpu":
            op.node_table                  # K1's table: built before timing
            n0, a0 = a00.LAUNCHES.n, a00.LAUNCHES.applies
            torch.cuda.set_sync_debug_mode("error")
        try:
            x, rn = cycle(op, aux, inv, F, torch.zeros_like(F))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if dev != "cpu":
            assert a00.LAUNCHES.n - n0 == 2 * (k + 2)
            assert a00.LAUNCHES.applies - a0 == k + 2
        out[str(dev)] = (x.cpu().numpy(), float(rn))
    (xc, rc), (xg, rg) = out["cpu"], out[str(cuda)]
    assert abs(rg - rc) <= 1e-10 * rc
    assert np.abs(xg - xc).max() <= 1e-10 * np.abs(xc).max()


@pytest.mark.gpu
def test_ex42_on_cuda_matches_cpu(cuda):
    """ex42's FGMRES/fieldsplit tree with the Galerkin MG u-block at mx=8:
    the CPU's iteration count and reason on CUDA."""
    from exsaddle_tpu_torch.ex42 import solve_stokes_3d_coupled
    argv = ("-model 1 -stokes_ksp_type fgmres -stokes_ksp_rtol 1e-7 "
            "-stokes_fieldsplit_u_ksp_type preonly "
            "-stokes_fieldsplit_u_pc_type mg "
            "-stokes_fieldsplit_u_pc_mg_levels 4 "
            "-stokes_fieldsplit_u_pc_mg_galerkin "
            "-stokes_fieldsplit_u_mg_levels_pc_type jacobi "
            "-stokes_fieldsplit_p_ksp_type preonly "
            "-stokes_fieldsplit_p_pc_type jacobi").split()
    res = {}
    for dev in ("cpu", cuda):
        r = solve_stokes_3d_coupled(8, 8, 8, Options.from_args(argv),
                                    log=lambda *a: None,
                                    device=torch.device(dev))
        res[str(dev)] = (r["result"].its, r["result"].reason,
                         r["X"].cpu().numpy())
    (ic, rc, xc), (ig, rg, xg) = res["cpu"], res[str(cuda)]
    assert (ig, rg) == (ic, rc) == (60, "CONVERGED_RTOL")
    assert np.abs(xg - xc).max() <= 1e-8 * np.abs(xc).max()
