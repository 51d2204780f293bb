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
from exsaddle_tpu_torch.assembly import FESpace, assemble_rhs, scatter_vector
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


def _cart_solver(devices, model="11", mx=6, dev_shape=(1, 2, 2)):
    """The cartesian ABF solver of a mx^3 problem over `devices`, and the
    problem (mesh, fes, coefficients, bc indices and values)."""
    from exsaddle_tpu_torch.parallel.cart import CartPartition
    from exsaddle_tpu_torch.parallel.cart_abf import CartABFSolver
    size = (0.1, 1.0, 1.0) if model == "11" else (1.0, 1.0, 1.0)
    opts = Options.from_args(["-model", model, "-size_x", str(size[0])])
    ctx = tmodels.ModelContext(opts, 3, log=lambda *a, **k: None)
    mesh = SaddleMesh(3, (mx, mx, mx), size)
    fes = FESpace(mesh)
    bci, bcv = tmodels.create_bc_list(ctx, mesh)
    slv = CartABFSolver(CartPartition(mesh, dev_shape), ctx, bci, bcv,
                        devices, nlevels=3)
    return slv, (mesh, fes, tdriver.fine_coefficients(ctx, fes), bci, bcv)


@pytest.mark.gpu
def test_sharded_mult_tree_on_cuda(cuda):
    """The sharded mult_tree on [cuda:0] * 4: K1 once per shard (2 device
    launches each), bitwise-repeatable, equal to the CPU shards' result
    and to the single-device CUDA mult_tree (float64, 1e-12)."""
    from exsaddle_tpu_torch.abf import ABFSolver
    out = {}
    for dev in ("cpu", cuda):
        slv, prob = _cart_solver([dev] * 4)
        blk = slv.blocks
        x = slv.shard_saddle(np.random.default_rng(6).standard_normal(
            prob[0].ndof))
        n0, a0 = a00.LAUNCHES.n, a00.LAUNCHES.applies
        y = blk.saddle_mult(x)
        if torch.device(dev).type == "cuda":
            assert a00.LAUNCHES.n - n0 == 2 * 4
            assert a00.LAUNCHES.applies - a0 == 4
        assert all(torch.equal(a, b) for a, b in
                   zip(blk.saddle_mult(x).parts, y.parts))
        out[str(dev)] = slv.unshard_saddle(y)
    single = ABFSolver(*prob, device=cuda, nlevels=3)
    perm = single.setup["perm"]
    xs = np.random.default_rng(6).standard_normal(prob[0].ndof)
    y1 = single.tree_to_vec(single.data["op"].mult(torch.as_tensor(
        xs[perm], device=cuda)))
    yc, yg = out["cpu"], out[str(cuda)]
    scale = np.abs(yc).max()
    assert np.abs(yg - yc).max() <= 1e-12 * scale
    assert np.abs(yg - y1).max() <= 1e-12 * scale


@pytest.mark.gpu
def test_halos_and_psum_bitwise_repeatable_on_cuda(cuda):
    """halo_add_all, ghost_extend_axis and psum over 8 shards on one card:
    the same bits on every call, and psum is the shard-ordered sum."""
    from exsaddle_tpu_torch.parallel import cart, shard_mesh
    smesh = shard_mesh.ShardMesh((2, 2, 2), [cuda] * 8)
    g = np.random.default_rng(9).standard_normal((8, 5, 4, 3, 3))

    def halos():
        v = smesh.shard(list(g))
        cart.halo_add_all(smesh, v)
        return [p.clone() for p in
                shard_mesh.ghost_extend_axis(smesh, v, 2).parts]
    first = halos()
    assert all(torch.equal(a, b) for a, b in zip(halos(), first))
    parts = smesh.shard(list(g[:, 0, 0]))
    s = smesh.psum(parts)
    want = g[0, 0, 0].copy()
    for i in range(1, 8):
        want = want + g[i, 0, 0]
    for _ in range(3):
        assert all(np.array_equal(p.cpu().numpy(), want)
                   for p in smesh.psum(parts).parts)
    assert all(torch.equal(p, s.parts[0]) for p in s.parts)


@pytest.mark.gpu
def test_cart_solve_on_cuda_matches_cpu(cuda):
    """The sinker at mx=4 on [cuda:0] * 4 and on four CPU shards: the same
    iteration count and reason, x to 1e-10."""
    res = {}
    for dev in ("cpu", cuda):
        slv, prob = _cart_solver([dev] * 4, model="2", mx=4)
        mesh, fes, coeff, bci, bcv = prob
        f1, f2 = assemble_rhs(fes, coeff["Fu"], coeff["Fp"])
        F = scatter_vector(mesh, f1, f2)
        F[:mesh.nu][bci] = bcv
        res[str(dev)] = slv.solve(F + slv.setup["rhs_diri"])
    c, g = res["cpu"], res[str(cuda)]
    assert (g["its"], g["reason"]) == (c["its"], c["reason"])
    assert c["reason"] == "CONVERGED_RTOL"
    assert np.linalg.norm(g["x"] - c["x"]) <= 1e-10 * np.linalg.norm(c["x"])


# the port's bench at mx=16: median graph-replayed float32 saddle apply
# (inner=20) measured on an NVIDIA H100 80GB HBM3 at 700 W, the median of
# three runs' medians (168.2, 171.91, 173.9 us; PERF.md section 6);
# the band is 3x
MX16_APPLY_US = 171.91


@pytest.mark.gpu
def test_bench_apply_graph_equals_eager_on_cuda(cuda):
    """bench_apply at mx=16: the applies captured as one CUDA graph give the
    eager loop's output bit for bit, the scaled loop is stable, one eager
    loop makes 2 K1 launches per apply, and the replayed apply takes less
    than 3x the median measured on the H100."""
    from exsaddle_tpu_torch import bench
    inner = 20
    out = bench.bench_apply(16, inner, 5, cuda)
    kb = out["kernel_breakdown"]
    assert out["apply_timing"] == "graph" and kb["graph_bitwise_equal"]
    assert kb["k1_launches_per_loop"] == 2 * inner
    assert 1e-12 < kb["scaled_loop_final_norm"] < 1e12
    assert kb["trace_top_ops"]["source"] == "device"
    assert out["t_apply_us"] <= 3 * MX16_APPLY_US, out["t_apply_us"]


@pytest.mark.gpu
def test_bench_solve_mx16_band_on_cuda(cuda):
    """bench_solve at mx=16 (3 levels) on the card: the tuned schedule
    inside the JAX package's mx=16 anchor band (3 +- 1 rounds, 27-41 inner
    its; tests/test_abf_compiled.py), and both schedules at a true float64
    1e-8."""
    from exsaddle_tpu_torch import bench
    out = bench.bench_solve(16, 1e-8, cuda)
    assert abs(out["solve_ir_rounds"] - 3) <= 1
    assert 27 <= out["solve_outer_its"] <= 41, out["solve_outer_its"]
    for pre in ("solve_", "solve_abfopts_"):
        assert out[pre + "converged"] and not out[pre + "stalled"]
        assert out[pre + "recomputed_rel_resid"] <= 1e-8


@pytest.mark.gpu
def test_u_fixed_vcycles_on_cuda_matches_cpu(cuda):
    """3 fixed V-cycles in place of the u-block GCR, float64 direct solve
    at mx=6 pseudoice: the CPU's reason and iteration count on CUDA, x to
    1e-8."""
    from exsaddle_tpu_torch import bench
    from exsaddle_tpu_torch.abf import ABFSolver
    p = bench._build_problem(6, with_rhs=True)
    res = {}
    for dev in ("cpu", cuda):
        slv = ABFSolver(p["mesh"], p["fes"], p["coeff"], p["bc_idx"],
                        p["bc_vals"], device=dev, nlevels=3,
                        u_fixed_vcycles=3)
        res[str(dev)] = slv.solve(p["F_raw"] + slv.setup["rhs_diri"])
    c, g = res["cpu"], res[str(cuda)]
    assert (g["its"], g["reason"]) == (c["its"], c["reason"])
    assert c["reason"] == "CONVERGED_RTOL"
    assert np.abs(g["x"] - c["x"]).max() <= 1e-8 * np.abs(c["x"]).max()
