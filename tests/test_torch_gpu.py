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
from exsaddle_tpu_torch.kernels import a00, cheb, mp, stencil, transfer
from exsaddle_tpu_torch.kernels import gram_schmidt as gs
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


def _problem(case):
    """(mesh, fes, coeff, bc_mask) of a case."""
    nd, m_el, lame, model, size = case
    opts = Options.from_args(["-model", model])
    ctx = tmodels.ModelContext(opts, nd, lame=lame, log=lambda *a, **k: None)
    mesh = SaddleMesh(nd, m_el, size or (1.0,) * nd)
    fes = FESpace(mesh)
    bci, _ = tmodels.create_bc_list(ctx, mesh)
    coeff = tdriver.fine_coefficients(ctx, fes)
    bc_mask = np.zeros(mesh.ndof)
    bc_mask[:mesh.nu][bci] = 1.0
    return mesh, fes, coeff, bc_mask


def _operator(case, dtype, device):
    mesh, fes, coeff, bc_mask = _problem(case)
    return tmf.ParityMatFreeOperator.build(mesh, fes, coeff, bc_mask,
                                           lame=case[2], dtype=dtype,
                                           device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_a00_kernel_matches_plain(cuda, case, dtype):
    op = _operator(case, dtype, cuda)
    x = torch.as_tensor(np.random.default_rng(8).standard_normal(op.nu),
                        dtype=dtype, device=cuda)
    n0, a0 = a00.LAUNCHES.n, a00.LAUNCHES.applies
    f0 = a00.LAUNCHES.factored
    yk = a00.a00_apply(op, x)
    # one apply: the element kernel and the node gather; its products
    # factored in 3D (every case's Bs factors), dense in 2D
    assert a00.LAUNCHES.n == n0 + 2 and a00.LAUNCHES.applies == a0 + 1
    assert a00.LAUNCHES.factored == f0 + (case[0] == 3)
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


# K1's fused forms: 2D, a small and a ragged 3D mesh, and the mx=32
# flagship's fine level (823,875 dofs)
FUSED_CASES = {"2d": CASES[0], "3d": CASES[1], "ragged": CASES[5],
               "flagship": (3, (32, 32, 32), False, "11", (0.1, 1.0, 1.0))}
FUSED_SCALE, FUSED_OMEGA = 0.37, 1.61


def _fused_inputs(op, dtype, device, seed):
    """x, b, p_km1, y (standard normals) and d (in [0.5, 1.5]) of op's nu,
    on the card."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa
    x, b, q, y = (t(rng.standard_normal(op.nu)) for _ in range(4))
    return x, b, q, y, t(rng.uniform(0.5, 1.5, op.nu))


def _fused_pairs(op, aux, x, b, q, y, d):
    """{form: (the fused entry, its twin)} as thunks: K1's four forms (the
    twins: K1 without keep, then the torch ops and K6 the port issued
    before) and K6's two masked forms (the twins: torch ops)."""
    ks, ms = aux[0], aux[1]
    sc, om = FUSED_SCALE, FUSED_OMEGA
    return {
        "a00_apply_keep": (lambda: a00.a00_apply(op, x, keep=ks),
                           lambda: a00.a00_apply(op, x * ks)),
        "a00_masked": (lambda: a00.a00_masked(op, aux, x),
                       lambda: a00.a00_apply(op, x * ks) * ks + ms * x),
        "a00_cheb_first": (
            lambda: a00.a00_cheb_first(op, aux, b, x, d, sc),
            lambda: cheb.cheb_first(b, a00.TWINS["a00_masked"](op, aux, x),
                                    d, x, sc)),
        "a00_cheb_step": (
            lambda: a00.a00_cheb_step(op, aux, b, x, q, d, sc, om),
            lambda: cheb.cheb_step(b, a00.TWINS["a00_masked"](op, aux, x), d,
                                   x, q, sc, om)),
        "cheb_first_masked": (
            lambda: cheb.cheb_first_masked(b, y, ks, ms, d, x, sc),
            lambda: cheb.cheb_first_plain(b, y * ks + ms * x, d, x, sc)),
        "cheb_step_masked": (
            lambda: cheb.cheb_step_masked(b, y, ks, ms, d, x, q, sc, om),
            lambda: cheb.cheb_step_plain(b, y * ks + ms * x, d, x, q, sc,
                                         om))}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_a00_fused_forms_bitwise_twins(cuda, case, dtype):
    """Every fused K1 form bit for bit K1 followed by the unfused ops, and
    K6's masked forms bit for bit their twins; one K1 apply (two launches)
    per fused K1 call, counted by form; the keep=None apply repeatable
    beside the keep form; a keep that is not the operator's own refused."""
    op = _operator(FUSED_CASES[case], dtype, cuda)
    aux = tmf.tree_aux(op)
    vecs = _fused_inputs(op, dtype, cuda, 17)
    x = vecs[0]
    assert float(aux[0].min()) == 0.0 and float(aux[1].max()) == 1.0
    for form, (fused, twin) in _fused_pairs(op, aux, *vecs).items():
        n0 = (a00.LAUNCHES.n, a00.LAUNCHES.by.get(form, 0),
              cheb.LAUNCHES.by.get(form, 0))
        got = fused()
        if form in a00.FORMS:
            assert (a00.LAUNCHES.n, a00.LAUNCHES.by[form]) == (
                n0[0] + 2, n0[1] + 1)
        else:
            assert cheb.LAUNCHES.by[form] == n0[2] + 1
        want = twin()
        torch.cuda.synchronize()
        assert _same_bits(got, want), form
        assert _same_bits(fused(), got), form
    y0 = a00.a00_apply(op, x)
    a00.a00_apply(op, x, keep=aux[0])
    assert _same_bits(a00.a00_apply(op, x), y0)
    with pytest.raises(ValueError, match="own keep vector"):
        a00.a00_apply(op, x, keep=torch.ones_like(x))


@pytest.mark.gpu
def test_a00_fused_forms_refuse_bad_input(cuda):
    """The fused forms' vectors: shape, dtype, device and layout are
    checked before a launch."""
    op = _operator(CASES[1], torch.float32, cuda)
    aux = tmf.tree_aux(op)
    x, b, q, y, d = _fused_inputs(op, torch.float32, cuda, 2)
    n0 = a00.LAUNCHES.n
    with pytest.raises(ValueError, match="keep has shape"):
        a00.a00_apply(op, x, keep=aux[0][:-1])
    with pytest.raises(ValueError, match="d is torch.float64"):
        a00.a00_cheb_first(op, aux, b, x, d.double(), 0.5)
    with pytest.raises(ValueError, match="p_km1 is torch.float32 on cpu"):
        a00.a00_cheb_step(op, aux, b, x, q.cpu(), d, 0.5, 1.2)
    with pytest.raises(ValueError, match="b is not contiguous"):
        a00.a00_cheb_step(op, aux, torch.stack([b, b], 1)[:, 0], x, q, d,
                          0.5, 1.2)
    assert a00.LAUNCHES.n == n0
    n0 = cheb.LAUNCHES.n
    with pytest.raises(ValueError, match="ks is"):
        cheb.cheb_step_masked(b, y, aux[0][:-1], aux[1], d, x, q, 0.5, 1.2)
    with pytest.raises(ValueError, match="not contiguous"):
        cheb.cheb_first_masked(b[::2], y[::2], aux[0][::2], aux[1][::2],
                               d[::2], x[::2], 0.5)
    assert cheb.LAUNCHES.n == n0


@pytest.mark.gpu
def test_a00_fused_forms_capture_with_launches_counted(cuda):
    """A fine-level smoothing body (A00Op's fused first step and steps,
    a masked residual, K6's masked step) captures into a CUDA graph; each
    replay gives the eager bits and adds the captured launches by form."""
    from exsaddle_tpu_torch import graphs
    op = _operator(CASES[6], torch.float32, cuda)
    aux = tmf.tree_aux(op)
    x, b, q, y, d = _fused_inputs(op, torch.float32, cuda, 5)
    A = a00.A00Op(op, aux)
    op.node_table   # its H2D copy syncs: before any capture

    def body(v):
        p = A.cheb_first(b, v, d, 0.5)
        p2 = A.cheb_step(b, p, v, d, 0.5, 1.3)
        p3 = cheb.cheb_step_masked(b, a00.a00_apply(op, p2, keep=aux[0]),
                                   aux[0], aux[1], d, p2, p, 0.5, 1.3)
        return b - A(p3)

    want = body(x)

    def counts():
        return ((a00.LAUNCHES.n,) + tuple(a00.LAUNCHES.by[f]
                                          for f in a00.FORMS)
                + (cheb.LAUNCHES.n,) + tuple(cheb.LAUNCHES.by[f]
                                             for f in cheb.FORMS))

    per = (8, 0, 1, 1, 1, 1, 1, 0, 0, 0, 1)
    k0 = counts()
    g = graphs.Captured(body, x)
    k1 = counts()
    assert tuple(b_ - a_ for a_, b_ in zip(k0, k1)) == per
    for i in range(2):
        assert torch.equal(g(x), want)
        k = counts()
        assert tuple(b_ - a_ for a_, b_ in zip(k1, k)) == tuple(
            (i + 1) * n for n in per)


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


@pytest.mark.gpu
def test_graphed_cart_solve_equals_plain_and_host_loops_on_cuda(cuda):
    """The pseudoice at mx=8 over [cuda:0] * 4 (device grid 1x2x2): the
    default loop is "device", a solve is one graph launch under
    torch.cuda.set_sync_debug_mode("error") and the host launches no kernel
    during it. Over the same placed setup the plain driver (loop="plain")
    and the host loop (loop="host", the window arithmetic on CUDA) give
    its, reason, history and x bit for bit; the K1, K4, K5, K6 and
    control launches and the halo exchanges per solve equal the plain
    driver's, K5 and K6 above 0, and K1, K4, K5 and K6 the host
    loop's."""
    slv, prob = _cart_solver([cuda] * 4, mx=8)
    assert slv.smesh.capturable and slv.loop == "device"
    graph = slv._dev.graph
    assert graph is not None
    mesh, fes, coeff, bci, bcv = prob
    f1, f2 = assemble_rhs(fes, coeff["Fu"], coeff["Fp"])
    F = scatter_vector(mesh, f1, f2)
    F[:mesh.nu][bci] = bcv
    F = F + slv.setup["rhs_diri"]
    n0 = graph.launches
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rg, kg, cg = _counted(lambda: slv.solve(F))
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert graph.launches == n0 + 1 and slv._dev.host_launches == 0
    assert rg["loop"] == "device" and rg["reason"] == "CONVERGED_RTOL"
    runs = {}
    for loop in ("plain", "host"):
        runs[loop] = _counted(lambda: slv.with_loop(loop).solve(F))
    for loop, (r, k, c) in runs.items():
        assert r["loop"] == loop
        assert (r["its"], r["reason"]) == (rg["its"], rg["reason"]), loop
        assert r["history"] == rg["history"], loop
        assert np.array_equal(r["x"], rg["x"]), loop
        assert r["halo_exchanges"] == rg["halo_exchanges"] > 0, loop
        assert k == kg, loop
    assert kg[0] > 0 and kg[2] > 0 and kg[3] > 0 and kg[K5] > 0
    assert cg == runs["plain"][2]
    assert cg["gcr_ctl"] > 0 and cg["fgmres_arnoldi_ctl"] > 0
    assert all(n == 0 for n in runs["host"][2].values())


@pytest.mark.gpu
def test_two_process_cart_solve_on_cuda(cuda, tmp_path):
    """Pseudoice at mx=16 in two gloo processes x 2 shards on cuda:0
    (device grid 1x2x2, host axis z) against the one-process 4-shard
    solve on cuda:0: its, history and x bitwise, with the setup of every
    process alone and with a real HostComm (against the simulated one);
    both ranks the same x."""
    import torch_multihost_worker as worker
    from exsaddle_tpu_torch.parallel import multihost
    worker.spawn(worker.run_solve, tmp_path, 2, (1, 2), "cuda:0",
                 (16, 16, 16), timeout=600)
    part = multihost.host_partition(worker.problem((16, 16, 16))[1],
                                    worker.N_HOSTS, 2, chip_shape=(1, 2))
    for mode in ("none", "comm"):
        want = worker.one_process(part, mode, device="cuda:0")
        assert want["reason"] == "CONVERGED_RTOL"
        for rank in range(worker.N_HOSTS):
            got = dict(np.load(tmp_path / f"solve_{mode}{rank}.npz"))
            assert got["shards"].tolist() == [2 * rank, 2 * rank + 1]
            assert int(got["its"]) == want["its"]
            assert np.array_equal(got["F"], want["F"])
            assert np.array_equal(got["history"], want["history"]), mode
            assert np.array_equal(got["x"], want["x"]), mode


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


# graphed against eager=True solves, mx=8 pseudoice, 3 levels: the float64
# direct solve, float32 inner solves with float64 refinement, and the
# fieldsplit PC with 3 fixed V-cycles captured whole (float32 IR)
GRAPH_CASES = {"f64_direct": dict(dtype=torch.float64),
               "f32_ir": dict(dtype=torch.float32, ir=True),
               "fixed3_f32_ir": dict(dtype=torch.float32, ir=True,
                                     u_fixed_vcycles=3)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_graphed_solve_equals_eager_on_cuda(cuda, case):
    """The solver's captured bodies give the eager=True solve over the same
    setup bit for bit (x, history, iterations, rounds), with the same K1
    launches and applies and the same K4 and K6 launches."""
    from exsaddle_tpu_torch import bench, graphs
    from exsaddle_tpu_torch.abf import ABFSolver
    kw = GRAPH_CASES[case]
    ir = kw.get("ir", False)
    p = bench._build_problem(8, with_rhs=True)
    g = ABFSolver(p["mesh"], p["fes"], p["coeff"], p["bc_idx"], p["bc_vals"],
                  device=cuda, nlevels=3, loop="host", **kw)
    e = ABFSolver.from_parts(g.cfg, g.data, g.setup, device=cuda,
                             dtype=kw["dtype"], ir=ir, eager=True)
    assert (g.loop, e.loop) == ("host", "host")
    captured = [n for n, b in g.bodies().items()
                if isinstance(b, graphs.Captured)]
    assert captured == (["mult", "pc_apply"] if "u_fixed_vcycles" in kw
                        else ["mult", "mg_pc", "p_solve"])
    assert not any(isinstance(b, graphs.Captured)
                   for b in e.bodies().values())
    F = p["F_raw"] + g.setup["rhs_diri"]
    out = {}
    for name, slv in (("graph", g), ("eager", e)):
        _reset_kernel_counts()
        r = slv.solve_ir(F, rtol=1e-8) if ir else slv.solve(F)
        out[name] = (r, _kernel_counts(), graphs.replays(slv.bodies()))
    (rg, kg, pg), (re_, ke, pe) = out["graph"], out["eager"]
    keys = ("rounds", "inner_its") if ir else ("its", "reason")
    assert [rg[k] for k in keys] == [re_[k] for k in keys]
    assert rg["history"] == re_["history"]
    assert np.array_equal(rg["x"], re_["x"])
    assert kg == ke and kg[1] > 0 and kg[2] > 0 and kg[3] > 0
    assert kg[K5] > 0
    assert pg > 0 and pe == 0
    if ir:
        assert rg["converged"] and not rg["stalled"]


@pytest.mark.gpu
def test_capture_of_a_host_read_raises(cuda):
    """A body that reads a device value on the host fails at capture, and
    the sync debug mode is restored."""
    from exsaddle_tpu_torch import graphs

    def body(t):
        return t * t.sum().item()

    with pytest.raises(RuntimeError):
        graphs.Captured(body, torch.ones(4, device=cuda))
    assert torch.cuda.get_sync_debug_mode() == 0
    doubled = graphs.Captured(lambda t: 2 * t, torch.ones(4, device=cuda))
    assert torch.equal(doubled(torch.arange(4.0, device=cuda)),
                       2 * torch.arange(4.0, device=cuda))
    with pytest.raises(ValueError):
        doubled(torch.ones(5, device=cuda))


# --- the device loop: Krylov control kernels and the conditional graph ------

def _bits(t):
    """A tensor's bit pattern (NaN-safe bitwise comparison)."""
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t


def _same_bits(a, b):
    """Bit for bit, NaN matching NaN (its payload is the hardware's)."""
    if a.is_floating_point():
        na, nb = torch.isnan(a), torch.isnan(b)
        if not torch.equal(na, nb):
            return False
        a, b = torch.where(na, 0, a), torch.where(nb, 0, b)
    return torch.equal(_bits(a), _bits(b))


class _Ns:
    def __init__(self, **kw):
        self.__dict__.update(kw)

    def clone(self):
        return _Ns(**{k: v.clone() if isinstance(v, torch.Tensor) else v
                      for k, v in self.__dict__.items()})


def _fgmres_ctl_state(dtype, device, seed, it, itc, r0, par, max_it, k=30,
                      hist_len=256, git=None):
    """A recorded FGMRES control state at the main path's sizes (restart
    30, hist_len 256) from a numpy seed."""
    rng = np.random.default_rng(seed)
    H = np.zeros((k + 1, k))
    H[:it + 1, :it] = np.triu(rng.standard_normal((it + 1, it)))
    H[np.arange(it), np.arange(it)] += 2.0
    g = np.zeros(k + 1)
    g[:it + 1] = rng.standard_normal(it + 1)
    if git is not None:
        g[it] = git
    ang = rng.random(k) * 2 * np.pi
    cs, sn = np.cos(ang), np.sin(ang)
    cs[it:], sn[it:] = 0, 0
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa
    return _Ns(k=k, hist_len=hist_len, max_it=max_it, H=t(H), g=t(g),
               cs=t(cs), sn=t(sn), y=t(rng.standard_normal(k)),
               hist=t(np.full(hist_len, -1.0)),
               sc=t([r0, rng.random(), rng.random()]), par=t(par),
               ints=torch.tensor([0, it, itc], dtype=torch.int32,
                                 device=device),
               ix=torch.tensor([it, it + 1], dtype=torch.int64,
                               device=device), p0=0, c0=0)


def _ctl_pair(device):
    from exsaddle_tpu_torch import graphs
    return graphs.Control(device), graphs.Control(device)


def _state_equal(a, b):
    return all(_same_bits(getattr(a, n), getattr(b, n))
               for n, v in a.__dict__.items() if isinstance(v, torch.Tensor))


def _ctl_equal(c1, c2):
    return torch.equal(c1.pred, c2.pred) and torch.equal(c1.counts, c2.counts)


# (it, itc, h scale, tt, r0, (rtol, atol, dtol), max_it, g[it]) recorded
# Arnoldi states covering every state branch: running, rtol, atol, happy
# breakdown, delta == 0, dtol, max_it, a restart (it = k - 1)
ARNOLDI_BRANCHES = {
    "running": (3, 3, 1.0, 0.7, 10.0, (1e-5, 1e-50, 1e4), 10000, None),
    "rtol": (4, 9, 1.0, 1e-9, 1.0, (1e-3, 1e-50, 1e4), 10000, None),
    "atol": (3, 3, 1.0, 1e-12, 1.0, (1e-30, 1e-3, 1e4), 10000, None),
    "happy": (2, 2, 1.0, 1e-31, 1.0, (1e-45, 1e-50, 1e4), 10000, 0.5),
    "delta0": (0, 0, 0.0, 0.0, 1.0, (1e-30, 1e-50, 1e4), 10000, None),
    "dtol": (1, 1, 1.0, 0.5, 1e-3, (1e-12, 1e-50, 1.0), 10000, None),
    "max_it": (2, 6, 1.0, 0.3, 100.0, (1e-12, 1e-50, 1e4), 7, None),
    "restart": (29, 41, 1.0, 0.3, 100.0, (1e-12, 1e-50, 1e4), 10000, None),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("branch", list(ARNOLDI_BRANCHES))
def test_fgmres_arnoldi_ctl_bitwise_twin(cuda, branch, dtype):
    from exsaddle_tpu_torch.kernels import krylov_ctl as kc
    it, itc, hs, tt, r0, par, max_it, git = ARNOLDI_BRANCHES[branch]
    a = _fgmres_ctl_state(dtype, cuda, len(branch), it, itc, r0, par,
                          max_it, git=git)
    b = a.clone()
    rng = np.random.default_rng(7)
    h = hs * rng.standard_normal(a.k + 1)
    h[it + 1:] = 0
    if branch in ("rtol", "atol", "happy"):
        h[it] = 3.0
    h = torch.as_tensor(h, dtype=dtype, device=cuda)
    tt = torch.tensor(tt, dtype=dtype, device=cuda)
    c1, c2 = _ctl_pair(cuda)
    n0 = kc.LAUNCHES.n["fgmres_arnoldi_ctl"]
    kc.fgmres_arnoldi_ctl(a, h, tt, c1)
    kc.fgmres_arnoldi_ctl_plain(b, h, tt, c2)
    torch.cuda.synchronize()
    assert kc.LAUNCHES.n["fgmres_arnoldi_ctl"] == n0 + 1
    assert _state_equal(a, b) and _ctl_equal(c1, c2)
    if branch == "restart":
        assert a.ints[1].item() == -1 and c1.pred[3].item() == 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("mode,beta,itc,par", [
    (0, 1.0, 5, (1e-5, 1e-50, 1e4)), (1, 2.5, 0, (1e-5, 1e-50, 1e4)),
    (1, 0.0, 0, (1e-5, 1e-50, 1e4)), (1, 1e-7, 30, (1e-5, 1e-50, 1e4)),
    (1, 7.0, 30, (1e-5, 1e-50, 2.0)), (1, 1e-9, 12, (1e-30, 1e-6, 1e4))],
    ids=["init", "first", "zero", "rtol", "dtol", "atol"])
def test_fgmres_start_ctl_bitwise_twin(cuda, mode, beta, itc, par, dtype):
    from exsaddle_tpu_torch.kernels import krylov_ctl as kc
    a = _fgmres_ctl_state(dtype, cuda, 3, 4, itc, 3.0, par, 10000)
    b = a.clone()
    beta = torch.tensor([beta], dtype=dtype, device=cuda)
    c1, c2 = _ctl_pair(cuda)
    kc.fgmres_start_ctl(mode, a, beta, c1)
    kc.fgmres_start_ctl_plain(mode, b, beta, c2)
    torch.cuda.synchronize()
    assert _state_equal(a, b) and _ctl_equal(c1, c2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_gcr_ctl_bitwise_twin(cuda, dtype):
    """Init (running, atol), steps through the nv wrap, rtol, max_it and
    alpha == 0: kernel and twin step by step."""
    from exsaddle_tpu_torch.kernels import krylov_ctl as kc
    t = lambda v: torch.tensor(v, dtype=dtype, device=cuda)   # noqa: E731
    a = _Ns(sc=t([0.0, 0.0, 0.0]), par=t([1e-2, 1e-50]),
            ints=torch.zeros(3, dtype=torch.int32, device=cuda),
            ix=torch.zeros(1, dtype=torch.int64, device=cuda), restart=3,
            max_it=6, p=0, c0=0)
    b = a.clone()
    c1, c2 = _ctl_pair(cuda)
    seq = [(0, 1.0, 4.0)] + [(1, 1.0, r) for r in
                              (2.0, 1.0, 0.5, 0.3, 0.2, 0.1)] + [
        (0, 1.0, 4.0), (1, 0.0, 3.0), (0, 1.0, 1e-60), (0, 1.0, 5.0),
        (1, 1.0, 0.01)]
    for mode, alpha, rn in seq:
        kc.gcr_ctl(mode, a, t(alpha), t(rn), c1)
        kc.gcr_ctl_plain(mode, b, t(alpha), t(rn), c2)
        torch.cuda.synchronize()
        assert _state_equal(a, b) and _ctl_equal(c1, c2), (mode, alpha, rn)


@pytest.mark.gpu
def test_ir_ctl_bitwise_twin(cuda):
    """Init, accepted rounds, a rejected (diverged) round, a
    non-contracting round, convergence and the n_rounds bound."""
    from exsaddle_tpu_torch.kernels import krylov_ctl as kc
    f64 = dict(dtype=torch.float64, device=cuda)
    a = _Ns(sc=torch.tensor([0.0, 0.0, 1e-8, 3.0], **f64),
            ints=torch.zeros(5, dtype=torch.int32, device=cuda),
            hist=torch.zeros(11, **f64), p=0, c0=0)
    b = a.clone()
    c1, c2 = _ctl_pair(cuda)
    fg = torch.zeros(3, dtype=torch.int32, device=cuda)
    seq = [(0, 2.0, 2), (1, 1e-4, 2), (1, 1e-6, -3), (0, 2.0, 2),
           (1, 1.0, 2), (1, 3.0, 2), (0, 2.0, 2), (1, 1.0, 2),
           (1, 1e-9, 2), (0, 2.0, 2), (1, 1.0, 2), (1, 0.5, 2),
           (1, 0.25, 5)]
    for mode, rn, state in seq:
        fg[0], fg[2] = state, 7
        rn_t = torch.tensor(rn, **f64)
        kc.ir_ctl(mode, a, rn_t, fg, c1)
        kc.ir_ctl_plain(mode, b, rn_t, fg, c2)
        torch.cuda.synchronize()
        assert _state_equal(a, b) and _ctl_equal(c1, c2), (mode, rn, state)


def _device_problem(mx=8):
    from exsaddle_tpu_torch import bench
    return bench._build_problem(mx, with_rhs=True)


def _kernel_counts():
    """(K1 launches, K1 applies, K4 launches, K6 launches, then K4's fused
    launches by epilogue, K5's launches (index K5), then K5's by form) so
    far."""
    return ((a00.LAUNCHES.n, a00.LAUNCHES.applies, stencil.LAUNCHES.n,
             cheb.LAUNCHES.n)
            + tuple(stencil.LAUNCHES.fused[e] for e in stencil.EPILOGUES)
            + (transfer.LAUNCHES.n,)
            + tuple(transfer.LAUNCHES.by[f] for f in transfer.FORMS))


# _kernel_counts()'s index of K5's launches
K5 = 4 + len(stencil.EPILOGUES)


def _reset_kernel_counts():
    for k in (a00, stencil, cheb, transfer, mp):
        k.LAUNCHES.reset()


def _counted(fn):
    """fn()'s result with the K1 (launches, applies), K4 and K6 launches
    and the control-kernel launches it made."""
    from exsaddle_tpu_torch.kernels import krylov_ctl as kc
    _reset_kernel_counts()
    kc.LAUNCHES.reset()
    r = fn()
    return r, _kernel_counts(), dict(kc.LAUNCHES.n)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_device_loop_graph_equals_plain_driver_on_cuda(cuda, case):
    """loop="device" on CUDA (one graph launch per solve) against the plain
    driver over the same setup (loop="plain": the same steps from
    Python): x, history and counts bit for bit, the same K1, K4, K6 and
    control-kernel launches. Against loop="host" over the same setup,
    which on CUDA does the device loop's window arithmetic
    (make_abf_solver window=True): the same iteration counts, reason,
    history and x, bit for bit, in float64 and float32. (With the host
    loop's sliced dots, on an H100, fixed3_f32_ir took 3 / 82 on the
    device loop against 3 / 83 before the K4 kernel and 3 / 79 against
    3 / 83 with it.)"""
    from exsaddle_tpu_torch.abf import ABFSolver
    kw = GRAPH_CASES[case]
    ir = kw.get("ir", False)
    p = _device_problem()
    g = ABFSolver(p["mesh"], p["fes"], p["coeff"], p["bc_idx"], p["bc_vals"],
                  device=cuda, nlevels=3, **kw)
    assert g.loop == "device" and g._dev.graph is not None
    plain = ABFSolver.from_parts(g.cfg, g.data, g.setup, device=cuda,
                                 dtype=kw["dtype"], ir=ir, loop="plain")
    host = ABFSolver.from_parts(g.cfg, g.data, g.setup, device=cuda,
                                dtype=kw["dtype"], ir=ir, loop="host")
    assert plain._dev.graph is None
    F = p["F_raw"] + g.setup["rhs_diri"]
    run = (lambda s: s.solve_ir(F, rtol=1e-8)) if ir else \
        (lambda s: s.solve(F))
    n0 = g._dev.graph.launches
    rg, kg, cg = _counted(lambda: run(g))
    assert g._dev.graph.launches == n0 + 1
    rp, kp, cp = _counted(lambda: run(plain))
    rh, _, _ = _counted(lambda: run(host))
    keys = ("rounds", "inner_its", "stalled") if ir else ("its", "reason")
    assert [rg[k] for k in keys] == [rp[k] for k in keys]
    assert rg["history"] == rp["history"]
    assert np.array_equal(rg["x"], rp["x"])
    assert kg == kp and kg[1] > 0 and kg[2] > 0 and kg[3] > 0
    assert kg[K5] > 0
    assert cg == cp and cg["fgmres_arnoldi_ctl"] > 0
    if ir:
        assert rg["converged"]
    assert [rg[k] for k in keys] == [rh[k] for k in keys]
    assert rg["history"] == rh["history"]
    assert np.array_equal(rg["x"], rh["x"])


@pytest.mark.gpu
def test_device_loop_new_rtol_replays_without_recapture(cuda):
    """A float32 IR solver: solves at rtol 1e-8, 1e-5, 1e-8 and, under
    torch.cuda.set_sync_debug_mode("error") (any host read raises), 1e-8
    again replay the one graph captured at construction; the first, third
    and fourth agree bit for bit, the looser one stops no later."""
    from exsaddle_tpu_torch.abf import ABFSolver
    p = _device_problem()
    g = ABFSolver(p["mesh"], p["fes"], p["coeff"], p["bc_idx"], p["bc_vals"],
                  device=cuda, nlevels=3, dtype=torch.float32, ir=True)
    graph = g._dev.graph
    F = p["F_raw"] + g.setup["rhs_diri"]
    r1 = g.solve_ir(F, rtol=1e-8)
    r2 = g.solve_ir(F, rtol=1e-5)
    r3 = g.solve_ir(F, rtol=1e-8)
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        r4 = g.solve_ir(F, rtol=1e-8)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert g._dev.graph is graph and graph.launches == 4
    assert r1["converged"] and r2["converged"]
    assert r2["rnorm"] <= 1e-5 * r2["rnorm0"]
    assert r2["rounds"] <= r1["rounds"]
    for r in (r3, r4):
        assert np.array_equal(r["x"], r1["x"])
        assert r["history"] == r1["history"]
        assert (r["rounds"], r["inner_its"]) == (r1["rounds"],
                                                 r1["inner_its"])


@pytest.mark.gpu
def test_device_loop_direct_solve_of_ir_solver_on_cuda(cuda):
    """An ir=True solver captures its direct solve's graph at construction,
    over the refinement's captured FGMRES loop (the same child graphs, no
    second capture): solve() is one launch of it, bit for bit the direct
    solve of an ir=False solver over the same setup, and a refinement
    after it gives the first refinement's bits."""
    from exsaddle_tpu_torch.abf import ABFSolver
    p = _device_problem()
    g = ABFSolver(p["mesh"], p["fes"], p["coeff"], p["bc_idx"], p["bc_vals"],
                  device=cuda, nlevels=3, dtype=torch.float32, ir=True)
    dev = g._dev
    direct = dev.direct_graph
    assert direct is not None and direct is not dev.graph
    own = {id(q[1]) for q in direct.pieces} - {id(q[1]) for q in
                                               dev.graph.pieces}
    assert len(own) == 2      # the direct solve's init and result pieces
    solo = ABFSolver.from_parts(g.cfg, g.data, g.setup, device=cuda,
                                dtype=torch.float32)
    F = p["F_raw"] + g.setup["rhs_diri"]
    r1 = g.solve_ir(F, rtol=1e-8)
    a, b = g.solve(F), solo.solve(F)
    assert direct.launches == 1 and dev.graph.launches == 1
    assert (a["its"], a["reason"]) == (b["its"], b["reason"])
    assert np.array_equal(a["x"], b["x"]) and a["history"] == b["history"]
    r2 = g.solve_ir(F, rtol=1e-8)
    assert np.array_equal(r2["x"], r1["x"]) and r2["history"] == r1["history"]


@pytest.mark.gpu
def test_shadowed_graph_launch_runs_once_per_solve_on_cuda(cuda):
    """What the benchmark's per-solve device spans rely on: a launch
    shadowed on the instance slv._dev.graph (as benchmark/harness.py's
    GraphSpans shadows it) is called exactly once per solve, and the
    solve's result is the unshadowed one's, for ABFSolver without ir
    (solve) and with it (solve_ir) and for the one-card CartABFSolver; the
    cards' solver (CartCardsSolver, here over CPU threads) has no graph,
    so nothing attaches there."""
    from exsaddle_tpu_torch.abf import ABFSolver
    from exsaddle_tpu_torch.kernels import peer
    from exsaddle_tpu_torch.parallel import cart_abf
    p = _device_problem(4)
    runs = []
    for kw in (dict(dtype=torch.float64), dict(dtype=torch.float32,
                                              ir=True)):
        g = ABFSolver(p["mesh"], p["fes"], p["coeff"], p["bc_idx"],
                      p["bc_vals"], device=cuda, nlevels=3, **kw)
        F = p["F_raw"] + g.setup["rhs_diri"]
        runs.append((g, (lambda s, F=F: s.solve_ir(F, rtol=1e-8))
                     if kw.get("ir") else (lambda s, F=F: s.solve(F))))
    cart, (mesh, fes, coeff, bci, bcv) = _cart_solver([cuda] * 4, model="2",
                                                      mx=4)
    assert cart.loop == "device"
    f1, f2 = assemble_rhs(fes, coeff["Fu"], coeff["Fp"])
    F = scatter_vector(mesh, f1, f2)
    F[:mesh.nu][bci] = bcv
    F = F + cart.setup["rhs_diri"]
    runs.append((cart, lambda s: s.solve(F)))
    for slv, run in runs:
        graph = slv._dev.graph
        assert graph is not None
        want = run(slv)
        calls = []
        launch = graph.launch

        def counted(launch=launch, calls=calls):
            calls.append(1)
            launch()
        graph.launch = counted
        try:
            for k in (1, 2):
                got = run(slv)
                assert len(calls) == k
                assert np.array_equal(got["x"], want["x"])
                assert got["history"] == want["history"]
        finally:
            del graph.launch
    slv, _ = _cart_solver(["cpu"] * 4, model="2", mx=4)
    ops = slv.blocks.ops.parts[0]
    cards = cart_abf.CartCardsSolver(slv.dcfg, slv.smesh, slv.ddata,
                                     slv.blocks,
                                     peer.ThreadGroup(4, ops.nu + ops.np_),
                                     graph=False)
    assert getattr(cards, "graph", None) is None
    assert cards.ctl is cards.views[0].ctl


@pytest.mark.gpu
def test_device_loop_build_failure_raises(cuda, monkeypatch):
    """loop="device" on CUDA never falls back: a shim that fails to build
    raises out of the constructor, and so does the cudaMallocAsync
    allocator (its memory nodes cannot sit in a conditional body)."""
    from exsaddle_tpu_torch import graphs
    from exsaddle_tpu_torch.abf import ABFSolver
    p = _device_problem(4)
    g = ABFSolver(p["mesh"], p["fes"], p["coeff"], p["bc_idx"], p["bc_vals"],
                  device=cuda, nlevels=3, loop="host")

    def broken():
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(graphs, "_shim", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ABFSolver.from_parts(g.cfg, g.data, g.setup, device=cuda,
                             dtype=torch.float64)
    monkeypatch.undo()
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", "backend:cudaMallocAsync")
    with pytest.raises(RuntimeError, match="cudaMallocAsync"):
        ABFSolver.from_parts(g.cfg, g.data, g.setup, device=cuda,
                             dtype=torch.float64)


def _graph_kernel_nodes(g):
    """The kernel nodes of a torch graph captured with keep_graph."""
    import ctypes
    from exsaddle_tpu_torch import graphs
    lib = graphs._shim()
    n = ctypes.c_ulonglong()
    assert lib.gc_kernel_nodes(ctypes.c_void_p(g.raw_cuda_graph()),
                               ctypes.byref(n)) == 0
    return n.value


@pytest.mark.gpu
def test_traced_device_loop_on_cuda(cuda):
    """A float32 IR solver traced (trace.Trace) over the setup of an
    untraced one: solve_ir and solve give the untraced x, rounds, its,
    histories and counts bit for bit; each solve's marks run forward in
    time, nested and in order; every device solve span lies inside its
    solve_call within the calibration's error. Each captured piece of the
    untraced graph has exactly graphs.kernels_per_call's kernel nodes of
    its function (the graph the untraced solver captured before the
    tracer), the traced one 2 more per span marked in it; kernel_nodes
    (counts) is the kernels_per_call sum over the pieces times their
    executions, whichever graph counts it."""
    from exsaddle_tpu_torch import graphs
    from exsaddle_tpu_torch.abf import ABFSolver
    from exsaddle_tpu_torch.trace import Trace
    p = _device_problem()
    g = ABFSolver(p["mesh"], p["fes"], p["coeff"], p["bc_idx"], p["bc_vals"],
                  device=cuda, nlevels=3, dtype=torch.float32, ir=True)
    tr = Trace(cuda)
    t = ABFSolver.from_parts(g.cfg, g.data, g.setup, device=cuda,
                             dtype=torch.float32, ir=True, trace=tr)
    assert g._dev.ctl.trace is None and t._dev.graph is not None
    F = p["F_raw"] + g.setup["rhs_diri"]
    results = []
    for run, keys in ((lambda s: s.solve_ir(F, rtol=1e-8),
                       ("rounds", "inner_its", "stalled", "counts")),
                      (lambda s: s.solve(F), ("its", "reason", "counts"))):
        a, b = run(g), run(t)
        assert [a[k] for k in keys] == [b[k] for k in keys]
        assert a["history"] == b["history"]
        assert np.array_equal(a["x"], b["x"])
        results.append(b)
    col = tr.collect()
    assert col["drops"] == 0 and len(col["calibration"]) == 2
    err = max(c["error_ns"] for c in col["calibration"])
    spans = col["spans"]
    kids = {}
    for i, s in enumerate(spans):
        kids.setdefault(s.parent, []).append(i)
    for k in (1, 2):
        call = next(s for s in spans if s.name == "solve_call"
                    and s.solve == k)
        i = next(i for i, s in enumerate(spans) if s.device
                 and s.name == "solve" and s.solve == k)
        dev = spans[i]
        assert call.start - err <= dev.start < dev.end <= call.end + err
        mine = [j for j, s in enumerate(spans) if s.device and s.solve == k]
        starts = [spans[j].start for j in mine]
        assert starts == sorted(starts)
        for j in mine:
            s = spans[j]
            assert s.end is not None and s.start <= s.end
            if s.parent is not None:
                q = spans[s.parent]
                assert q.start <= s.start and s.end <= q.end
            sib = [spans[c] for c in kids.get(j, [])]
            assert all(x.end <= y.start for x, y in zip(sib, sib[1:]))

    def inside(j):
        return sum(1 + inside(c) for c in kids.get(j, []))
    marked = {}
    for j in kids.get(next(i for i, s in enumerate(spans) if s.device
                           and s.name == "solve" and s.solve == 1), []):
        marked.setdefault(spans[j].name, set()).add(1 + inside(j))
    for dev, traced in ((g._dev, False), (t._dev, True)):
        for q in dev.graph.pieces:
            kpc = graphs.kernels_per_call(q.piece.fn)
            assert _graph_kernel_nodes(q.graph) == kpc + q.marks
            if traced:
                assert q.marks > 0 and q.marks % 2 == 0
                if q.name in marked:
                    assert marked[q.name] == {q.marks // 2}
            else:
                assert q.marks == 0
    for res, graph in zip(results, (t._dev.graph, t._dev.direct_graph)):
        slots = t._dev.ctl.slots(res["counts"])
        want = sum((1 if q.slot is None else slots[q.slot])
                   * graphs.kernels_per_call(q.piece.fn)
                   for q in graph.pieces)
        got = t.kernel_nodes(res["counts"])
        assert got["total"] == want == g.kernel_nodes(res["counts"])["total"]
        assert sum(got["pieces"].values()) == want
        assert got["launches"]["krylov_ctl.fgmres_arnoldi_ctl"] == \
            res["counts"]["fgmres_its"]
        assert got["launches"]["a00.n"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_device_loop_k1_applies_factored_at_mx32(cuda, dtype):
    """The mx=32 pseudoice flagship as the benchmark solves it (abf.opts,
    4 levels): a device-loop solve, float32 inner solves in float64
    refinement or float64 throughout, counts every K1 apply of its graph
    as factored (a00.factored == a00.applies, by ABFSolver.kernel_nodes),
    two launches per apply, and converges."""
    from exsaddle_tpu_torch import bench
    from exsaddle_tpu_torch.abf import ABFSolver
    p = _device_problem(32)
    ir = dtype == torch.float32
    slv = ABFSolver(p["mesh"], p["fes"], p["coeff"], p["bc_idx"],
                    p["bc_vals"], device=cuda, dtype=dtype, ir=ir,
                    nlevels=bench.bench_nlevels(p["mesh"]),
                    **bench.ABFOPTS_KW)
    assert slv.loop == "device"
    F = p["F_raw"] + slv.setup["rhs_diri"]
    r = slv.solve_ir(F, rtol=1e-8) if ir else slv.solve(F)
    got = slv.kernel_nodes(r["counts"])["launches"]
    assert got["a00.applies"] > 0
    assert got["a00.factored"] == got["a00.applies"]
    assert got["a00.n"] == a00.KERNELS_PER_APPLY * got["a00.applies"]
    assert r["converged"] if ir else r["reason"].startswith("CONVERGED")


# --- K4 and K6: the multigrid kernels ----------------------------------------

# K4 against its twin, relative to max_k sum_{s,j} |W||x| (the kernel sums
# slot by slot, the twin in torch's order)
K4_TOL = {torch.float32: 1e-5, torch.float64: 1e-13}

# (ndim, nd, grid): ragged node counts (no multiple of a block's 32 / 16
# nodes) and the mx=32 flagship's L-3 and L-2 grids
K4_CASES = [(2, 2, (7, 13)), (2, 3, (33, 5)), (3, 2, (3, 5, 7)),
            (3, 3, (5, 9, 11)), (3, 3, (17, 17, 17)), (3, 3, (33, 33, 33))]


def _stencil_inputs(ndim, nd, grid, dtype, device, seed, offset=0):
    """W and xp (nonzero ghosts) from a numpy seed; offset > 0 places W
    that many values into its buffer (contiguous, not 16-byte aligned)."""
    rng = np.random.default_rng(seed)
    W = torch.as_tensor(rng.standard_normal(grid + (3 ** ndim, nd, nd)),
                        dtype=dtype, device=device)
    xp = torch.as_tensor(rng.standard_normal(
        tuple(g + 2 for g in grid) + (nd,)), dtype=dtype, device=device)
    if offset:
        buf = torch.empty(W.numel() + offset, dtype=dtype, device=device)
        buf[offset:].copy_(W.reshape(-1))
        W = buf[offset:].view(W.shape)
    return W, xp


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", K4_CASES,
                         ids=["x".join(map(str, c[2])) + f"_nd{c[1]}"
                              for c in K4_CASES])
def test_stencil_kernel_within_tolerance(cuda, case, dtype, offset):
    """K4 against its plain twin within K4_TOL, one launch per call,
    bitwise repeatable; a W that is not 16-byte aligned (its tiles arrive
    by bulk copies) is refused before a launch."""
    ndim, nd, grid = case
    W, xp = _stencil_inputs(ndim, nd, grid, dtype, cuda, 31, offset)
    n0 = stencil.LAUNCHES.n
    if offset:
        with pytest.raises(ValueError, match="16-byte aligned"):
            stencil.stencil_accum(W, xp)
        assert stencil.LAUNCHES.n == n0
        return
    y = stencil.stencil_accum(W, xp)
    assert stencil.LAUNCHES.n == n0 + 1
    want = stencil.stencil_accum_plain(W, xp)
    mag = float(stencil.stencil_accum_plain(W.abs(), xp.abs()).max())
    torch.cuda.synchronize()
    assert y.shape == want.shape == grid + (nd,)
    assert float((y - want).abs().max()) <= K4_TOL[dtype] * mag
    assert torch.equal(stencil.stencil_accum(W, xp), y)


@pytest.mark.gpu
def test_kernels_per_call_counts_a_captures_kernel_nodes(cuda):
    """graphs.kernels_per_call (phase K1's launch count): one K1 apply
    captures 2 kernel nodes, one fused K4 step 1; the wrappers' launch
    counts are left as they were."""
    from exsaddle_tpu_torch import graphs
    op = _operator(CASES[1], torch.float32, cuda)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(op.nu),
                        dtype=torch.float32, device=cuda)
    W, xp = _stencil_inputs(3, 3, (5, 7, 9), torch.float32, cuda, 6)
    v = xp[1:-1, 1:-1, 1:-1].contiguous()
    n0 = _kernel_counts()
    assert graphs.kernels_per_call(lambda: a00.a00_apply(op, x)) == 2
    n1 = _kernel_counts()
    assert graphs.kernels_per_call(lambda: stencil.stencil_cheb_step(
        W, v, v, v, v, 0.5, 1.2)) == 1
    n2 = _kernel_counts()
    # the warm-up call of each counts, the capture does not
    assert (n1[0] - n0[0], n2[2] - n1[2]) == (2, 1)


# K4's fused epilogues: the flagship's L-2 and L-3 grids, a cart shard's
# L-2 slab (1x2x2 device grid) and a node count no tile divides
FUSED_GRIDS = [(33, 33, 33), (17, 17, 17), (17, 17, 33), (5, 7, 9)]


def _fused_outputs(W, xp, b, d, q, padded, scale=0.37, omega=1.61):
    """{epilogue: (fused entry's output, K4's apply followed by K6 / the
    subtraction)} on xp (padded) or its interior (zero boundary)."""
    ndim = xp.ndim - 1
    x = xp[(slice(1, -1),) * ndim].contiguous()
    v = xp if padded else x
    y = stencil.stencil_accum(W, xp) if padded else stencil.stencil_apply(
        W, x)
    return {"none": (y, stencil.stencil_accum(W, stencil._pad(x))
                     if not padded else y),
            "residual": (stencil.stencil_residual(W, v, b, padded=padded),
                         b - y),
            "cheb_first": (stencil.stencil_cheb_first(W, v, b, d, scale,
                                                      padded=padded),
                           cheb.cheb_first(b, y, d, x, scale)),
            "cheb_step": (stencil.stencil_cheb_step(W, v, b, d, q, scale,
                                                    omega, padded=padded),
                          cheb.cheb_step(b, y, d, x, q, scale, omega))}


@pytest.mark.gpu
@pytest.mark.parametrize("padded", [False, True],
                         ids=["zero_boundary", "padded"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("grid", FUSED_GRIDS,
                         ids=["x".join(map(str, g)) for g in FUSED_GRIDS])
def test_stencil_epilogues_bitwise_k4_then_k6(cuda, grid, dtype, padded):
    """Every fused epilogue bit for bit K4's apply followed by K6 (or the
    subtraction), zero ghosts in both forms (the zero-boundary form also
    bitwise the padded one); one K4 launch per call, each counted under
    its epilogue, no K6 launch."""
    W, xp = _stencil_inputs(3, 3, grid, dtype, cuda, 41)
    xp = stencil._pad(xp[1:-1, 1:-1, 1:-1])
    rng = np.random.default_rng(42)
    b, d, q = (torch.as_tensor(rng.standard_normal(grid + (3,)), dtype=dtype,
                               device=cuda) for _ in range(3))
    n0, f0, c0 = (stencil.LAUNCHES.n, dict(stencil.LAUNCHES.fused),
                  cheb.LAUNCHES.n)
    out = _fused_outputs(W, xp, b, d, q, padded)
    # the fused calls: one launch each; the reference applies: 2 (zero
    # boundary: both forms) or 1 (padded) K4 launches and 2 K6 launches
    assert stencil.LAUNCHES.n - n0 == 3 + (2 if not padded else 1)
    assert {e: stencil.LAUNCHES.fused[e] - f0[e]
            for e in stencil.EPILOGUES} == dict.fromkeys(stencil.EPILOGUES,
                                                         1)
    assert cheb.LAUNCHES.n - c0 == 2
    torch.cuda.synchronize()
    for e, (got, want) in out.items():
        assert _same_bits(got, want), e


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", K4_CASES[:4],
                         ids=["x".join(map(str, c[2])) + f"_nd{c[1]}"
                              for c in K4_CASES[:4]])
def test_stencil_dispatch_cases_fused_within_tolerance(cuda, case, dtype):
    """All four (ndim, nd) cases, ragged node counts: the zero-boundary
    apply bitwise the padded one and within K4_TOL of the twin, each
    epilogue bitwise the apply followed by K6 / the subtraction, in both
    forms."""
    ndim, nd, grid = case
    W, xp = _stencil_inputs(ndim, nd, grid, dtype, cuda, 43)
    xp = stencil._pad(xp[(slice(1, -1),) * ndim])
    rng = np.random.default_rng(44)
    b, d, q = (torch.as_tensor(rng.standard_normal(grid + (nd,)),
                               dtype=dtype, device=cuda) for _ in range(3))
    want = stencil.stencil_accum_plain(W, xp)
    mag = float(stencil.stencil_accum_plain(W.abs(), xp.abs()).max())
    for padded in (False, True):
        out = _fused_outputs(W, xp, b, d, q, padded)
        torch.cuda.synchronize()
        y = out["none"][0]
        assert float((y - want).abs().max()) <= K4_TOL[dtype] * mag
        for e, (got, ref) in out.items():
            assert _same_bits(got, ref), (padded, e)


def _cheb_vectors(n, dtype, device, seed):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(n), dtype=dtype,
                            device=device) for _ in range(5)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("n", [1, 1000, 35937, 107811, 823875])
def test_cheb_kernels_bitwise_twin(cuda, n, dtype):
    """K6's two entry points bit for bit their twins, with scalars as the
    smoother computes them (numpy scalars of the working dtype) and as
    Python floats that the dtype rounds, one launch per call."""
    b, ap, d, pk, pkm1 = _cheb_vectors(n, dtype, cuda, n)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    emin, emax = npdt(0.0913), npdt(1.8327)
    for scale, omega in ((float(npdt(2.0) / (emax + emin)), 1.2733),
                         (0.1, 1.0 / 3.0)):
        n0 = cheb.LAUNCHES.n
        got = [cheb.cheb_first(b, None, d, pk, scale),
               cheb.cheb_first(b, ap, d, pk, scale),
               cheb.cheb_step(b, ap, d, pk, pkm1, scale, omega)]
        assert cheb.LAUNCHES.n == n0 + 3
        want = [cheb.cheb_first_plain(b, None, d, pk, scale),
                cheb.cheb_first_plain(b, ap, d, pk, scale),
                cheb.cheb_step_plain(b, ap, d, pk, pkm1, scale, omega)]
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert _same_bits(g, w)


@pytest.mark.gpu
def test_cheb_kernel_on_a_view_at_an_odd_offset(cuda):
    """The p-block's right-hand side is a view into the saddle vector at
    an offset that breaks 16-byte alignment: bitwise the twin."""
    full = _cheb_vectors(1001, torch.float32, cuda, 3)
    b, ap, d, pk, pkm1 = (v[1:].view(40, 25) for v in full)
    got = cheb.cheb_step(b, ap, d, pk, pkm1, 0.25, 1.5)
    want = cheb.cheb_step_plain(b, ap, d, pk, pkm1, 0.25, 1.5)
    torch.cuda.synchronize()
    assert got.shape == (40, 25) and _same_bits(got, want)


@pytest.mark.gpu
def test_mg_kernels_refuse_bad_input(cuda):
    """Non-contiguous inputs, mismatched shapes, dtypes or devices raise
    before a launch."""
    W, xp = _stencil_inputs(3, 3, (4, 5, 6), torch.float32, cuda, 2)
    n0 = stencil.LAUNCHES.n
    with pytest.raises(ValueError, match="not contiguous"):
        stencil.stencil_accum(W, xp.transpose(0, 2).contiguous()
                              .transpose(0, 2))
    with pytest.raises(ValueError, match="not contiguous"):
        stencil.stencil_accum(W.transpose(4, 5).contiguous()
                              .transpose(4, 5), xp)
    with pytest.raises(ValueError):
        stencil.stencil_accum(W.double(), xp)
    with pytest.raises(ValueError, match="expected W"):
        stencil.stencil_accum(W[:, :, :-1].contiguous(), xp)
    with pytest.raises(TypeError):
        stencil.stencil_accum(W.half(), xp.half())
    assert stencil.LAUNCHES.n == n0
    b, ap, d, pk, pkm1 = _cheb_vectors(64, torch.float32, cuda, 1)
    n0 = cheb.LAUNCHES.n
    with pytest.raises(ValueError, match="not contiguous"):
        cheb.cheb_step(b[::2], ap[::2], d[::2], pk[::2], pkm1[::2], 0.5, 1.1)
    with pytest.raises(ValueError):
        cheb.cheb_step(b, ap[:32], d, pk, pkm1, 0.5, 1.1)
    with pytest.raises(ValueError):
        cheb.cheb_first(b, None, d.double(), pk, 0.5)
    with pytest.raises(ValueError):
        cheb.cheb_first(b, None, d.cpu(), pk, 0.5)
    with pytest.raises(TypeError):
        h = b.half()
        cheb.cheb_first(h, None, h, h, 0.5)
    assert cheb.LAUNCHES.n == n0


@pytest.mark.gpu
def test_mg_kernels_capture_with_launches_counted(cuda):
    """A body of K4 and K6 calls captures into a CUDA graph under the
    sync debug mode "error"; each replay gives the eager bits and adds
    the captured launches to the counts (the warm-up run counts, the
    capture does not)."""
    from exsaddle_tpu_torch import abf as tabf
    from exsaddle_tpu_torch import graphs
    W, xp = _stencil_inputs(3, 3, (9, 10, 11), torch.float32, cuda, 5)
    x = xp[1:-1, 1:-1, 1:-1].contiguous()
    b, d = torch.rand_like(x), torch.rand_like(x)

    def body(v):
        av = tabf.stencil_apply(W, v)
        p = cheb.cheb_first(b, av, d, v, 0.5)
        return cheb.cheb_step(b, tabf.stencil_apply(W, p), d, p, v, 0.5,
                              1.3)

    want = body(x)
    k0 = _kernel_counts()
    g = graphs.Captured(body, x)
    k1 = _kernel_counts()
    assert (k1[2] - k0[2], k1[3] - k0[3]) == (2, 2)
    assert g.deltas[2:4] == (2, 2)
    for i in range(2):
        assert torch.equal(g(x), want)
        k = _kernel_counts()
        assert (k[2] - k1[2], k[3] - k1[3]) == (2 * (i + 1), 2 * (i + 1))



# --- K5, the MG transfers ------------------------------------------------

def _flagship_classes(m_el):
    from exsaddle_tpu_torch.matfree import _parity_classes
    return tuple(tuple(s) for s in
                 _parity_classes(tuple(2 * m + 1 for m in m_el))[1])


def _shard_classes(mloc):
    from exsaddle_tpu_torch.parallel.cart_abf import _local_cls_shapes
    return _local_cls_shapes(mloc, len(mloc))


# (m_el, class shapes) of the parity pair: the mx=32 flagship's fine <-> L-2
# level, a cart shard's local box of its 1x2x2 grid (32 x 16 x 16
# elements), small 2D and 3D meshes, and a ragged 3D mesh whose rows no
# block of rows divides
K5_PARITY = {"flagship": ((32, 32, 32), _flagship_classes((32, 32, 32))),
             "cart_shard": ((32, 16, 16), _shard_classes((32, 16, 16))),
             "2d": ((5, 4), _flagship_classes((5, 4))),
             "3d_odd": ((3, 4, 2), _flagship_classes((3, 4, 2))),
             "ragged": ((7, 5, 9), _flagship_classes((7, 5, 9)))}
# (coarse grid, dofs per node) of the grid pair: the flagship's L-3 <-> L-2
# and coarse <-> L-3, small grids of every (ndim, nd), and ragged grids
# whose rows no block of rows divides (fine 9 x 13 x 17, a 2D 13 x 399:
# rows of 1,197 values, longer than a block's threads)
K5_GRID = {"L-3_L-2": ((17, 17, 17), 3), "coarse_L-3": ((9, 9, 9), 3),
           "2d_nd2": ((4, 7), 2), "2d_nd3": ((5, 3), 3),
           "3d_nd2": ((3, 4, 5), 2), "ragged_nd3": ((5, 7, 9), 3),
           "ragged_nd2": ((5, 7, 9), 2), "ragged_2d_nd3": ((7, 200), 3),
           "ragged_2d_nd2": ((7, 200), 2)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(K5_PARITY))
def test_parity_transfer_kernels_bitwise_twins(cuda, case, dtype):
    """prolong_parity (and its add form), restrict_parity (and its
    residual and weighted residual forms) against their twins on the card,
    bit for bit, one launch each; the restrictions on inputs with signed
    zeros in b - y and the weights of the cart V-cycle (powers of 1/2)."""
    m_el, cls = K5_PARITY[case]
    nd = len(m_el)
    n = sum(int(np.prod(c)) for c in cls) * nd
    rng = np.random.default_rng(21)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)  # noqa
    xc = t(rng.standard_normal(tuple(m + 1 for m in reversed(m_el))
                               + (nd,)))
    x, b, y = (t(rng.standard_normal(n)) for _ in range(3))
    b[::7], y[::11], b[::11], y[::13], b[::13] = (
        y[::7], 0.0, 0.0, 0.0, -0.0)
    w = t(0.5 ** rng.integers(0, 4, n))
    _reset_kernel_counts()
    pairs = [(transfer.prolong_parity(xc, cls, m_el),
              transfer.prolong_parity_plain(xc, cls, m_el)),
             (transfer.prolong_parity(xc, cls, m_el, add=x),
              transfer.prolong_parity_plain(xc, cls, m_el) + x),
             (transfer.restrict_parity(b, cls, m_el),
              transfer.restrict_parity_plain(b, cls, m_el)),
             (transfer.restrict_parity_residual(b, y, cls, m_el),
              transfer.restrict_parity_plain(b - y, cls, m_el)),
             (transfer.restrict_parity_weighted_residual(b, y, w, cls,
                                                         m_el),
              transfer.restrict_parity_plain(w * (b - y), cls, m_el))]
    torch.cuda.synchronize()
    for i, (got, want) in enumerate(pairs):
        assert _same_bits(got, want), (case, i, float(
            (got - want).abs().max()))
    assert transfer.LAUNCHES.n == 5
    assert transfer.LAUNCHES.by == {**dict.fromkeys(transfer.FORMS, 0),
                                    "prolong_parity": 1,
                                    "prolong_parity_add": 1,
                                    "restrict_parity": 1,
                                    "restrict_parity_residual": 1,
                                    "restrict_parity_weighted_residual": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(K5_GRID))
def test_grid_transfer_kernels_bitwise_twins(cuda, case, dtype):
    """prolong_grid (and its add form), restrict_grid and
    restrict_grid_cheb_first against their twins on the card, bit for
    bit, one launch each; the fused form's p1 also against K6's cheb_first
    kernel on the twin's restriction. Signed zeros in the inputs (a block
    of -0 in the fine grid, so some restricted values are -0 and their
    first iterates +0)."""
    coarse, nd = K5_GRID[case]
    fine = tuple(2 * c - 1 for c in coarse)
    rng = np.random.default_rng(22)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)  # noqa
    xc = t(rng.standard_normal(coarse + (nd,)))
    xf, x = (t(rng.standard_normal(fine + (nd,))) for _ in range(2))
    xf[: (fine[0] + 1) // 2] = -0.0
    xf.view(-1)[::7] = 0.0
    xc.view(-1)[::3] = -0.0
    d = t(0.5 + rng.random(coarse + (nd,)))
    scale = 0.7312345678901234
    _reset_kernel_counts()
    b, p1 = transfer.restrict_grid_cheb_first(xf, coarse, d, scale)
    pairs = [(transfer.prolong_grid(xc, fine),
              transfer.prolong_grid_plain(xc, fine)),
             (transfer.prolong_grid(xc, fine, add=x),
              x + transfer.prolong_grid_plain(xc, fine)),
             (transfer.restrict_grid(xf, coarse),
              transfer.restrict_grid_plain(xf, coarse))]
    bw, pw = transfer.restrict_grid_cheb_first_plain(xf, coarse, d, scale)
    pairs += [(b, bw), (p1, pw), (p1, cheb.cheb_first(
        bw, None, d, torch.zeros_like(bw), scale))]
    torch.cuda.synchronize()
    for i, (got, want) in enumerate(pairs):
        assert _same_bits(got, want), (case, i, float(
            (got - want).abs().max()))
    assert transfer.LAUNCHES.n == 4 and cheb.LAUNCHES.n == 1
    assert transfer.LAUNCHES.by == {**dict.fromkeys(transfer.FORMS, 0),
                                    "prolong_grid": 1, "prolong_grid_add": 1,
                                    "restrict_grid": 1,
                                    "restrict_grid_cheb_first": 1}


@pytest.mark.gpu
def test_transfer_kernels_refuse_bad_input(cuda):
    """Non-contiguous inputs, mismatched shapes, dtypes or devices raise
    before a launch."""
    m_el, cls = K5_PARITY["3d_odd"]
    n = sum(int(np.prod(c)) for c in cls) * 3
    xc = torch.rand((3, 5, 4, 3), device=cuda)
    x = torch.rand(n, device=cuda)
    _reset_kernel_counts()
    with pytest.raises(ValueError, match="not contiguous"):
        transfer.prolong_parity(xc.transpose(0, 1).contiguous()
                                .transpose(0, 1), cls, m_el)
    with pytest.raises(ValueError, match="not contiguous"):
        transfer.restrict_parity(torch.rand(2 * n, device=cuda)[::2], cls,
                                 m_el)
    with pytest.raises(ValueError):
        transfer.prolong_parity(xc, cls, m_el, add=x.double())
    with pytest.raises(ValueError):
        transfer.restrict_parity_residual(x, x.cpu(), cls, m_el)
    with pytest.raises(ValueError, match="has shape"):
        transfer.restrict_parity(x[:-1].contiguous(), cls, m_el)
    with pytest.raises(TypeError):
        transfer.restrict_parity(x.half(), cls, m_el)
    wres = transfer.restrict_parity_weighted_residual
    with pytest.raises(ValueError, match="w has shape"):
        wres(x, x, x[:-1].contiguous(), cls, m_el)
    with pytest.raises(ValueError, match="w is torch.float64"):
        wres(x, x, x.double(), cls, m_el)
    with pytest.raises(ValueError, match="w is torch.float32 on cpu"):
        wres(x, x, x.cpu(), cls, m_el)
    with pytest.raises(ValueError, match="y and w are required"):
        wres(x, x, None, cls, m_el)
    g = torch.rand((5, 7, 9, 3), device=cuda)
    with pytest.raises(ValueError, match="has shape"):
        transfer.restrict_grid(g, (3, 4, 4))
    with pytest.raises(ValueError, match="2 n - 1"):
        transfer.prolong_grid(g, (10, 13, 17))
    with pytest.raises(ValueError, match="dofs per node"):
        transfer.restrict_grid(torch.rand((5, 7, 9, 4), device=cuda),
                               (3, 4, 5))
    dg = torch.rand((3, 4, 5, 3), device=cuda)
    with pytest.raises(ValueError, match="d has shape"):
        transfer.restrict_grid_cheb_first(g, (3, 4, 5), dg[:, :3], 1.0)
    with pytest.raises(ValueError, match="d is torch.float64"):
        transfer.restrict_grid_cheb_first(g, (3, 4, 5), dg.double(), 1.0)
    with pytest.raises(ValueError, match="d is not contiguous"):
        transfer.restrict_grid_cheb_first(
            g, (3, 4, 5), dg.transpose(0, 1).contiguous().transpose(0, 1),
            1.0)
    assert transfer.LAUNCHES.n == 0


@pytest.mark.gpu
def test_transfer_kernels_capture_with_launches_counted(cuda):
    """A V-cycle-shaped body of K5 calls captures into a CUDA graph under
    the sync debug mode "error"; each replay gives the eager bits and
    adds its captured launches to the counts."""
    from exsaddle_tpu_torch import graphs
    m_el = (4, 2, 4)                         # odd coarse node counts
    cls = _flagship_classes(m_el)
    rng = np.random.default_rng(23)
    n = sum(int(np.prod(c)) for c in cls) * 3
    y = torch.as_tensor(rng.standard_normal(n), device=cuda)
    coarse = tuple(m + 1 for m in reversed(m_el))

    def body(b):
        r = transfer.restrict_parity_residual(b, y, cls, m_el)
        c = transfer.restrict_grid(r, tuple((s + 1) // 2 for s in coarse))
        r = transfer.prolong_grid(c, coarse, add=r)
        return transfer.prolong_parity(r, cls, m_el, add=b)

    b = torch.as_tensor(rng.standard_normal(n), device=cuda)
    want = body(b)
    _reset_kernel_counts()
    g = graphs.Captured(body, b)
    assert transfer.LAUNCHES.n == 4          # the warm-up run's
    for i in range(2):
        assert torch.equal(g(b), want)
        assert transfer.LAUNCHES.n == 4 * (i + 2)
    assert transfer.LAUNCHES.by["restrict_parity_residual"] == 3


@pytest.mark.gpu
def test_fused_grid_restriction_captures_with_launches_counted(cuda):
    """The grid restriction with the next level's first Chebyshev step in
    its store, followed by the smoother's steps that read that iterate,
    captures into a CUDA graph; each replay gives the eager bits and adds
    one restrict_grid_cheb_first launch and no K6 cheb_first launch (the
    smoother given p1 launches none for its first step)."""
    from exsaddle_tpu_torch import graphs, treeops
    coarse = (9, 9, 9)
    rng = np.random.default_rng(24)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa
                                  device=cuda)
    xf = t(rng.standard_normal(tuple(2 * c - 1 for c in coarse) + (3,)))
    d = t(0.5 + rng.random(coarse + (3,)))
    emin, emax = np.float32(0.1), np.float32(1.9)

    def body(r):
        b, p1 = transfer.restrict_grid_cheb_first(
            r, coarse, d, float(treeops.cheb_scale(emin, emax)))
        return treeops.cheb_smooth(lambda v: 0.5 * v, None, emin, emax, 3, b,
                                   torch.zeros_like(b), x0_zero=True,
                                   diag=d, p1=p1)

    want = body(xf)
    _reset_kernel_counts()
    g = graphs.Captured(body, xf)
    assert (transfer.LAUNCHES.by["restrict_grid_cheb_first"],
            cheb.LAUNCHES.n) == (1, 2)          # the warm-up run's
    for i in range(2):
        assert torch.equal(g(xf), want)
        assert transfer.LAUNCHES.by["restrict_grid_cheb_first"] == i + 2
        assert transfer.LAUNCHES.n == i + 2
        assert cheb.LAUNCHES.n == 2 * (i + 2)   # the two steps only


# --- K3, the p-block's Mpscaled apply, and K5's fused parity restriction ----

# (m_el) of K3: 2D, a small and a ragged 3D mesh (tiles that do not divide
# the node grid on any axis), a cart shard's box and the mx=32 flagship
K3_CASES = {"2d": (5, 4), "2d_large": (64, 48), "small": (3, 4, 2),
            "ragged": (5, 7, 9), "cart_shard": (32, 16, 16),
            "mx32": (32, 32, 32)}
SCALE_K3, OMEGA_K3 = 0.7312345678901234, 1.6180339887498949


def _mp_inputs(m_el, dtype, device, seed):
    """(op, pscale, W, x, b, p_km1, d): Np of the Q1 shape with uniform
    entries, negative weights as the ABF setup makes them, W their
    stencil as the setup builds it (assembled in float64 from the
    working-precision Np and pscale, rounded once), b a view at an odd
    offset into a longer vector (as the p-block's right-hand side is a
    view into the saddle vector)."""
    from types import SimpleNamespace
    from exsaddle_tpu_torch import abf
    nd = len(m_el)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa
    nn = tuple(m + 1 for m in m_el)
    grid = tuple(reversed(nn))
    op = SimpleNamespace(m_el=m_el, nn_p=nn,
                         Np=t(rng.uniform(-0.2, 1.0, (3 ** nd, 2 ** nd))))
    ps = t(-rng.uniform(0.1, 2.0, (int(np.prod(m_el)), 3 ** nd)))
    W = t(abf.mp_stencil(abf.mp_csr(op.Np.double().cpu().numpy(),
                                    ps.double().cpu().numpy(), m_el), nn))
    x, q = (t(rng.standard_normal(grid)) for _ in range(2))
    n = int(np.prod(grid))
    b = t(rng.standard_normal(n + 3))[1:1 + n].view(grid)
    return op, ps, W, x, b, q, t(rng.uniform(0.5, 1.5, grid))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(K3_CASES))
def test_mp_kernel_within_tolerance_and_fused_forms_bitwise(cuda, case,
                                                           dtype):
    """K3's plain form against mp_apply_plain within TOL of the apply over
    absolute values (the stencil's coefficients are the element products
    summed and rounded at setup; the plain version multiplies in factored
    form), bitwise repeatable; the step form bit for bit its twin (the
    plain kernel, then K6's kernel) and MpOp's forms the entries (its
    cheb_first the plain kernel, then K6's); one launch per call, counted
    by form."""
    from types import SimpleNamespace
    op, ps, W, x, b, q, d = _mp_inputs(K3_CASES[case], dtype, cuda, 31)
    _reset_kernel_counts()
    y = mp.mp_apply(op, ps, W, x)
    step = mp.mp_cheb_step(op, ps, W, b, x, q, d, SCALE_K3, OMEGA_K3)
    fused = mp.MpOp(op, ps, W)
    again = (fused(x), fused.cheb_step(b, x, q, d, SCALE_K3, OMEGA_K3))
    assert mp.LAUNCHES.n == 4 and mp.LAUNCHES.by == {
        "mp_apply": 2, "mp_cheb_step": 2}
    assert cheb.LAUNCHES.n == 0
    twin = mp.TWINS["mp_cheb_step"](op, ps, W, b, x, q, d, SCALE_K3,
                                    OMEGA_K3)
    first = fused.cheb_first(b, x, d, SCALE_K3)
    pair = cheb.cheb_first(b, y, d, x, SCALE_K3)
    assert mp.LAUNCHES.by["mp_apply"] == 4 and cheb.LAUNCHES.n == 3
    plain = mp.mp_apply_plain(op, ps, x)
    mag = float(mp.mp_apply_plain(
        SimpleNamespace(m_el=op.m_el, nn_p=op.nn_p, Np=op.Np.abs()),
        ps.abs(), x.abs()).max())
    torch.cuda.synchronize()
    err = float((y - plain).abs().max())
    assert bool(torch.isfinite(y).all()) and err <= TOL[dtype] * mag, (
        case, err, mag)
    assert _same_bits(again[0], y) and _same_bits(first, pair)
    assert _same_bits(step, twin) and _same_bits(again[1], step)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(K3_CASES))
def test_mp_kernel_float32_is_the_product_sum_rounded_once(cuda, case):
    """K3 sums its float32 products in double and rounds once: its output
    is the float64 apply of its own float32 W and x rounded to float32,
    but for the rare value whose exact sum lies within the two double
    sums' errors of a rounding boundary (at most 0.1% of the values,
    there one ulp off)."""
    from exsaddle_tpu_torch.kernels import stencil
    op, ps, W, x, _, _, _ = _mp_inputs(K3_CASES[case], torch.float32, cuda,
                                       34)
    y = mp.mp_apply(op, ps, W, x)
    ref = stencil.stencil_apply_plain(
        W.double().movedim(0, -1)[..., None, None],
        x.double()[..., None])[..., 0].float()
    torch.cuda.synchronize()
    ulps = (y.view(torch.int32) - ref.view(torch.int32)).abs()
    assert int(ulps.max()) <= 1
    assert int((ulps > 0).sum()) <= max(1, y.numel() // 1000)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(K5_PARITY))
def test_fused_parity_restriction_bitwise_twin(cuda, case, dtype):
    """restrict_parity_residual_cheb_first against its twin on the card,
    bit for bit, one launch; its p1 also against K6's cheb_first kernel on
    the residual restriction kernel's b2 (the pair it replaces); signed
    zeros in b - y, so some restricted values are -0 and their first
    iterates +0."""
    m_el, cls = K5_PARITY[case]
    nd = len(m_el)
    n = sum(int(np.prod(c)) for c in cls) * nd
    cshape = tuple(m + 1 for m in reversed(m_el)) + (nd,)
    rng = np.random.default_rng(25)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)  # noqa
    b, y = (t(rng.standard_normal(n)) for _ in range(2))
    b[: n // 3] = -0.0
    y[: n // 3] = 0.0
    d = t(0.5 + rng.random(cshape))
    _reset_kernel_counts()
    b2, p1 = transfer.restrict_parity_residual_cheb_first(b, y, cls, m_el, d,
                                                          SCALE_K3)
    assert transfer.LAUNCHES.n == 1 and transfer.LAUNCHES.by[
        "restrict_parity_residual_cheb_first"] == 1
    bw, pw = transfer.restrict_parity_residual_cheb_first_plain(
        b, y, cls, m_el, d, SCALE_K3)
    r = transfer.restrict_parity_residual(b, y, cls, m_el)
    pair = cheb.cheb_first(r, None, d, torch.zeros_like(r), SCALE_K3)
    torch.cuda.synchronize()
    assert _same_bits(b2, bw) and _same_bits(p1, pw)
    assert _same_bits(b2, r) and _same_bits(p1, pair)


@pytest.mark.gpu
def test_mp_kernel_refuses_bad_input(cuda):
    """Non-contiguous inputs, mismatched shapes, dtypes or devices raise
    before a launch, for K3 and for the fused parity restriction."""
    op, ps, W, x, b, q, d = _mp_inputs((3, 4, 2), torch.float32, cuda, 32)
    _reset_kernel_counts()
    with pytest.raises(ValueError, match="pg is not contiguous"):
        mp.mp_apply(op, ps, W,
                    x.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="W has shape"):
        mp.mp_apply(op, ps, W[:-1], x)
    with pytest.raises(ValueError, match="W is torch.float64"):
        mp.mp_apply(op, ps, W.double(), x)
    with pytest.raises(ValueError, match="W is torch.float32 on cpu"):
        mp.mp_apply(op, ps, W.cpu(), x)
    with pytest.raises(ValueError, match="W is not contiguous"):
        mp.mp_apply(op, ps, W.movedim(0, -1).contiguous().movedim(-1, 0), x)
    with pytest.raises(ValueError, match="needs Mpscaled's stencil"):
        mp.mp_apply(op, ps, None, x)
    with pytest.raises(ValueError, match="d is torch.float32 on cpu"):
        mp.mp_cheb_step(op, ps, W, b, x, q, d.cpu(), SCALE_K3, OMEGA_K3)
    with pytest.raises(ValueError, match="p_km1 has shape"):
        mp.mp_cheb_step(op, ps, W, b, x, q[:-1], d, SCALE_K3, OMEGA_K3)
    with pytest.raises(TypeError, match="not supported"):
        mp.mp_apply(op, ps.half(), W.half(), x.half())
    m_el, cls = K5_PARITY["3d_odd"]
    n = sum(int(np.prod(c)) for c in cls) * 3
    v = torch.rand(n, device=cuda)
    dg = torch.rand((3, 5, 4, 3), device=cuda)
    fused = transfer.restrict_parity_residual_cheb_first
    with pytest.raises(ValueError, match="y and d are required"):
        fused(v, v, cls, m_el, None, 1.0)
    with pytest.raises(ValueError, match="d has shape"):
        fused(v, v, cls, m_el, dg[:, :4], 1.0)
    with pytest.raises(ValueError, match="d is torch.float64"):
        fused(v, v, cls, m_el, dg.double(), 1.0)
    assert mp.LAUNCHES.n == 0 and transfer.LAUNCHES.n == 0


@pytest.mark.gpu
def test_mp_kernel_captures_with_launches_counted(cuda):
    """The p-block's smoother over MpOp (a K6 first step, then fused K3
    steps) captures into a CUDA graph under the sync debug mode "error";
    each replay gives the eager bits and adds its captured launches,
    counted by form, through the graph counters."""
    from exsaddle_tpu_torch import graphs, treeops
    op, ps, W, _, b, _, d = _mp_inputs((9, 8, 7), torch.float32, cuda, 33)
    b = b.contiguous()
    emin, emax = np.float32(0.1), np.float32(1.9)
    its = 6
    body = lambda r: treeops.cheb_smooth(  # noqa: E731
        mp.MpOp(op, ps, W), None, emin, emax, its, r, torch.zeros_like(r),
        x0_zero=True, diag=d)
    want = body(b)
    _reset_kernel_counts()
    g = graphs.Captured(body, b)
    assert (mp.LAUNCHES.by["mp_cheb_step"], cheb.LAUNCHES.n) == (its - 1, 1)
    for i in range(2):
        assert torch.equal(g(b), want)
        assert mp.LAUNCHES.n == mp.LAUNCHES.by["mp_cheb_step"] == \
            (its - 1) * (i + 2)
        assert cheb.LAUNCHES.n == i + 2


# --- K7, the Gram-Schmidt kernels -------------------------------------------

# (window rows, S and s given (GCR) or V only (FGMRES), weighted (a sharded
# part's ownership weight), plus: L = live + plus)
K7_FORMS = {"gcr": (30, True, False, 0), "fgmres": (31, False, False, 1),
            "gcr_weighted": (30, True, True, 0),
            "fgmres_weighted": (31, False, True, 1)}


def _gs_inputs(n, rows, dtype, device, seed, with_s, weighted):
    """(V, S, v, s, w) from a numpy seed; S, s, w None where not asked."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa
    V, v = t(rng.standard_normal((rows, n))), t(rng.standard_normal(n))
    S = t(rng.standard_normal((rows, n))) if with_s else None
    s = t(rng.standard_normal(n)) if with_s else None
    w = t(rng.integers(0, 2, n)) if weighted else None
    return V, S, v, s, w


def _gs_run(fns, V, S, v, s, w, live, plus, ix, scratch):
    """The three steps by `fns` (the entries or their twins) on copies of
    the windows: h, the count, v' and s' (scaled for GCR), sumsq, alpha
    and the windows after."""
    V, S = V.clone(), None if S is None else S.clone()
    count = torch.zeros(1, dtype=torch.int64, device=V.device)
    h = fns[0](V, v, live, plus, scratch, w, count)
    vo, so, sq = fns[1](V, h, v, live, plus, scratch, S, s, w)
    alpha = fns[2](vo, sq, V, ix, S, so, in_place=S is not None)
    return [x for x in (h, count, vo, so, sq, alpha, V, S) if x is not None]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("form", list(K7_FORMS))
def test_gram_schmidt_kernels_bitwise_twins(cuda, form, dtype):
    """K7's dots, combine and normalize against their twins on the card,
    bit for bit, for L in {0, 1, 5, rows - 1, rows} (read from a device
    int32, FGMRES's it = L - 1 with plus 1, so L = 0 comes from -1), at 1,
    1,000 and 823,875 entries (the mx=32 fine level); the dots exactly +0
    past L; one launch each; the count gets L."""
    rows, with_s, weighted, plus = K7_FORMS[form]
    twins = (gs.dots_plain, gs.combine_plain, gs.normalize_plain)
    for n in (1, 1000, 823875):
        V, S, v, s, w = _gs_inputs(n, rows, dtype, cuda, n, with_s, weighted)
        scratch = gs.Scratch(n, rows, dtype, cuda)
        for L in (0, 1, 5, rows - 1, rows):
            live = torch.tensor([L - plus], dtype=torch.int32, device=cuda)
            ix = torch.tensor([min(L, rows - 1)], dtype=torch.int64,
                              device=cuda)
            n0 = gs.LAUNCHES.n
            got = _gs_run((gs.dots, gs.combine, gs.normalize), V, S, v, s,
                          w, live, plus, ix, scratch)
            assert gs.LAUNCHES.n == n0 + 3
            want = _gs_run(twins, V, S, v, s, w, live, plus, ix, scratch)
            torch.cuda.synchronize()
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert _same_bits(a, b), (n, L)
            assert int(got[1]) == L
            assert _same_bits(got[0][L:], torch.zeros_like(got[0][L:]))
            assert int(scratch.ticket) == 0


@pytest.mark.gpu
def test_gram_schmidt_kernels_refuse_bad_input(cuda):
    """A window of more than 64 rows, without its scratch or with a
    scratch of another dtype, a live count that is not one int32, a vector
    of another length, dtype or device, a non-contiguous vector, and S
    without s raise before a launch."""
    V, S, v, s, w = _gs_inputs(100, 30, torch.float32, cuda, 1, True, True)
    sc = gs.Scratch(100, 30, torch.float32, cuda)
    live = torch.tensor([3], dtype=torch.int32, device=cuda)
    n0 = gs.LAUNCHES.n
    with pytest.raises(ValueError, match="1 to 64 rows"):
        gs.dots(torch.zeros(65, 100, device=cuda), v, live, 0, sc)
    with pytest.raises(ValueError, match="needs a Scratch"):
        gs.dots(V, v, live, 0, None)
    with pytest.raises(TypeError, match="part is torch.float64"):
        gs.dots(V, v, live, 0, gs.Scratch(100, 30, torch.float64, cuda))
    with pytest.raises(TypeError, match="live is torch.int64"):
        gs.dots(V, v, live.long(), 0, sc)
    with pytest.raises(ValueError, match="t is"):
        gs.dots(V, v[:-1], live, 0, sc)
    with pytest.raises(TypeError, match="weight is torch.float64"):
        gs.dots(V, v, live, 0, sc, weight=w.double())
    with pytest.raises(ValueError, match="v on cpu"):
        gs.combine(V, v[:30], v.cpu(), live, 0, sc)
    with pytest.raises(ValueError, match="s is not contiguous"):
        gs.combine(V, v[:30], v, live, 0, sc, S,
                   torch.stack([s, s], 1)[:, 0])
    with pytest.raises(ValueError, match="S and s come together"):
        gs.combine(V, v[:30], v, live, 0, sc, S, None)
    assert gs.LAUNCHES.n == n0


@pytest.mark.gpu
def test_gram_schmidt_replays_bitwise(cuda):
    """A GCR Gram-Schmidt (its three launches, L = 7 of 30 rows read on
    the device, the new row written at L) captured as one CUDA graph under
    the sync debug mode "error": two replays give the eager bits, each
    counting its three launches; the ticket is 0 after each."""
    from exsaddle_tpu_torch import graphs
    n, rows = 823875, 30
    V, S, v, s, _ = _gs_inputs(n, rows, torch.float32, cuda, 7, True, False)
    sc = gs.Scratch(n, rows, torch.float32, cuda)
    live = torch.tensor([7], dtype=torch.int32, device=cuda)
    ix = torch.tensor([7], dtype=torch.int64, device=cuda)

    def body(x):
        h = gs.dots(V, x, live, 0, sc)
        vo, so, sq = gs.combine(V, h, x, live, 0, sc, S, s)
        alpha = gs.normalize(vo, sq, V, ix, S, so)
        return torch.cat([h, vo, so, alpha[None], V[7], S[7]])

    want = body(v)
    g = graphs.Captured(body, v)
    deltas = dict(zip(graphs._counter_names(), g.deltas))
    assert deltas["gram_schmidt.n"] == 3
    for i in range(2):
        n0 = gs.LAUNCHES.n
        got = g(v)
        assert _same_bits(got, want) and gs.LAUNCHES.n == n0 + 3
        assert int(sc.ticket) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["f64_direct", "f32_ir"])
def test_device_loop_gram_schmidt_through_kernels_on_cuda(cuda, case,
                                                          monkeypatch):
    """A device-loop solve (mx=8, 3 levels) runs its Gram-Schmidt through
    K7: three launches per GCR step and per FGMRES iteration by its kernel
    nodes and by the launch counts its graph added; gs_rows is the sum of
    the live counts L over those steps, which the host loop over the same
    setup (the device loop's bits, test_device_loop_graph_equals_plain_
    driver_on_cuda) takes one by one; kernel_nodes reads no gs_rows."""
    from exsaddle_tpu_torch import treeops
    from exsaddle_tpu_torch.abf import ABFSolver
    kw = GRAPH_CASES[case]
    ir = kw.get("ir", False)
    p = _device_problem()
    g = ABFSolver(p["mesh"], p["fes"], p["coeff"], p["bc_idx"], p["bc_vals"],
                  device=cuda, nlevels=3, **kw)
    host = ABFSolver.from_parts(g.cfg, g.data, g.setup, device=cuda,
                                dtype=kw["dtype"], ir=ir, loop="host")
    F = p["F_raw"] + g.setup["rhs_diri"]
    run = (lambda s: s.solve_ir(F, rtol=1e-8)) if ir else \
        (lambda s: s.solve(F))
    n0 = gs.LAUNCHES.n
    r = run(g)
    c = r["counts"]
    steps = c["gcr_steps"] + c["fgmres_its"]
    kn = g.kernel_nodes(c)
    assert steps > 0 and c["gs_rows"] > 0
    assert kn["launches"]["gram_schmidt.n"] == 3 * steps
    assert [kn["launches"][f"gram_schmidt.{f}"] for f in gs.FORMS] == \
        [steps] * 3
    assert gs.LAUNCHES.n - n0 == 3 * steps
    assert g.kernel_nodes(dict(c, gs_rows=0)) == kn
    rows = []
    orig = treeops.gram_schmidt_window

    def recorded(dots, scratch, V, v, live, plus, *a, **k):
        rows.append(min(max(int(treeops.first(live)) + plus, 0),
                        treeops.first(V).shape[0]))
        return orig(dots, scratch, V, v, live, plus, *a, **k)

    monkeypatch.setattr(treeops, "gram_schmidt_window", recorded)
    rh = run(host)
    assert np.array_equal(rh["x"], r["x"])
    assert len(rows) == steps and sum(rows) == c["gs_rows"]
