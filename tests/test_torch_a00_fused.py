"""K1's fused forms (kernels/a00.py: the Dirichlet keep in K1's loads, the
mask terms and the fine level's Chebyshev updates in its node gather's
store) and K6's masked forms (kernels/cheb.py) on the CPU, where each entry
runs its twin:

- every twin is the op sequence the port issued before the fusion (the
  plain apply of x * ks, then y * ks + ms * x, then K6's update), bit for
  bit, in 2D and 3D, float32 and float64;
- treeops.cheb_smooth over an A00Op equals the callable Jacobi path and
  the unfused diag path bit for bit, and the JAX package's cheb_smooth
  over its mult_u_tree to 1e-12 relative in float64;
- one single-device V-cycle goes through the fused entries and equals the
  JAX package's V-cycle to 1e-12 relative;
- GCR's operator, the fixed V-cycles and the cart path's fine smoother
  reach the fused entries (spies);
- the launch checks refuse what the kernels cannot take.

The kernels themselves run on the card (tests/test_torch_gpu.py). Inputs
are numpy draws from fixed seeds; JAX runs on the CPU in float64."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exsaddle_tpu import abf as jabf
from exsaddle_tpu import matfree as jmf
from exsaddle_tpu import treeops as jtreeops

from exsaddle_tpu_torch import abf as tabf
from exsaddle_tpu_torch import driver as tdriver
from exsaddle_tpu_torch import graphs, treeops
from exsaddle_tpu_torch import matfree as tmf
from exsaddle_tpu_torch import models as tmodels
from exsaddle_tpu_torch.assembly import FESpace
from exsaddle_tpu_torch.grid_ops import gather_u_parity, split_u_parity
from exsaddle_tpu_torch.kernels import a00, cheb
from exsaddle_tpu_torch.mesh import SaddleMesh
from exsaddle_tpu_torch.options import Options
from exsaddle_tpu_torch.parallel.cart import CartPartition
from exsaddle_tpu_torch.parallel.cart_abf import CartABFSolver, _cart_bodies

from test_torch_matfree import _pair
from test_torch_transfer import _jax_vcycle
from torch_parallel_common import problems

torch.set_num_threads(1)

# (nd, m_el, lame, model, size)
CASES = {"2d": (2, (4, 3), False, "0", None),
         "3d": (3, (3, 4, 3), False, "11", (0.1, 1.0, 1.0))}
DTYPES = [torch.float32, torch.float64]
FORMS = ("a00_apply_keep", "a00_masked", "a00_cheb_first", "a00_cheb_step",
         "cheb_first_masked", "cheb_step_masked")
SCALE, OMEGA = 0.37, 1.61


def _operator(case, dtype):
    nd, m_el, lame, model, size = case
    ctx = tmodels.ModelContext(Options.from_args(["-model", model]), nd,
                               lame=lame, log=lambda *a, **k: None)
    mesh = SaddleMesh(nd, m_el, size or (1.0,) * nd)
    fes = FESpace(mesh)
    bci, _ = tmodels.create_bc_list(ctx, mesh)
    coeff = tdriver.fine_coefficients(ctx, fes)
    bc_mask = np.zeros(mesh.ndof)
    bc_mask[:mesh.nu][bci] = 1.0
    return tmf.ParityMatFreeOperator.build(mesh, fes, coeff, bc_mask,
                                           lame=lame, dtype=dtype,
                                           device="cpu")


def _vectors(op, dtype, seed):
    """x, b, p_km1, y (standard normals), d (in [0.5, 1.5]) of op's nu."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype)  # noqa: E731
    x, b, q, y = (t(rng.standard_normal(op.nu)) for _ in range(4))
    return x, b, q, y, t(rng.uniform(0.5, 1.5, op.nu))


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _same(a, b):
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _entry(form, op, aux, x, b, q, y, d):
    ks, ms = aux[0], aux[1]
    return {"a00_apply_keep": lambda: a00.a00_apply(op, x, keep=ks),
            "a00_masked": lambda: a00.a00_masked(op, aux, x),
            "a00_cheb_first": lambda: a00.a00_cheb_first(op, aux, b, x, d,
                                                         SCALE),
            "a00_cheb_step": lambda: a00.a00_cheb_step(op, aux, b, x, q, d,
                                                       SCALE, OMEGA),
            "cheb_first_masked": lambda: cheb.cheb_first_masked(
                b, y, ks, ms, d, x, SCALE),
            "cheb_step_masked": lambda: cheb.cheb_step_masked(
                b, y, ks, ms, d, x, q, SCALE, OMEGA)}[form]()


def _before(form, op, aux, x, b, q, y, d):
    """What the port computed before the fusion: abf.mult_u_tree's
    xu * ks, the plain apply, y * ks + ms * xu (after the halo on the cart
    path: y is that raw output), then treeops.cheb_smooth's update with a
    Jacobi preconditioner, in its order."""
    ks, ms = aux[0], aux[1]
    if form == "a00_apply_keep":
        return a00.a00_apply_plain(op, x * ks)
    raw = y if form.startswith("cheb_") else a00.a00_apply_plain(op, x * ks)
    ax = raw * ks + ms * x
    if form == "a00_masked":
        return ax
    if form in ("a00_cheb_first", "cheb_first_masked"):
        return SCALE * (d * (b - ax)) + x
    t = SCALE * (d * (b - ax)) + x
    return OMEGA * (t - q) + q


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(CASES))
def test_twins_are_the_unfused_ops(case, dtype, form):
    """Each fused entry on CPU tensors (its twin) is the unfused op
    sequence bit for bit, Dirichlet rows (ks = 0: x * 0 keeps the sign of
    x) included; and TWINS names the functions the entries run."""
    op = _operator(CASES[case], dtype)
    aux = tmf.tree_aux(op)
    vecs = _vectors(op, dtype, 3 + len(case) + FORMS.index(form))
    got = _entry(form, op, aux, *vecs)
    assert _same(got, _before(form, op, aux, *vecs))
    x, b, q, y, d = vecs
    ks, ms = aux[0], aux[1]
    assert float(ks.min()) == 0.0 and float(ms.max()) == 1.0
    twin = {"a00_apply_keep": lambda: a00.TWINS["a00_apply"](op, x, ks),
            "a00_masked": lambda: a00.TWINS["a00_masked"](op, aux, x),
            "a00_cheb_first": lambda: a00.TWINS["a00_cheb_first"](
                op, aux, b, x, d, SCALE),
            "a00_cheb_step": lambda: a00.TWINS["a00_cheb_step"](
                op, aux, b, x, q, d, SCALE, OMEGA),
            "cheb_first_masked": lambda: cheb.TWINS["cheb_first_masked"](
                b, y, ks, ms, d, x, SCALE),
            "cheb_step_masked": lambda: cheb.TWINS["cheb_step_masked"](
                b, y, ks, ms, d, x, q, SCALE, OMEGA)}[form]()
    assert _same(twin, got)


@pytest.mark.parametrize("case", list(CASES))
def test_keep_none_is_the_plain_apply(case):
    """keep=None is the plain apply; the masked form of abf.mult_u_tree is
    a00_masked; the CPU launches nothing."""
    op = _operator(CASES[case], torch.float64)
    aux = tmf.tree_aux(op)
    x = _vectors(op, torch.float64, 1)[0]
    n0 = (a00.LAUNCHES.n, dict(a00.LAUNCHES.by))
    assert _same(a00.a00_apply(op, x), a00.a00_apply_plain(op, x))
    assert _same(tabf.mult_u_tree(op, aux, x), a00.a00_masked(op, aux, x))
    assert _same(a00.A00Op(op, aux)(x), a00.a00_masked(op, aux, x))
    assert (a00.LAUNCHES.n, a00.LAUNCHES.by) == n0


def _smoother(dtype, x0_zero):
    op = _operator(CASES["3d"], dtype)
    aux = tmf.tree_aux(op)
    x0, b, _, _, d = _vectors(op, dtype, 7)
    if x0_zero:
        x0 = torch.zeros_like(x0)
    npdt = treeops.NP_DTYPE[dtype]
    return op, aux, x0, b, d, npdt(0.2), npdt(2.2)


@pytest.mark.parametrize("x0_zero", [False, True])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_cheb_smooth_over_a00_op_is_the_callable_path(dtype, x0_zero):
    """cheb_smooth(A00Op, diag=d) takes the fused forms and gives the bits
    of the callable Jacobi path and of the unfused diag path."""
    op, aux, x0, b, d, emin, emax = _smoother(dtype, x0_zero)
    got = treeops.cheb_smooth(a00.A00Op(op, aux), None, emin, emax, 6, b,
                              x0, x0_zero=x0_zero, diag=d)
    A = lambda v: tabf.mult_u_tree(op, aux, v)  # noqa: E731
    assert _same(got, treeops.cheb_smooth(A, lambda r: d * r, emin, emax, 6,
                                          b, x0, x0_zero=x0_zero))
    assert _same(got, treeops.cheb_smooth(A, None, emin, emax, 6, b, x0,
                                          x0_zero=x0_zero, diag=d))


@pytest.mark.parametrize("x0_zero", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_cheb_smooth_over_a00_op_matches_jax(case, x0_zero):
    """The fine-level smoother over A00Op against the JAX package's
    cheb_smooth over its mult_u_tree with a Jacobi PC, float64."""
    mesh, _, _, jop, top = _pair(CASES[case])
    taux, jaux = tmf.tree_aux(top), jmf.tree_aux(jop)
    rng = np.random.default_rng(9)
    b = rng.standard_normal(mesh.nu)
    x0 = np.zeros(mesh.nu) if x0_zero else rng.standard_normal(mesh.nu)
    d = rng.uniform(0.5, 1.5, mesh.nu)
    emin, emax = np.float64(0.2), np.float64(2.2)
    got = treeops.cheb_smooth(a00.A00Op(top, taux), None, emin, emax, 6,
                              torch.as_tensor(b), torch.as_tensor(x0),
                              x0_zero=x0_zero, diag=torch.as_tensor(d))
    ds = jop._split_u(jnp.asarray(d))
    want = jtreeops.cheb_smooth(
        lambda s: jabf.mult_u_tree(jop, jaux, s),
        lambda t: [a * c for a, c in zip(ds, t)], emin, emax, 6,
        jop._split_u(jnp.asarray(b)), jop._split_u(jnp.asarray(x0)),
        x0_zero=x0_zero)
    want = np.concatenate([np.asarray(s).reshape(-1) for s in want])
    assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()


def _spy(monkeypatch, entries):
    """Counts of each (module, name) entry's calls as the solvers make them
    (each still runs; a call made inside another spied entry, as a CPU
    twin's call of K6's entry, is not the solver's and is not counted);
    a00_apply's split by keep given or not."""
    calls, depth = {}, [0]

    def counted(name, fn):
        def wrapped(*a, **k):
            key = name
            if name == "a00_apply":
                key += "_keep" if k.get("keep") is not None else ""
            if depth[0] == 0:
                calls[key] = calls.get(key, 0) + 1
            depth[0] += 1
            try:
                return fn(*a, **k)
            finally:
                depth[0] -= 1
        return wrapped

    for mod, name in entries:
        monkeypatch.setattr(mod, name, counted(name, getattr(mod, name)))
    return calls


A00_ENTRIES = [(a00, n) for n in ("a00_apply", "a00_masked",
                                  "a00_cheb_first", "a00_cheb_step")]
K6_ENTRIES = [(cheb, n) for n in cheb.FORMS]


def test_vcycle_goes_through_the_fused_entries_and_matches_jax(monkeypatch):
    """One V-cycle of the port's ABFSolver (3 levels, mx=4 pseudoice, the
    JAX build's numbers) against the JAX package's V-cycle, float64, within
    1e-12 of max |y|; its fine level takes every apply through K1's fused
    forms: the residual before the restriction is a00_masked, the
    post-smooth's first step a00_cheb_first, every other step
    a00_cheb_step; K6 runs only the fine level's zero-guess first step
    (L-2's is in the store of K5's fused restriction)."""
    j, t = problems(3, (4, 4, 4), ["-model", "11", "-size_x", "0.1"],
                    size=(0.1, 1.0, 1.0))
    jslv = jabf.ABFSolver(*j[1:], nlevels=3)
    cfg, data, setup = tabf.data_from_numpy(
        dataclasses.asdict(jslv.cfg), jax.device_get(jslv.data),
        jax.device_get(jslv.setup), "cpu", torch.float64)
    tslv = tabf.ABFSolver.from_parts(cfg, data, setup, device="cpu",
                                     dtype=torch.float64)
    calls = _spy(monkeypatch, A00_ENTRIES + K6_ENTRIES)
    r = np.random.default_rng(8).standard_normal(data["op"].nu)
    got = tslv.bodies()["mg_pc"](torch.as_tensor(r)).numpy()
    pre = cfg.cheb_pre_its or cfg.cheb_its
    assert calls == {"a00_masked": 1, "a00_cheb_first": 1,
                     "a00_cheb_step": pre + cfg.cheb_its - 2,
                     "cheb_first": 1}
    jop = jslv.data["op"]
    want = _jax_vcycle(jslv)(jop._split_u(jnp.asarray(r)))
    want = np.concatenate([np.asarray(s).reshape(-1) for s in want])
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.fixture(scope="module")
def solver():
    _, t = problems(3, (4, 4, 4), ["-model", "11", "-size_x", "0.1"],
                    size=(0.1, 1.0, 1.0))
    return t


def test_gcr_operator_is_the_fused_fine_operator(solver, monkeypatch):
    """The device loop's GCR (and the host loop's, the same bodies) applies
    the A00Op: per GCR step its operator and the V-cycle's residual are
    a00_masked, nothing calls the unfused apply, and every fine smoothing
    step after a zero guess is fused."""
    slv = tabf.ABFSolver(*solver[1:], device="cpu", nlevels=3, loop="plain")
    dev = slv._dev
    assert isinstance(dev.gcr.mult, a00.A00Op)
    assert isinstance(tabf._plain_bodies(slv.cfg, slv.data)["fineA"],
                      a00.A00Op)
    calls = _spy(monkeypatch, A00_ENTRIES)
    rng = np.random.default_rng(2)
    F = rng.standard_normal(slv.data["op"].ndof)
    r = slv.solve(F)
    assert r["reason"] == "CONVERGED_RTOL"
    steps = int(dev.ctl.counts[dev.gcr.c0 + 1])
    cfg = slv.cfg
    pre = cfg.cheb_pre_its or cfg.cheb_its
    assert steps > 0
    assert calls == {"a00_masked": 2 * steps, "a00_cheb_first": steps,
                     "a00_cheb_step": steps * (pre + cfg.cheb_its - 2)}


def test_fixed_vcycles_take_the_mask_form(solver, monkeypatch):
    """The fieldsplit PC with 3 fixed V-cycles: each V-cycle's residual
    and each correction's ru - A x are a00_masked."""
    slv = tabf.ABFSolver(*solver[1:], device="cpu", nlevels=3,
                         u_fixed_vcycles=3)
    calls = _spy(monkeypatch, A00_ENTRIES)
    t = torch.as_tensor(np.random.default_rng(6).standard_normal(
        slv.data["op"].ndof))
    tabf._plain_bodies(slv.cfg, slv.data)["fixed_pc"](t)
    assert calls["a00_masked"] == 3 + 2
    assert "a00_apply" not in calls and "a00_apply_keep" not in calls


def test_cart_fine_smoother_takes_the_keep_and_masked_forms(monkeypatch):
    """A cart V-cycle over 1x2x2 shards with 4 levels: on every shard each
    fine apply is K1 with the keep in its loads; the fine smoothers'
    updates after a zero guess are K6's masked forms on the haloed raw
    output; the weighted residual keeps its torch mask ops; K6's plain
    forms run only the zero-guess first steps (fine and L-2 per shard)."""
    _, t = problems(3, (8, 8, 8), ["-model", "2"])
    slv = CartABFSolver(CartPartition(t[1], (1, 2, 2)), t[0], *t[4:],
                        ["cpu"] * 4, nlevels=4, loop="plain")
    cfg = slv.dcfg.base
    rng = np.random.default_rng(5)
    r = slv.blocks.fine_mult(slv.ddata["inv_diag_fine"].map(
        lambda v: torch.as_tensor(rng.standard_normal(tuple(v.shape)),
                                  dtype=v.dtype)))
    calls = _spy(monkeypatch, A00_ENTRIES + K6_ENTRIES)
    _cart_bodies(slv.dcfg, slv.smesh, slv.ddata, slv.blocks)["mg_pc"](r)
    pre = cfg.cheb_pre_its or cfg.cheb_its
    shards = 4
    assert calls == {"a00_apply_keep": shards * (pre + cfg.cheb_its),
                     "cheb_first_masked": shards,
                     "cheb_step_masked": shards * (pre + cfg.cheb_its - 2),
                     "cheb_first": 2 * shards}


def test_check_refuses_what_the_kernel_cannot_take():
    """K1's launch checks (run on CPU tensors) on the fused forms' vectors
    and K6's on the masked forms'; any device but CUDA and the CPU is
    refused by every entry."""
    op = _operator(CASES["3d"], torch.float64)
    aux = tmf.tree_aux(op)
    x, b, q, y, d = _vectors(op, torch.float64, 4)
    a00._check(op, x, keep=aux[0], ks=aux[0], ms=aux[1], b=b, d=d, p_km1=q)
    with pytest.raises(ValueError, match="keep has shape"):
        a00._check(op, x, keep=aux[0][:-1])
    with pytest.raises(ValueError, match="own keep vector"):
        a00._check(op, x, keep=aux[0].clone())
    with pytest.raises(ValueError, match="p_km1 is torch.float32"):
        a00._check(op, x, p_km1=q.float())
    with pytest.raises(ValueError, match="d is not contiguous"):
        a00._check(op, x, d=torch.stack([d, d], 1)[:, 0])
    with pytest.raises(ValueError, match="b has shape"):
        a00._check(op, x, b=b[:, None])
    meta = x.to("meta")
    for call in (lambda: a00.a00_apply(op, meta, keep=meta),
                 lambda: a00.a00_masked(op, aux, meta),
                 lambda: a00.a00_cheb_first(op, aux, b, meta, d, SCALE),
                 lambda: a00.a00_cheb_step(op, aux, b, meta, q, d, SCALE,
                                           OMEGA),
                 lambda: cheb.cheb_first_masked(meta, y, aux[0], aux[1], d,
                                                x, SCALE),
                 lambda: cheb.cheb_step_masked(meta, y, aux[0], aux[1], d, x,
                                               q, SCALE, OMEGA)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    cheb._check("cheb_step_masked", b, {"y": y, "ks": aux[0], "ms": aux[1]})
    with pytest.raises(ValueError, match="ks is"):
        cheb._check("cheb_step_masked", b, {"ks": aux[0][:-1]})
    with pytest.raises(ValueError, match="ms is not contiguous"):
        cheb._check("cheb_step_masked", b,
                    {"ms": torch.stack([aux[1], aux[1]], 1)[:, 0]})


@pytest.mark.parametrize("case", list(CASES))
def test_keep_bit_table_is_the_gathered_keep(case):
    """K1's keep bit table: bit c of element e is the keep of the x entry
    the element gather puts in column c; a keep that is not 0 or 1 is
    refused."""
    op = _operator(CASES[case], torch.float64)
    nd = len(op.m_el)
    cols = gather_u_parity(split_u_parity(torch.arange(op.nu), op.cls_shapes,
                                          nd), op.m_el)
    words = op.keep_bits.numpy().view(np.uint32)
    ncol = cols.shape[1]
    assert words.shape == (cols.shape[0], -(-ncol // 32))
    bits = (words[:, np.arange(ncol) // 32] >> (np.arange(ncol) % 32)) & 1
    assert np.array_equal(bits, op.keep[:op.nu][cols].numpy())
    bad = dataclasses.replace(op, keep=op.keep * 0.5)
    with pytest.raises(ValueError, match="other than 0.0 and 1.0"):
        a00.keep_bit_table(bad)


def test_launch_counts_by_form_round_trip_the_graph_counters():
    """The per-form counts of K1 and K6 are among the counters a capture
    takes back out and a replay adds again."""
    before = graphs._counters()
    a00.LAUNCHES.by["a00_cheb_step"] += 3
    cheb.LAUNCHES.by["cheb_step_masked"] += 2
    moved = graphs._counters()
    assert sum(m - b for m, b in zip(moved, before)) == 5
    graphs._set_counters(before)
    assert graphs._counters() == before
