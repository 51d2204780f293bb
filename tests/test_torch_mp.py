"""K3, the p-block's Mpscaled apply (kernels/mp.py: its plain form, and the
Chebyshev updates in its store), and K5's fused parity restriction with
L-2's first Chebyshev step (kernels/transfer.py:
restrict_parity_residual_cheb_first), on the CPU, where each entry runs its
plain version or twin:

- the port's mp_apply (abf.mp_apply, mp.mp_apply, mp.mp_apply_plain)
  against the JAX package's exsaddle_tpu.abf.mp_apply, float64, to 1e-12
  relative (the two sum the element products in other orders);
- the kernel's operand, Mpscaled's node stencil (abf.mp_stencil: the
  setup's, build_abf's and data_from_numpy's, and each cart shard's partial
  one), applied through K4's plain twin at one dof per node, against the
  JAX package's mp_apply (1e-12 relative) and, summed over the shards by
  halo_p, the whole mesh's apply (1e-13);
- every twin is the op sequence the port issued before the fusion (K3's
  plain apply, then K6; the restriction, then K6's zero-guess first step),
  bit for bit, in 2D and 3D, float32 and float64;
- treeops.cheb_smooth over an MpOp equals the callable Jacobi path and the
  unfused diag path bit for bit, and the JAX package's p-block
  (cheb_smooth over its mp_apply with a Jacobi PC) to 1e-12 relative;
- one V-cycle through the fused restriction equals the JAX package's
  V-cycle to 1e-12 relative;
- spies: the single-device p-block reaches MpOp's fused step, the cart
  p-block K3's plain form, then the halo, then K6, and the fine level the
  fused restriction;
- the launch checks refuse what the kernels cannot take, and the counts
  round-trip the graph counters.

The kernels themselves run on the card (tests/test_torch_gpu.py). Inputs
are numpy draws from fixed seeds; JAX runs on the CPU in float64."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exsaddle_tpu import abf as jabf
from exsaddle_tpu import treeops as jtreeops

from exsaddle_tpu_torch import abf as tabf
from exsaddle_tpu_torch import graphs, treeops
from exsaddle_tpu_torch.kernels import a00, cheb, mp, transfer
from exsaddle_tpu_torch.parallel.cart import CartPartition
from exsaddle_tpu_torch.parallel.cart_abf import CartABFSolver, _cart_bodies

from test_torch_matfree import _pair
from test_torch_transfer import _jax_vcycle
from torch_parallel_common import problems

torch.set_num_threads(1)

# (nd, m_el, lame, model, size): a 2D and two 3D cases (one Lame)
CASES = {"2d": (2, (5, 4), False, "0", None),
         "3d": (3, (3, 4, 2), False, "11", (0.1, 1.0, 1.0)),
         "3d_lame": (3, (3, 3, 3), True, "6", None)}
DTYPES = [torch.float32, torch.float64]
SCALE, OMEGA = 0.37, 1.61
# float64 applies and smoothers: the packages sum in different orders
TOL64 = 1e-12


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _same(a, b):
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _pscale(mesh, fes, coeff, lame):
    """The p-block's weights as abf.build_abf computes them."""
    inv = (1.0 / coeff["lambda"] + 1.0 / coeff["mu"]) if lame \
        else 1.0 / coeff["eta"]
    return -(fes.wq[None, :] * fes.detJ_p) * inv


def _setup(case, dtype=torch.float64):
    """(JAX op, port op in dtype, pscale numpy, grid shape, K3's stencil W
    in dtype: assembled in float64 from the float64 operator, rounded
    once)."""
    mesh, fes, coeff, jop, top = _pair(CASES[case], tdtype=dtype)
    ps = _pscale(mesh, fes, coeff, CASES[case][2])
    W = tabf.mp_stencil(tabf.mp_csr(np.asarray(jop.Np), ps, mesh.m_el),
                        mesh.nn_p)
    return jop, top, ps, tuple(reversed(mesh.nn_p)), \
        torch.as_tensor(W, dtype=dtype)


def _stencil_apply(W, pg):
    """W's plain apply: K4's plain twin at one dof per node (W slot-major,
    K4's W node-major)."""
    from exsaddle_tpu_torch.kernels import stencil
    return stencil.stencil_apply_plain(W.movedim(0, -1)[..., None, None],
                                       pg[..., None])[..., 0]


def _vectors(grid, dtype, seed):
    """x, b, p_km1 (standard normals) and d (in [0.5, 1.5]) on the grid."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype)  # noqa: E731
    x, b, q = (t(rng.standard_normal(grid)) for _ in range(3))
    return x, b, q, t(rng.uniform(0.5, 1.5, grid))


@pytest.mark.parametrize("case", list(CASES))
def test_mp_apply_matches_jax(case):
    """abf.mp_apply, K3's entry and its plain version against the JAX
    package's mp_apply, float64, to 1e-12 relative; the plain version is
    the entry on the CPU bit for bit (W unread there), and the CPU
    launches nothing; the stencil W (mp_csr, then mp_stencil) applied
    through K4's plain twin also matches JAX's apply to 1e-12."""
    jop, top, ps, grid, W = _setup(case)
    pg = np.random.default_rng(5).standard_normal(grid)
    want = np.asarray(jabf.mp_apply(jop, jnp.asarray(ps), jnp.asarray(pg)))
    tps, tpg = torch.as_tensor(ps), torch.as_tensor(pg)
    n0 = (mp.LAUNCHES.n, dict(mp.LAUNCHES.by))
    got = mp.mp_apply(top, tps, W, tpg)
    assert _rel(got.numpy(), want) < TOL64
    assert _same(tabf.mp_apply(top, tps, tpg, W=W), got)
    assert _same(tabf.mp_apply(top, tps, tpg), got)
    assert _same(mp.mp_apply_plain(top, tps, tpg), got)
    assert _same(mp.MpOp(top, tps, W)(tpg), got)
    assert (mp.LAUNCHES.n, mp.LAUNCHES.by) == n0
    assert W.shape == (3 ** len(grid),) + grid and W.is_contiguous()
    assert _rel(_stencil_apply(W, tpg).numpy(), want) < TOL64


def _before(form, op, ps, x, b, q, d):
    """What the port computed before the fusion: the plain apply, then
    treeops.cheb_smooth's update with a Jacobi preconditioner, in its
    order."""
    ax = mp.mp_apply_plain(op, ps, x)
    t = SCALE * (d * (b - ax)) + x
    return t if form == "cheb_first" else OMEGA * (t - q) + q


@pytest.mark.parametrize("form", ["cheb_first", "mp_cheb_step"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case", ["2d", "3d"])
def test_twins_are_the_unfused_ops(case, dtype, form):
    """The fused K3 entry on CPU tensors (its twin) is K3's plain apply
    followed by K6's update, bit for bit; TWINS names the function the
    entry runs; MpOp's cheb_step is the entry, and its cheb_first (no
    fused form) the plain apply followed by K6's first iterate."""
    _, op, ps, grid, W = _setup(case, dtype)
    ps = torch.as_tensor(ps, dtype=dtype)
    x, b, q, d = _vectors(grid, dtype, 4 + len(case) if form == "cheb_first"
                          else 5 + len(case))
    if form == "cheb_first":
        got = twin = via = mp.MpOp(op, ps, W).cheb_first(b, x, d, SCALE)
    else:
        got = mp.mp_cheb_step(op, ps, W, b, x, q, d, SCALE, OMEGA)
        twin = mp.TWINS[form](op, ps, W, b, x, q, d, SCALE, OMEGA)
        via = mp.MpOp(op, ps, W).cheb_step(b, x, q, d, SCALE, OMEGA)
    assert _same(got, _before(form, op, ps, x, b, q, d))
    assert _same(twin, got) and _same(via, got)


# (ndim, m_el, argv, size) of a whole setup: 2D, small 3D, ragged 3D
SETUPS = {"2d": (2, (6, 5), ["-model", "0"], None),
          "3d": (3, (4, 4, 4), ["-model", "11", "-size_x", "0.1"],
                 (0.1, 1.0, 1.0)),
          "3d_ragged": (3, (4, 6, 2), ["-model", "2"], None)}


@pytest.mark.parametrize("case", list(SETUPS))
def test_setup_stencil_matches_jax_mp_apply(case):
    """build_abf's stencil W_p (float64, slot-major (3^nd, *rev(nn_p)))
    applied through K4's plain twin at one dof per node against the JAX
    package's mp_apply on the setup's pscale and its op, to 1e-12
    relative; data_from_numpy's W_p, built from the JAX build's pscale,
    agrees with it to 1e-13; a float32 setup's W_p is the float64 one
    rounded once."""
    nd, m_el, argv, size = SETUPS[case]
    j, t = problems(nd, m_el, argv, size=size)
    slv = tabf.ABFSolver(*t[1:], device="cpu", nlevels=3)
    data = slv.data
    W, ps = data["mp_stencil"], data["pscale"]
    grid = tuple(reversed(slv.setup["mesh"].nn_p))
    assert W.shape == (3 ** nd,) + grid and W.dtype == torch.float64
    assert W.is_contiguous()
    pg = np.random.default_rng(21).standard_normal(grid)
    jslv = jabf.ABFSolver(*j[1:], nlevels=3)
    want = np.asarray(jabf.mp_apply(jslv.data["op"], jnp.asarray(ps.numpy()),
                                    jnp.asarray(pg)))
    assert _rel(_stencil_apply(W, torch.as_tensor(pg)).numpy(), want) < TOL64
    _, ndata, _ = tabf.data_from_numpy(
        dataclasses.asdict(jslv.cfg), jax.device_get(jslv.data),
        jax.device_get(jslv.setup), "cpu", torch.float64)
    assert _rel(ndata["mp_stencil"].numpy(), W.numpy()) < 1e-13
    _, d32, _ = tabf.build_abf(*t[1:], device="cpu", dtype=torch.float32,
                               nlevels=3)
    assert _same(d32["mp_stencil"], W.float())


def test_cart_shard_stencils_sum_to_the_whole_mesh_apply():
    """Each cart shard's stencil (CartBlocks.mp_w, from its own elements
    over its local node box) applied through K4's plain twin to its box of
    a global pressure grid, then summed over the interface planes by
    halo_p, equals the whole mesh's apply (the setup's stencil, and
    mp_apply_plain) on each box, to 1e-13 relative, float64, over 1x2x2
    shards."""
    from exsaddle_tpu_torch.parallel.cart import stack_boxes
    _, t = problems(3, (8, 8, 8), ["-model", "2"])
    part = CartPartition(t[1], (1, 2, 2))
    slv = CartABFSolver(part, t[0], *t[4:], ["cpu"] * 4, nlevels=4,
                        loop="plain")
    blk = slv.blocks
    nn_p = tuple(part.mesh.nn_p)
    grid = tuple(reversed(nn_p))
    pg = np.random.default_rng(22).standard_normal(grid)
    whole = tabf.ABFSolver(*t[1:], device="cpu", nlevels=3)
    want = _stencil_apply(whole.data["mp_stencil"], torch.as_tensor(pg))
    plain = mp.mp_apply_plain(whole.data["op"], whole.data["pscale"],
                              torch.as_tensor(pg))
    assert _rel(want.numpy(), plain.numpy()) < 1e-13
    boxes = stack_boxes(part.dev_shape)
    parts = slv.smesh.shard([pg[part._grid_slices(b, 1, ())] for b in boxes])
    for w, o in zip(blk.mp_w.parts, blk.ops.parts):
        assert w.shape == (27,) + tuple(reversed(o.nn_p))
        assert w.dtype == torch.float64 and w.is_contiguous()
    got = blk.halo_p(treeops.smap(
        lambda w, v: _stencil_apply(w, torch.as_tensor(v)), blk.mp_w, parts))
    for b, y in zip(boxes, got.parts):
        assert _rel(y.numpy(), want.numpy()[part._grid_slices(b, 1, ())]) \
            < 1e-13
    # the cart path's own apply: the plain version per shard, the halo
    via = tabf.mp_apply(blk.ops, slv.ddata["pscale"], parts,
                        halo_p=blk.halo_p, W=blk.mp_w)
    for b, y in zip(boxes, via.parts):
        assert _rel(y.numpy(), want.numpy()[part._grid_slices(b, 1, ())]) \
            < 1e-13


def _parity(m_el, dtype, seed):
    """(cls_shapes, b, y, d) of a parity restriction on m_el."""
    nd = len(m_el)
    cls = tuple(tuple(m_el[nd - 1 - k] + 1 - ((p >> (nd - 1 - k)) & 1)
                      for k in range(nd)) for p in range(2 ** nd))
    cshape, n, _ = transfer.parity_layout(cls, m_el, nd)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype)  # noqa: E731
    return (cls, t(rng.standard_normal(n)), t(rng.standard_normal(n)),
            t(rng.uniform(0.5, 1.5, cshape + (nd,))))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("m_el", [(4, 3), (3, 4, 2)], ids=["2d", "3d"])
def test_fused_parity_restriction_twin_is_the_unfused_ops(m_el, dtype):
    """restrict_parity_residual_cheb_first on CPU tensors (its twin) is
    restrict_parity of b - y followed by K6's zero-guess first step
    scale (d b2) + 0, bit for bit; TWINS names it; the CPU launches
    nothing."""
    cls, b, y, d = _parity(m_el, dtype, 7)
    n0 = transfer.LAUNCHES.by["restrict_parity_residual_cheb_first"]
    b2, p1 = transfer.restrict_parity_residual_cheb_first(b, y, cls, m_el,
                                                          d, SCALE)
    want = transfer.restrict_parity_plain(b - y, cls, m_el)
    assert _same(b2, want)
    assert _same(p1, SCALE * (d * want) + torch.zeros_like(want))
    assert _same(p1, cheb.cheb_first(want, None, d, torch.zeros_like(want),
                                     SCALE))
    twin = transfer.TWINS["restrict_parity_residual_cheb_first"](
        b, y, cls, m_el, d, SCALE)
    assert all(_same(a, c) for a, c in zip(twin, (b2, p1)))
    assert transfer.LAUNCHES.by["restrict_parity_residual_cheb_first"] == n0


def test_fused_parity_restriction_matches_jax():
    """The fused restriction's b2 against the JAX package's restrict_parity
    of b - y and its p1 against scale (d b2), float64, to 1e-12."""
    m_el = (3, 4, 2)
    cls, b, y, d = _parity(m_el, torch.float64, 8)
    b2, p1 = transfer.restrict_parity_residual_cheb_first(b, y, cls, m_el,
                                                          d, SCALE)
    r = (b - y).numpy()
    subs, off = [], 0
    for c in cls:
        n = int(np.prod(c)) * 3
        subs.append(jnp.asarray(r[off:off + n].reshape(tuple(c) + (3,))))
        off += n
    jb = np.asarray(jabf.restrict_parity(subs, cls, m_el))
    assert _rel(b2.numpy(), jb) < TOL64
    assert _rel(p1.numpy(), SCALE * (d.numpy() * jb)) < TOL64


def _p_smoother(dtype, x0_zero):
    _, op, ps, grid, W = _setup("3d", dtype)
    x0, b, _, d = _vectors(grid, dtype, 11)
    if x0_zero:
        x0 = torch.zeros_like(x0)
    npdt = treeops.NP_DTYPE[dtype]
    return op, torch.as_tensor(ps, dtype=dtype), W, x0, b, d, npdt(0.2), \
        npdt(2.2)


@pytest.mark.parametrize("x0_zero", [False, True])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_cheb_smooth_over_mp_op_is_the_callable_path(dtype, x0_zero):
    """cheb_smooth(MpOp, diag=d) takes the fused forms and gives the bits
    of the callable Jacobi path and of the unfused diag path over
    abf.mp_apply."""
    op, ps, W, x0, b, d, emin, emax = _p_smoother(dtype, x0_zero)
    got = treeops.cheb_smooth(mp.MpOp(op, ps, W), None, emin, emax, 6, b,
                              x0, x0_zero=x0_zero, diag=d)
    A = lambda v: tabf.mp_apply(op, ps, v, W=W)  # noqa: E731
    assert _same(got, treeops.cheb_smooth(A, lambda r: d * r, emin, emax, 6,
                                          b, x0, x0_zero=x0_zero))
    assert _same(got, treeops.cheb_smooth(A, None, emin, emax, 6, b, x0,
                                          x0_zero=x0_zero, diag=d))


@pytest.mark.parametrize("x0_zero", [False, True])
@pytest.mark.parametrize("case", ["2d", "3d"])
def test_cheb_smooth_over_mp_op_matches_jax(case, x0_zero):
    """The p-block's smoother over MpOp against the JAX package's p-block,
    cheb_smooth over its mp_apply with a Jacobi PC (exsaddle_tpu/abf.py's
    p_mult and p_pc), float64, to 1e-12 relative."""
    jop, top, ps, grid, W = _setup(case)
    rng = np.random.default_rng(9)
    b = rng.standard_normal(grid)
    x0 = np.zeros(grid) if x0_zero else rng.standard_normal(grid)
    d = rng.uniform(0.5, 1.5, grid)
    emin, emax = np.float64(0.2), np.float64(2.2)
    got = treeops.cheb_smooth(mp.MpOp(top, torch.as_tensor(ps), W), None,
                              emin, emax, 12, torch.as_tensor(b),
                              torch.as_tensor(x0), x0_zero=x0_zero,
                              diag=torch.as_tensor(d))
    jps, jd = jnp.asarray(ps), jnp.asarray(d)
    want = jtreeops.cheb_smooth(lambda pg: jabf.mp_apply(jop, jps, pg),
                                lambda pg: jd * pg, emin, emax, 12,
                                jnp.asarray(b), jnp.asarray(x0),
                                x0_zero=x0_zero)
    assert _rel(got.numpy(), np.asarray(want)) < TOL64


def _spy(monkeypatch, entries, order=None):
    """Counts of each (module or object, name) entry's calls as the solvers
    make them (each still runs; a call made inside another spied entry, as
    a CPU twin's call of K6's entry, is not the solver's and is not
    counted); with order, the names of the counted calls in turn."""
    calls, depth = {}, [0]

    def counted(name, fn):
        def wrapped(*a, **k):
            if depth[0] == 0:
                calls[name] = calls.get(name, 0) + 1
                if order is not None:
                    order.append(name)
            depth[0] += 1
            try:
                return fn(*a, **k)
            finally:
                depth[0] -= 1
        return wrapped

    for obj, name in entries:
        monkeypatch.setattr(obj, name, counted(name, getattr(obj, name)))
    return calls


K3_ENTRIES = [(mp, n) for n in mp.FORMS]
K6_ENTRIES = [(cheb, n) for n in cheb.FORMS]
A00_ENTRIES = [(a00, n) for n in ("a00_masked", "a00_cheb_first",
                                  "a00_cheb_step")]
K5_PARITY = [(transfer, n) for n in ("restrict_parity_residual",
                                     "restrict_parity_residual_cheb_first",
                                     "restrict_parity_weighted_residual")]


@pytest.fixture(scope="module")
def pseudoice():
    """The mx=4 pseudoice problem of the port (3 MG levels: L-2 is the one
    smoothed stencil level)."""
    _, t = problems(3, (4, 4, 4), ["-model", "11", "-size_x", "0.1"],
                    size=(0.1, 1.0, 1.0))
    return t


def test_p_solve_goes_through_mp_op(pseudoice, monkeypatch):
    """The single-device p-block (ABFSolver's p_solve body): its zero-guess
    first step is K6's cheb_first (it applies nothing), every later step
    one mp_cheb_step (K3 with K6's update in its store); nothing calls
    K3's plain form or K6's step."""
    slv = tabf.ABFSolver(*pseudoice[1:], device="cpu", nlevels=3)
    calls = _spy(monkeypatch, K3_ENTRIES + K6_ENTRIES)
    bp = torch.as_tensor(np.random.default_rng(3).standard_normal(
        slv.data["op"].p_shape))
    slv.bodies()["p_solve"](bp)
    assert calls == {"cheb_first": 1,
                     "mp_cheb_step": slv.cfg.p_cheb_its - 1}


def test_vcycle_goes_through_the_fused_restriction_and_matches_jax(
        monkeypatch):
    """One V-cycle of the port's ABFSolver (3 levels, mx=4 pseudoice, the
    JAX build's numbers): the fine residual is restricted by the fused
    restrict_parity_residual_cheb_first once, whose p1 is L-2's first
    pre-smoothing step (K6 runs only the fine level's zero-guess first
    step, K1's fused forms every other fine update); the result equals
    the JAX package's V-cycle to 1e-12 of max |y|, float64."""
    j, _ = problems(3, (4, 4, 4), ["-model", "11", "-size_x", "0.1"],
                    size=(0.1, 1.0, 1.0))
    jslv = jabf.ABFSolver(*j[1:], nlevels=3)
    cfg, data, setup = tabf.data_from_numpy(
        dataclasses.asdict(jslv.cfg), jax.device_get(jslv.data),
        jax.device_get(jslv.setup), "cpu", torch.float64)
    tslv = tabf.ABFSolver.from_parts(cfg, data, setup, device="cpu",
                                     dtype=torch.float64)
    calls = _spy(monkeypatch, K5_PARITY + K6_ENTRIES + A00_ENTRIES)
    r = np.random.default_rng(8).standard_normal(data["op"].nu)
    got = tslv.bodies()["mg_pc"](torch.as_tensor(r)).numpy()
    pre = cfg.cheb_pre_its or cfg.cheb_its
    assert calls == {"restrict_parity_residual_cheb_first": 1,
                     "cheb_first": 1, "a00_masked": 1, "a00_cheb_first": 1,
                     "a00_cheb_step": pre + cfg.cheb_its - 2}
    jop = jslv.data["op"]
    want = _jax_vcycle(jslv)(jop._split_u(jnp.asarray(r)))
    want = np.concatenate([np.asarray(s).reshape(-1) for s in want])
    assert _rel(got, want) < TOL64


def test_two_level_vcycle_keeps_the_plain_restriction(monkeypatch):
    """With 2 levels L-2 is the coarse solve, which is not smoothed: the
    fine residual goes through the unfused restrict_parity_residual."""
    _, t = problems(3, (2, 2, 2), ["-model", "11", "-size_x", "0.1"],
                    size=(0.1, 1.0, 1.0))
    slv = tabf.ABFSolver(*t[1:], device="cpu", nlevels=2)
    calls = _spy(monkeypatch, K5_PARITY)
    slv.bodies()["mg_pc"](torch.as_tensor(
        np.random.default_rng(2).standard_normal(slv.data["op"].nu)))
    assert calls == {"restrict_parity_residual": 1}


def test_cart_p_block_is_k3_then_the_halo_then_k6(monkeypatch):
    """A cart p-block over 1x2x2 shards: every step applies K3's plain form
    on each shard, then sums the interface planes (halo_p), then updates
    with K6 on each shard; no fused K3 form runs there, and the cart
    V-cycle's restriction stays the weighted residual form (L-2's first
    step is K6, after the halo)."""
    _, t = problems(3, (8, 8, 8), ["-model", "2"])
    slv = CartABFSolver(CartPartition(t[1], (1, 2, 2)), t[0], *t[4:],
                        ["cpu"] * 4, nlevels=4, loop="plain")
    cfg = slv.dcfg.base
    rng = np.random.default_rng(6)
    bp = slv.ddata["inv_diag_p"].map(
        lambda v: torch.as_tensor(rng.standard_normal(tuple(v.shape)),
                                  dtype=v.dtype))
    order = []
    calls = _spy(monkeypatch, K3_ENTRIES + K6_ENTRIES
                 + [(slv.blocks, "halo_p")], order)
    _cart_bodies(slv.dcfg, slv.smesh, slv.ddata, slv.blocks)["p_solve"](bp)
    shards, steps = 4, cfg.p_cheb_its - 1
    assert calls == {"cheb_first": shards, "mp_apply": shards * steps,
                     "halo_p": steps, "cheb_step": shards * steps}
    step = ["mp_apply"] * shards + ["halo_p"] + ["cheb_step"] * shards
    assert order == ["cheb_first"] * shards + step * steps
    calls = _spy(monkeypatch, K5_PARITY)
    r = slv.blocks.fine_mult(slv.ddata["inv_diag_fine"].map(
        lambda v: torch.as_tensor(rng.standard_normal(tuple(v.shape)),
                                  dtype=v.dtype)))
    _cart_bodies(slv.dcfg, slv.smesh, slv.ddata, slv.blocks)["mg_pc"](r)
    assert calls == {"restrict_parity_weighted_residual": shards}


def test_check_refuses_what_the_kernel_cannot_take():
    """K3's launch checks (run on CPU tensors): shape, dtype, device and
    layout of pg, pscale, Np and the fused forms' grids; any device but
    CUDA and the CPU is refused by every entry; the fused restriction
    checks its diagonal and needs y and d."""
    _, op, ps, grid, W = _setup("3d")
    ps = torch.as_tensor(ps)
    x, b, q, d = _vectors(grid, torch.float64, 4)
    mp._check("mp_cheb_step", op, W, x, b=b, d=d, p_km1=q)
    with pytest.raises(ValueError, match="pg has shape"):
        mp._check("mp_apply", op, W, x.reshape(-1))
    with pytest.raises(ValueError, match="p_km1 is torch.float32"):
        mp._check("mp_cheb_step", op, W, x, p_km1=q.float())
    with pytest.raises(ValueError, match="d is not contiguous"):
        mp._check("mp_cheb_step", op, W, x,
                  d=torch.stack([d, d], -1)[..., 0])
    with pytest.raises(ValueError, match="b has shape"):
        mp._check("mp_cheb_step", op, W, x, b=b[:, :, :-1])
    with pytest.raises(TypeError, match="not supported"):
        mp._check("mp_apply", op, W.half(), x.half())
    # the stencil: shape, dtype, device, layout, and that it is there
    with pytest.raises(ValueError, match="W has shape"):
        mp._check("mp_apply", op, W[:-1], x)
    with pytest.raises(ValueError, match="W has shape"):
        mp._check("mp_apply", op, W.movedim(0, -1).contiguous(), x)
    with pytest.raises(ValueError, match="W is torch.float32"):
        mp._check("mp_apply", op, W.float(), x)
    with pytest.raises(ValueError, match="W is torch.float64 on meta"):
        mp._check("mp_apply", op, W.to("meta"), x)
    with pytest.raises(ValueError, match="W is not contiguous"):
        mp._check("mp_apply", op, W.movedim(0, -1).contiguous().movedim(
            -1, 0), x)
    with pytest.raises(ValueError, match="needs Mpscaled's stencil"):
        mp._check("mp_apply", op, None, x)
    meta = x.to("meta")
    for call in (lambda: mp.mp_apply(op, ps, W, meta),
                 lambda: mp.MpOp(op, ps, W).cheb_first(b, meta, d, SCALE),
                 lambda: mp.mp_cheb_step(op, ps, W, b, meta, q, d, SCALE,
                                         OMEGA),
                 lambda: mp.MpOp(op, ps, W)(meta)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    m_el = (3, 4, 2)
    cls, b, y, d = _parity(m_el, torch.float64, 5)
    name = "restrict_parity_residual_cheb_first"
    with pytest.raises(ValueError, match="unsupported device"):
        transfer.restrict_parity_residual_cheb_first(
            b.to("meta"), y, cls, m_el, d, SCALE)
    cshape, n, _ = transfer.parity_layout(cls, m_el, 3)
    transfer._check(name, b, (n,), y=((n,), y), d=(cshape + (3,), d))
    with pytest.raises(ValueError, match="d has shape"):
        transfer._check(name, b, (n,), y=((n,), y),
                        d=(cshape + (3,), d[:-1]))
    with pytest.raises(ValueError, match="d is torch.float32"):
        transfer._check(name, b, (n,), y=((n,), y),
                        d=(cshape + (3,), d.float()))


def test_launch_counts_by_form_round_trip_the_graph_counters():
    """K3's launches, its per-form counts and the fused restriction's are
    among the counters a capture takes back out and a replay adds
    again."""
    before = graphs._counters()
    mp.LAUNCHES.n += 4
    mp.LAUNCHES.by["mp_cheb_step"] += 3
    mp.LAUNCHES.by["mp_apply"] += 1
    transfer.LAUNCHES.by["restrict_parity_residual_cheb_first"] += 2
    moved = graphs._counters()
    assert sum(m - b for m, b in zip(moved, before)) == 10
    graphs._set_counters(before)
    assert graphs._counters() == before
    # K3's counts sit just before the tracked counters: n, then by form
    k = len(before) - len(graphs._TRACKED)
    assert before[k - 1 - len(mp.FORMS):k] == (mp.LAUNCHES.n,) + tuple(
        mp.LAUNCHES.by[f] for f in mp.FORMS)
