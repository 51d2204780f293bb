"""The port's sharded ABF solve with its Krylov loops on the device
(abf.DeviceLoopSolver over parallel/cart_abf.py _cart_bodies, CartABFSolver
loop=) on the CPU,
where the plain driver (graphs.run_plain) runs the steps that the card runs
as one CUDA graph:

- CartABFSolver(loop="plain") against the JAX CartABFSolver on the three
  cases of tests/test_torch_cart_abf.py: the same iteration count and
  reason, the monitor history and x to 1e-10;
- treeops.DeviceGCR / DeviceFGMRES over ShardVecs with ownership-weighted,
  psum-reduced dots bit for bit the host loops (make_gcr / make_fgmres
  window=True) on the same ShardVecs, and the plain cart solve bit for bit
  the host loop (make_cart_abf_solver, the window arithmetic), with a
  correctly rounded sqrt as on the card;
- the plain driver's per-solve halo exchanges, K6 calls and fused K4
  calls (every Chebyshev smoother of the cart path takes its inverse
  diagonal; the L-2 level's updates and residual are K4's epilogues),
  each call on operands the kernel accepts;
- the loop option's defaults and refusals.

Every input is made from a numpy seed; each test states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exsaddle_tpu.parallel.cart import CartPartition as JCartPartition
from exsaddle_tpu.parallel.cart_abf import CartABFSolver as JCartABFSolver

from exsaddle_tpu_torch import graphs, treeops
from exsaddle_tpu_torch.kernels import cheb, stencil
from exsaddle_tpu_torch.parallel.cart import CartPartition
from exsaddle_tpu_torch.parallel.cart_abf import (CartABFSolver,
                                                  build_cart_abf)
from exsaddle_tpu_torch.parallel.shard_mesh import ShardMesh
from exsaddle_tpu_torch.treeops import ShardVec

from test_torch_cart_abf import CASES
from test_torch_krylov_device import _ieee_sqrt
from torch_parallel_common import assert_same_solve, problems, rhs


def _build(case):
    """The port's setup of a case, its right-hand side, and a solver over
    it for a loop kind."""
    nd, m_el, dev_shape, args, lame, size = CASES[case]
    j, t = problems(nd, m_el, args, lame=lame, size=size)
    part = CartPartition(t[1], dev_shape)
    dcfg, ddata, setup = build_cart_abf(part, t[0], *t[4:], lame=lame,
                                        nlevels=3)
    ndev = int(np.prod(dev_shape))

    def solver(loop):
        return CartABFSolver.from_parts(part, dcfg, ddata, setup,
                                        ["cpu"] * ndev, loop=loop)
    return j, solver, rhs(t, setup["rhs_diri"])


@pytest.fixture(scope="module")
def sinker():
    """The sinker over a 1x2x2 grid: its solver factory and F."""
    _, solver, F = _build("sinker_122")
    return solver, F


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_loop_matches_jax(case):
    """loop="plain" (the device loop's items from Python, the control
    kernels' twins) against the JAX CartABFSolver: its and reason equal,
    history and x to 1e-10."""
    nd, m_el, dev_shape, args, lame, size = CASES[case]
    j, solver, F = _build(case)
    ndev = int(np.prod(dev_shape))
    jslv = JCartABFSolver(JCartPartition(j[1], dev_shape), j[0], *j[4:],
                          jax.devices()[:ndev], lame=lame,
                          dtype=jnp.float64, nlevels=3)
    slv = solver("plain")
    assert slv.loop == "plain" and slv._dev.graph is None
    r = slv.solve(F)
    assert r["loop"] == "plain"
    assert_same_solve(r, jslv.solve(F), tol=1e-10)


def test_plain_loop_equals_host_loop(sinker, monkeypatch):
    """The plain cart solve against the host loop (make_cart_abf_solver,
    the window arithmetic) over one setup: its, reason, history and x bit
    for bit, the same halo exchanges. torch.sqrt is made correctly
    rounded, as CUDA's is: the host loop's Givens roots are numpy's, the
    control twins' torch's."""
    monkeypatch.setattr(torch, "sqrt", _ieee_sqrt)
    solver, F = sinker
    rp, rh = solver("plain").solve(F), solver("host").solve(F)
    assert (rp["its"], rp["reason"]) == (rh["its"], rh["reason"])
    assert rp["history"] == rh["history"]
    assert np.array_equal(rp["x"], rh["x"])
    assert rp["halo_exchanges"] == rh["halo_exchanges"] > 0


def test_plain_loop_counts(sinker, monkeypatch):
    """One plain solve's halo exchanges, K6 calls and fused K4 calls
    against what its loop counters say ran: per GCR step a V-cycle over
    the fine and L-2 levels on every shard (pre_its + cheb_its Chebyshev
    updates on each: on the fine level K6, its masked form after the
    zero-guess first update; on L-2 K4's fused updates and residual, only
    the zero-guess first update K6) and its fine apply, per Arnoldi step a
    saddle apply, the p-block (p_cheb_its updates) and an A01 apply, per
    cycle start a saddle apply. Each K6 call gets operands of b's shape,
    dtype and device, contiguous, and each fused K4 call operands that
    K4's launch checks accept, as the kernels require. The host loop makes
    the same halo exchanges."""
    solver, F = sinker
    calls = []
    # the vector operands of each K6 form, after b (the rest are scalars)
    nvecs = {"cheb_first": 3, "cheb_step": 4, "cheb_first_masked": 5,
             "cheb_step_masked": 6}

    def checked(fn):
        def f(b, *rest):
            for t in rest[:nvecs[fn.__name__]]:
                if t is not None:
                    assert t.shape == b.shape and t.dtype == b.dtype
                    assert t.is_contiguous() and t.device == b.device
            calls.append(fn.__name__)
            return fn(b, *rest)
        return f

    def checked_k4(name, vecs):
        fn = getattr(stencil, name)

        def f(W, x, *rest, padded=False):
            stencil._check(W, x, padded, **dict(zip(vecs, rest)))
            calls.append(name)
            return fn(W, x, *rest, padded=padded)
        return f

    for name in cheb.FORMS:
        monkeypatch.setattr(cheb, name, checked(getattr(cheb, name)))
    for name, vecs in (("stencil_residual", ("b",)),
                       ("stencil_cheb_first", ("b", "d")),
                       ("stencil_cheb_step", ("b", "d", "p_km1"))):
        monkeypatch.setattr(stencil, name, checked_k4(name, vecs))
    slv = solver("plain")
    r = slv.solve(F)
    dev, cfg = slv._dev, slv.dcfg.base
    counts = dev.ctl.counts.numpy()
    steps = int(counts[dev.gcr.c0 + 1])
    arnoldi = int(counts[dev.fg.c0 + 2])
    starts = int(counts[dev.fg.c0 + 1])
    assert arnoldi == r["its"] > 0 and steps >= arnoldi and starts == 1
    pre = cfg.cheb_pre_its if cfg.cheb_pre_its > 0 else cfg.cheb_its
    nshards = len(slv.smesh.devices)
    # a first update per smoother: four per V-cycle (the L-2 post-smooth's
    # fused into K4, the fine post-smooth's the masked form), one per
    # p-block
    assert calls.count("cheb_first") == nshards * (2 * steps + arnoldi)
    assert calls.count("cheb_first_masked") == nshards * steps
    assert calls.count("cheb_step") == nshards * arnoldi * (
        cfg.p_cheb_its - 1)
    assert calls.count("cheb_step_masked") == nshards * steps * (
        pre + cfg.cheb_its - 2)
    assert calls.count("stencil_cheb_first") == nshards * steps
    assert calls.count("stencil_cheb_step") == nshards * steps * (
        pre + cfg.cheb_its - 2)
    assert calls.count("stencil_residual") == nshards * steps
    assert len(calls) == nshards * (steps * (2 * (pre + cfg.cheb_its) + 1)
                                    + arnoldi * cfg.p_cheb_its)
    # halos: mg_pc's fine applies (pre_its - 1 from a zero guess, the
    # residual, cheb_its) and the restricted residual's, GCR's apply; the
    # saddle apply (u and p), the p-block's Mp applies (p_cheb_its - 1),
    # the A01 apply
    want = (steps * (pre + cfg.cheb_its + 2)
            + arnoldi * (2 + cfg.p_cheb_its) + starts * 2)
    assert r["halo_exchanges"] == want
    assert solver("host").solve(F)["halo_exchanges"] == want


# --- the sharded device loops against the window host loops ----------------

N, SHARDS, LO, LEN = 24, 3, (0, 8, 15), 9


def _layout():
    """Three shards of 9 entries of a 24-vector, [0, 9), [8, 17),
    [15, 24): entries 8, 15 and 16 are held twice and weigh 0 on the
    upper shard. A seeded nonsymmetric dense system applies to the
    assembled vector and scatters back; a diagonal right PC. Returns
    (mult, pc, dots, b, join, (A, P))."""
    mesh = ShardMesh((SHARDS,), ["cpu"] * SHARDS)
    w = [np.ones(LEN) for _ in LO]
    w[1][0] = w[2][0] = w[2][1] = 0.0
    weight = mesh.shard(w)

    def split(x):
        x = np.asarray(x)
        return mesh.shard([x[lo:lo + LEN] for lo in LO])

    def join(xs):
        out = torch.zeros(N, dtype=torch.float64)
        for lo, wi, p in zip(LO, weight.parts, xs.parts):
            out[lo:lo + LEN] += wi * p
        return out

    rng = np.random.default_rng(3)
    A = torch.as_tensor(3.0 * np.eye(N) + rng.standard_normal((N, N))
                        / np.sqrt(N))
    P = torch.as_tensor(1.0 / (2.5 + rng.random(N)))
    Ps = split(P)

    def mult(xs):
        return split(A @ join(xs))

    def pc(xs):
        return Ps * xs
    dots = treeops.make_dots(weight=weight, psum=mesh.psum)
    return mult, pc, dots, split(rng.standard_normal(N)), join, (A, P)


def _same(a, b):
    return all(torch.equal(p, q) for p, q in zip(a.parts, b.parts))


def test_sharded_device_gcr_equals_window_host_loop(monkeypatch):
    """DeviceGCR over ShardVecs (dots=, restart 5 < its) against make_gcr
    window=True with the same dots on the same ShardVecs: x, its and rnorm
    bit for bit; the sharded x is the unsharded GCR's to 1e-12."""
    monkeypatch.setattr(torch, "sqrt", _ieee_sqrt)
    mult, pc, dots, b, join, (A, P) = _layout()
    kw = dict(restart=5, rtol=1e-10, atol=1e-50, max_it=100)
    xh, itsh, rnh = treeops.make_gcr(mult, pc, dots=dots, window=True,
                                     **kw)(b)
    ctl = graphs.Control("cpu")
    gcr = treeops.DeviceGCR(ctl, mult, pc, LEN, torch.float64,
                            ["cpu"] * SHARDS, dots=dots, **kw)
    x, its, rn = gcr.solve(b)
    assert int(its) == itsh > 5
    assert rn.numpy() == rnh
    assert _same(x, xh)
    x1, its1, _ = treeops.make_gcr(lambda v: A @ v, lambda v: P * v,
                                   window=True, **kw)(join(b))
    assert int(its1) == itsh
    assert float(torch.linalg.norm(join(x) - x1)) <= \
        1e-12 * float(torch.linalg.norm(x1))


@pytest.mark.parametrize("max_it", [200, 9], ids=["rtol", "max_it"])
def test_sharded_device_fgmres_equals_window_host_loop(max_it, monkeypatch):
    """DeviceFGMRES over ShardVecs (dots=, restart 6 < its, a nonzero x0)
    against make_fgmres window=True with the same dots on the same
    ShardVecs: x, its, rnorm, state and history bit for bit; against the
    unsharded FGMRES, its and state equal, x to 1e-12."""
    monkeypatch.setattr(torch, "sqrt", _ieee_sqrt)
    mult, pc, dots, F, join, (A, P) = _layout()
    x0 = ShardVec(0.01 * p for p in F.parts)
    kw = dict(restart=6, rtol=1e-10, atol=1e-50, dtol=1e4, max_it=max_it,
              hist_len=64)
    xh, itsh, rnh, sth, hh = treeops.make_fgmres(
        mult, pc, dots=dots, window=True, **kw)(F, x0)
    ctl = graphs.Control("cpu")
    fg = treeops.DeviceFGMRES(
        ctl, mult,
        lambda vin, zout: [graphs.Piece(lambda: zout.copy_(pc(vin)), "pc")],
        LEN, torch.float64, ["cpu"] * SHARDS, dots=dots, **kw)
    x, its, rn, st, h = fg.solve(F, x0)
    want = (treeops.CONVERGED_RTOL if max_it == 200
            else treeops.DIVERGED_ITS)
    assert int(st) == sth == want
    assert int(its) == itsh > 6
    assert rn.numpy() == rnh
    assert np.array_equal(h.numpy(), hh)
    assert _same(x, xh)
    x1, its1, _, st1, _ = treeops.make_fgmres(
        lambda v: A @ v, lambda v: P * v, window=True, **kw)(join(F),
                                                              join(x0))
    assert (int(its1), int(st1)) == (itsh, sth)
    assert float(torch.linalg.norm(join(x) - x1)) <= \
        1e-12 * float(torch.linalg.norm(x1))


# --- the loop option ----------------------------------------------------------

def test_loop_option_defaults_and_refusals(sinker):
    """loop defaults to "host" on the CPU; "device" raises there (a mesh
    that cannot be captured), an unknown loop raises; ShardMesh.capturable
    holds for one process with every shard on one CUDA device only (the
    meshes are built without touching a device)."""
    solver, _ = sinker
    assert solver(None).loop == "host"
    assert solver(None)._dev is None
    with pytest.raises(ValueError, match="one"):
        solver("device")
    with pytest.raises(ValueError, match="'device', 'plain' or 'host'"):
        solver("graph")
    cuda0, cuda1 = torch.device("cuda", 0), torch.device("cuda", 1)
    assert ShardMesh((1, 2, 2), [cuda0] * 4).capturable
    assert not ShardMesh((1, 2, 2), ["cpu"] * 4).capturable
    assert not ShardMesh((1, 2, 2), [cuda0, cuda1] * 2).capturable
    # two processes of two shards each (this process holds shards 0 and 1)
    assert not ShardMesh((1, 2, 2), [cuda0] * 2, shards=(0, 1)).capturable
