"""K4's fused entries (kernels/stencil.py: the zero-boundary apply, the
residual b - A x and the Chebyshev updates computed in the stencil's store)
on the CPU, where each entry runs its plain twin:

- every twin is the op sequence the solvers issued before the fusion
  (F.pad, stencil_accum_plain, then the subtraction or the recurrence's
  update), bit for bit, in both forms (zero-boundary x, padded xp);
- the zero-boundary form equals the padded form with zero ghosts, bit for
  bit;
- treeops.cheb_smooth over a StencilOp equals the callable Jacobi path
  and the unfused diag path bit for bit, and the JAX package's
  cheb_smooth over its stencil_apply to 1e-12 relative in float64;
- the launch checks refuse what the kernel cannot take;
- the single-device V-cycle, the cart path's L-2 shards and its
  replicated stencil levels go through the fused entries.

The kernel itself runs on the card (tests/test_torch_gpu.py). Inputs are
numpy draws from fixed seeds; JAX runs on the CPU in float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exsaddle_tpu import abf as jabf
from exsaddle_tpu import treeops as jtreeops

from exsaddle_tpu_torch import abf as tabf
from exsaddle_tpu_torch import treeops
from exsaddle_tpu_torch.kernels import cheb, stencil
from exsaddle_tpu_torch.parallel.cart import CartPartition
from exsaddle_tpu_torch.parallel.cart_abf import CartABFSolver, _cart_bodies

from torch_parallel_common import problems

torch.set_num_threads(1)

GRIDS = {2: (5, 7), 3: (3, 4, 5)}
DTYPES = [torch.float32, torch.float64]
EPILOGUES = ("none",) + stencil.EPILOGUES
SCALE, OMEGA = 0.37, 1.61


def _case(ndim, nd, dtype, seed, ghosts=False):
    """W, x (*grid, nd), xp (zero ghosts unless ghosts) and b, d, p_km1."""
    grid = GRIDS[ndim]
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype)  # noqa: E731
    W = t(rng.standard_normal(grid + (3 ** ndim, nd, nd)))
    xp = torch.nn.functional.pad(t(rng.standard_normal(grid + (nd,))),
                                 (0, 0) + (1, 1) * ndim)
    if ghosts:
        xp = t(rng.standard_normal(tuple(xp.shape)))
    x = xp[tuple(slice(1, -1) for _ in grid)].contiguous()
    b, d, q = (t(rng.standard_normal(grid + (nd,))) for _ in range(3))
    return W, x, xp, b, d, q


def _entry(epi, W, x, b, d, q, padded):
    """The fused entry of epilogue epi on x (xp when padded)."""
    if epi == "none":
        return (stencil.stencil_accum(W, x) if padded
                else stencil.stencil_apply(W, x))
    if epi == "residual":
        return stencil.stencil_residual(W, x, b, padded=padded)
    if epi == "cheb_first":
        return stencil.stencil_cheb_first(W, x, b, d, SCALE, padded=padded)
    return stencil.stencil_cheb_step(W, x, b, d, q, SCALE, OMEGA,
                                     padded=padded)


def _before(epi, W, x, xp, b, d, q):
    """What the solvers computed before the fusion: the apply (the zero
    ghost layer padded by F.pad where the grid had none), then the
    V-cycle's subtraction or the Chebyshev recurrence's update with a
    Jacobi preconditioner, in treeops.cheb_smooth's order."""
    y = stencil.stencil_accum_plain(W, xp)
    if epi == "none":
        return y
    if epi == "residual":
        return b - y
    if epi == "cheb_first":
        return SCALE * (d * (b - y)) + x
    t = SCALE * (d * (b - y)) + x
    return OMEGA * (t - q) + q


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _same(a, b):
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("epi", EPILOGUES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("ndim,nd", [(2, 2), (2, 3), (3, 2), (3, 3)])
def test_twins_are_the_unfused_ops(ndim, nd, dtype, epi):
    """Each entry's twin (what the entry runs on a CPU tensor) is the
    unfused op sequence bit for bit: zero-boundary from x, padded from an
    xp with nonzero ghosts (the cart path's neighbour planes)."""
    W, x, xp, b, d, q = _case(ndim, nd, dtype, 10 * ndim + nd)
    assert _same(_entry(epi, W, x, b, d, q, False),
                 _before(epi, W, x, xp, b, d, q))
    W, x, xp, b, d, q = _case(ndim, nd, dtype, 20 * ndim + nd, ghosts=True)
    assert _same(_entry(epi, W, xp, b, d, q, True),
                 _before(epi, W, x, xp, b, d, q))


@pytest.mark.parametrize("epi", EPILOGUES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("ndim,nd", [(2, 2), (3, 3)])
def test_zero_boundary_form_equals_padded_form(ndim, nd, dtype, epi):
    """The zero-boundary form on x gives the padded form's bits on x with
    its zero ghost layer, and the twins are the named twin functions."""
    W, x, xp, b, d, q = _case(ndim, nd, dtype, 30 * ndim + nd)
    assert _same(_entry(epi, W, x, b, d, q, False),
                 _entry(epi, W, xp, b, d, q, True))
    twin = stencil.TWINS["stencil_accum" if epi == "none"
                         else "stencil_" + epi]
    args = {"none": (xp,), "residual": (xp, b),
            "cheb_first": (xp, b, d, SCALE),
            "cheb_step": (xp, b, d, q, SCALE, OMEGA)}[epi]
    kw = {} if epi == "none" else {"padded": True}
    assert _same(twin(W, *args, **kw), _entry(epi, W, xp, b, d, q, True))


def _smoother_case(dtype, seed):
    """A diagonally dominant 3D nd = 3 stencil (centre blocks + 30 I), its
    inverse diagonal, Chebyshev bounds of the working dtype, b, x0."""
    W, x0, _, b, _, _ = _case(3, 3, dtype, seed)
    W[..., 13, :, :] += 30.0 * torch.eye(3, dtype=dtype)
    d = 1.0 / torch.diagonal(W[..., 13, :, :], dim1=-2, dim2=-1)
    npdt = treeops.NP_DTYPE[dtype]
    return W, d.contiguous(), npdt(0.2), npdt(2.2), b, x0


@pytest.mark.parametrize("x0_zero", [False, True])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_cheb_smooth_over_stencil_op_is_the_callable_path(dtype, x0_zero):
    """cheb_smooth(StencilOp(W), diag=d) takes the fused forms and gives
    the bits of the callable Jacobi path and of the unfused diag path."""
    W, d, emin, emax, b, x0 = _smoother_case(dtype, 7)
    if x0_zero:
        x0 = torch.zeros_like(x0)
    op = stencil.StencilOp(W)
    got = treeops.cheb_smooth(op, None, emin, emax, 9, b, x0,
                              x0_zero=x0_zero, diag=d)
    A = lambda v: tabf.stencil_apply(W, v)  # noqa: E731
    assert _same(got, treeops.cheb_smooth(A, lambda r: d * r, emin, emax, 9,
                                          b, x0, x0_zero=x0_zero))
    assert _same(got, treeops.cheb_smooth(A, None, emin, emax, 9, b, x0,
                                          x0_zero=x0_zero, diag=d))


@pytest.mark.parametrize("x0_zero", [False, True])
def test_cheb_smooth_over_stencil_op_matches_jax(x0_zero):
    W, d, emin, emax, b, x0 = _smoother_case(torch.float64, 8)
    if x0_zero:
        x0 = torch.zeros_like(x0)
    got = treeops.cheb_smooth(stencil.StencilOp(W), None, emin, emax, 8, b,
                              x0, x0_zero=x0_zero, diag=d)
    Wj, dj = jnp.asarray(W.numpy()), jnp.asarray(d.numpy())
    want = jtreeops.cheb_smooth(
        lambda v: jabf.stencil_apply(Wj, v), lambda r: dj * r, emin, emax,
        8, jnp.asarray(b.numpy()), jnp.asarray(x0.numpy()), x0_zero=x0_zero)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()


def test_check_refuses_what_the_kernel_cannot_take():
    """K4's launch checks, run on CPU tensors: shapes in either form, the
    epilogue's vectors, one float dtype, contiguity, W's 16-byte
    alignment (its tiles arrive by bulk copies)."""
    W, x, xp, b, d, q = _case(3, 3, torch.float64, 1)
    grid = GRIDS[3]
    assert stencil._check(W, xp) == (3, 3, grid)
    assert stencil._check(W, x, False, b=b, d=d, p_km1=q) == (3, 3, grid)
    buf = torch.zeros(W.numel() + 2, dtype=W.dtype)
    off = 1 if buf.data_ptr() % 16 == 0 else 0
    Wm = buf[off:off + W.numel()].view(W.shape)
    Wm.copy_(W)
    assert Wm.data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="16-byte aligned"):
        stencil._check(Wm, xp)
    with pytest.raises(ValueError, match="not contiguous"):
        stencil._check(W, xp.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="not contiguous"):
        stencil._check(W, x, False, b=b.transpose(0, 2).contiguous()
                       .transpose(0, 2))
    with pytest.raises(ValueError, match="expected W"):
        stencil._check(W, xp, False)
    with pytest.raises(ValueError, match="expected W"):
        stencil._check(W[:, :, :-1].contiguous(), x, False)
    with pytest.raises(ValueError, match="has shape"):
        stencil._check(W, x, False, b=b[:, :, :-1].contiguous())
    with pytest.raises(ValueError):
        stencil._check(W, x, False, d=d.float())
    with pytest.raises(ValueError):
        stencil._check(W.float(), xp)
    with pytest.raises(TypeError):
        stencil._check(W.half(), xp.half())
    with pytest.raises(ValueError, match="unsupported device"):
        stencil.stencil_residual(W.to("meta"), x.to("meta"), b.to("meta"))


def _count_entries(monkeypatch):
    """Counts of every K4 entry and of K6's, by name, as the solvers call
    them (each still runs)."""
    calls = dict.fromkeys(tuple(stencil.TWINS) + ("cheb_first",
                                                   "cheb_step"), 0)

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for name in stencil.TWINS:
        monkeypatch.setattr(stencil, name,
                            counted(name, getattr(stencil, name)))
    for name in ("cheb_first", "cheb_step"):
        monkeypatch.setattr(cheb, name, counted(name, getattr(cheb, name)))
    return calls


def test_single_device_vcycle_goes_through_the_fused_entries(monkeypatch):
    """A 4-level mx=8 V-cycle: both stencil levels smooth and take their
    residual through the fused entries; K6 runs only the fine level's
    zero-guess first step (L-2's and L-3's come from the stores of K5's
    restrict_parity_residual_cheb_first and restrict_grid_cheb_first) and
    the fine level's updates."""
    _, t = problems(3, (8, 8, 8), ["-model", "2"])
    slv = tabf.ABFSolver(*t[1:], device="cpu", nlevels=4)
    cfg = slv.cfg
    calls = _count_entries(monkeypatch)
    rng = np.random.default_rng(4)
    slv.bodies()["mg_pc"](torch.as_tensor(rng.standard_normal(
        slv.data["op"].nu)))
    pre = cfg.cheb_pre_its or cfg.cheb_its
    levels = 2
    assert calls == {"stencil_accum": 0, "stencil_apply": 0,
                     "stencil_residual": levels,
                     "stencil_cheb_first": levels,
                     "stencil_cheb_step": levels * (pre + cfg.cheb_its - 2),
                     "cheb_first": 2,
                     "cheb_step": pre + cfg.cheb_its - 2}


def test_cart_levels_go_through_the_fused_entries(monkeypatch):
    """A cart V-cycle over 1x2x2 shards with 4 levels: the L-2 level on
    every shard (padded form, its ghost planes) and the replicated L-3
    level (zero-boundary form, once per distinct device) smooth and take
    their residual through the fused entries."""
    _, t = problems(3, (8, 8, 8), ["-model", "2"])
    slv = CartABFSolver(CartPartition(t[1], (1, 2, 2)), t[0], *t[4:],
                        ["cpu"] * 4, nlevels=4, loop="plain")
    cfg = slv.dcfg.base
    calls = _count_entries(monkeypatch)
    padded = []
    for name in ("stencil_residual", "stencil_cheb_first",
                 "stencil_cheb_step"):
        fn = getattr(stencil, name)

        def spy(*a, fn=fn, **k):
            padded.append(k.get("padded", False))
            return fn(*a, **k)
        monkeypatch.setattr(stencil, name, spy)
    rng = np.random.default_rng(5)
    r = slv.blocks.fine_mult(slv.ddata["inv_diag_fine"].map(
        lambda v: torch.as_tensor(rng.standard_normal(tuple(v.shape)),
                                  dtype=v.dtype)))
    _cart_bodies(slv.dcfg, slv.smesh, slv.ddata, slv.blocks)["mg_pc"](r)
    pre = cfg.cheb_pre_its or cfg.cheb_its
    shards, repl = 4, 1
    per_level = {"stencil_residual": 1, "stencil_cheb_first": 1,
                 "stencil_cheb_step": pre + cfg.cheb_its - 2}
    for name, n in per_level.items():
        assert calls[name] == (shards + repl) * n
    assert calls["stencil_accum"] == calls["stencil_apply"] == 0
    assert padded.count(True) == shards * sum(per_level.values())
    assert padded.count(False) == repl * sum(per_level.values())
