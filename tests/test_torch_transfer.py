"""K5, the multigrid transfers (kernels/transfer.py), on the CPU, where each
entry runs its plain twin:

- the twins against the JAX package's prolong_parity, restrict_parity,
  prolong_grid and restrict_grid (exsaddle_tpu/abf.py): prolongations bit
  for bit, restrictions to 1e-12 relative in float64 (XLA may sum the
  padded terms in another order);
- each fused twin bit for bit the unfused twin followed by the add (or
  K6's zero-guess first Chebyshev step: restrict_grid_cheb_first, against
  JAX's restriction followed by that step as well), or preceded by the
  subtraction (and the weighting: the cart V-cycle's w * (b - y), against
  JAX's restriction of it as well);
- cheb_smooth given that first iterate (p1=) gives the zero-guess bits;
- the entries on CPU tensors are the twins and count no launch;
- the launch checks refuse what the kernel cannot take;
- the single-device V-cycle and the cart V-cycle call each K5 entry, the
  fused ones where the V-cycle adds the correction or forms the residual
  (the cart V-cycle its weighted residual) or restricts into a smoothed
  level (its first pre-smoothing step in the restriction's store);
- the port's V-cycle (ABFSolver's mg_pc body) against the JAX package's.

The kernels themselves run on the card (tests/test_torch_gpu.py). Inputs
are numpy draws from fixed seeds handed to both packages; JAX runs on the
CPU in float64."""

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
from exsaddle_tpu_torch import treeops
from exsaddle_tpu_torch.kernels import cheb, stencil, transfer
from exsaddle_tpu_torch.matfree import _parity_classes
from exsaddle_tpu_torch.parallel.cart import CartPartition
from exsaddle_tpu_torch.parallel.cart_abf import (CartABFSolver, _cart_bodies,
                                                  _local_cls_shapes)

from torch_parallel_common import problems

torch.set_num_threads(1)

# float64 restrictions: the packages may sum in different orders
TOL64 = 1e-12
DTYPES = [torch.float32, torch.float64]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _same(a, b):
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _global_classes(m_el):
    """The fine level's class shapes on m_el macro elements per dim."""
    return tuple(tuple(s) for s in
                 _parity_classes(tuple(2 * m + 1 for m in m_el))[1])


# (m_el, class shapes): 2D and 3D meshes, the 3D flagship's mesh at mx=4,
# and a cart shard's local box (1x2x2 partition of mx=6: 6 x 3 x 3
# elements, the classes cls_shapes_loc gives it)
PARITY_CASES = {
    "2d": ((5, 4), _global_classes((5, 4))),
    "3d": ((3, 4, 2), _global_classes((3, 4, 2))),
    "flagship_mx4": ((4, 4, 4), _global_classes((4, 4, 4))),
    "cart_shard": ((6, 3, 3), _local_cls_shapes((6, 3, 3), 3)),
}


def _parity_inputs(m_el, cls, dtype=torch.float64, seed=6):
    nd = len(m_el)
    n = sum(int(np.prod(s)) for s in cls) * nd
    rng = np.random.default_rng(seed)
    xc = rng.standard_normal(tuple(m + 1 for m in reversed(m_el)) + (nd,))
    xf, b, y = (rng.standard_normal(n) for _ in range(3))
    t = lambda a: torch.as_tensor(a, dtype=dtype)  # noqa: E731
    return t(xc), t(xf), t(b), t(y)


def _weights(n, dtype, seed=9):
    """Ownership weights as the cart V-cycle's w_u holds them: 1, 1/2, 1/4,
    1/8 (a node on 1, 2, 4 or 8 shards' boxes), drawn per value."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(0.5 ** rng.integers(0, 4, n), dtype=dtype)


@pytest.mark.parametrize("case", list(PARITY_CASES))
def test_parity_twins_match_jax(case):
    m_el, cls = PARITY_CASES[case]
    nd = len(m_el)
    xc, xf, _, _ = _parity_inputs(m_el, cls)
    want = jabf.prolong_parity(jnp.asarray(xc.numpy()), cls, m_el)
    got = transfer.prolong_parity_plain(xc, cls, m_el)
    assert np.array_equal(
        got.numpy(), np.concatenate([np.asarray(s).reshape(-1)
                                     for s in want]))
    subs = jmf.split_u_parity(jnp.asarray(xf.numpy()), cls, nd)
    got = transfer.restrict_parity_plain(xf, cls, m_el)
    assert got.shape == xc.shape
    assert _rel(got.numpy(), jabf.restrict_parity(subs, cls, m_el)) < TOL64


# coarse node grids of the grid pair (fine = 2 coarse - 1 per dim)
GRID_COARSE = {2: (4, 5), 3: (3, 4, 5)}


def _grid_inputs(ndim, nd, dtype=torch.float64, seed=7):
    coarse = GRID_COARSE[ndim]
    fine = tuple(2 * n - 1 for n in coarse)
    rng = np.random.default_rng(seed + 10 * ndim + nd)
    t = lambda a: torch.as_tensor(a, dtype=dtype)  # noqa: E731
    return (coarse, fine, t(rng.standard_normal(coarse + (nd,))),
            t(rng.standard_normal(fine + (nd,))),
            t(rng.standard_normal(fine + (nd,))))


@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("ndim", [2, 3])
def test_grid_twins_match_jax(ndim, nd):
    coarse, fine, xc, xf, _ = _grid_inputs(ndim, nd)
    got = transfer.prolong_grid_plain(xc, fine)
    assert np.array_equal(got.numpy(), np.asarray(
        jabf.prolong_grid(jnp.asarray(xc.numpy()), fine)))
    got = transfer.restrict_grid_plain(xf, coarse)
    assert got.shape == xc.shape
    assert _rel(got.numpy(), jabf.restrict_grid(jnp.asarray(xf.numpy()),
                                                coarse)) < TOL64


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(PARITY_CASES))
def test_fused_parity_twins_are_the_unfused_ops(case, dtype):
    m_el, cls = PARITY_CASES[case]
    xc, x, b, y = _parity_inputs(m_el, cls, dtype)
    assert _same(transfer.prolong_parity_plain(xc, cls, m_el, add=x),
                 transfer.prolong_parity_plain(xc, cls, m_el) + x)
    assert _same(transfer.restrict_parity_residual_plain(b, y, cls, m_el),
                 transfer.restrict_parity_plain(b - y, cls, m_el))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(PARITY_CASES))
def test_weighted_residual_twin_is_the_unfused_ops(case, dtype):
    """The weighted residual form's twin is restrict_parity_plain(w * (b -
    y)) bit for bit (the cart V-cycle's ops before it: the subtraction,
    then the ownership weights); in float64 it is JAX's restriction of
    the weighted residual (exsaddle_tpu/parallel/cart_abf.py's mg_pc) to
    TOL64."""
    m_el, cls = PARITY_CASES[case]
    nd = len(m_el)
    _, _, b, y = _parity_inputs(m_el, cls, dtype)
    w = _weights(b.numel(), dtype)
    got = transfer.restrict_parity_weighted_residual_plain(b, y, w, cls,
                                                           m_el)
    assert _same(got, transfer.restrict_parity_plain(w * (b - y), cls,
                                                     m_el))
    assert _same(got, transfer.restrict_parity_plain((b - y) * w, cls,
                                                     m_el))
    if dtype == torch.float64:
        jb, jy, jw = (jmf.split_u_parity(jnp.asarray(v.numpy()), cls, nd)
                      for v in (b, y, w))
        want = jabf.restrict_parity([ws * s for ws, s in zip(
            jw, jtreeops.tsub(jb, jy))], cls, m_el)
        assert _rel(got.numpy(), want) < TOL64


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("ndim,nd", [(2, 2), (2, 3), (3, 2), (3, 3)])
def test_fused_grid_twin_is_the_unfused_ops(ndim, nd, dtype):
    _, fine, xc, _, x = _grid_inputs(ndim, nd, dtype)
    assert _same(transfer.prolong_grid_plain(xc, fine, add=x),
                 x + transfer.prolong_grid_plain(xc, fine))


def _cheb_first_inputs(ndim, nd, dtype, seed=11):
    """A fine grid with signed zeros (a block of -0, so some restricted
    values are -0 and their first iterates +0), a positive inverse
    diagonal of the coarse grid and a scale with every bit of a float64."""
    coarse, fine, _, xf, _ = _grid_inputs(ndim, nd, dtype)
    xf[: (fine[0] + 1) // 2] = -0.0
    xf.view(-1)[::7] = 0.0
    rng = np.random.default_rng(seed + 10 * ndim + nd)
    d = torch.as_tensor(0.5 + rng.random(coarse + (nd,)), dtype=dtype)
    return coarse, xf, d, 0.7312345678901234


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("ndim,nd", [(2, 2), (2, 3), (3, 2), (3, 3)])
def test_fused_cheb_first_twin_is_the_unfused_ops(ndim, nd, dtype):
    """restrict_grid_cheb_first's twin is restrict_grid_plain followed by
    K6's twin of the zero-guess first step, bit for bit, signed zeros
    included (a -0 restricted value gives a +0 iterate)."""
    coarse, xf, d, scale = _cheb_first_inputs(ndim, nd, dtype)
    b, p1 = transfer.restrict_grid_cheb_first_plain(xf, coarse, d, scale)
    want = transfer.restrict_grid_plain(xf, coarse)
    assert _same(b, want)
    assert _same(p1, cheb.cheb_first_plain(want, None, d,
                                           torch.zeros_like(want), scale))
    assert bool((_bits(b) == _bits(torch.tensor(-0.0, dtype=dtype))).any())
    assert not bool(torch.signbit(p1[b == 0]).any())


@pytest.mark.parametrize("ndim,nd", [(2, 2), (2, 3), (3, 2), (3, 3)])
def test_fused_cheb_first_twin_matches_jax(ndim, nd):
    """In float64 the fused twin is JAX's restrict_grid
    (exsaddle_tpu/abf.py:171) followed by the zero-guess first Chebyshev
    iterate scale (d b) of exsaddle_tpu/treeops.py's cheb_smooth, to
    TOL64 (XLA may sum the restriction in another order)."""
    coarse, xf, d, scale = _cheb_first_inputs(ndim, nd, torch.float64)
    b, p1 = transfer.restrict_grid_cheb_first_plain(xf, coarse, d, scale)
    jb = jabf.restrict_grid(jnp.asarray(xf.numpy()), coarse)
    assert _rel(b.numpy(), jb) < TOL64
    assert _rel(p1.numpy(), scale * (jnp.asarray(d.numpy()) * jb)) < TOL64


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_cheb_smooth_first_iterate_given(dtype):
    """cheb_smooth with the zero-guess first iterate given (p1=, what
    restrict_grid_cheb_first computes) returns the x0_zero=True path's
    bits, over a stencil operator (K4's fused steps) and over a plain one
    (K6's steps); p1 without x0_zero=True raises."""
    coarse, xf, _, _ = _cheb_first_inputs(3, 3, dtype)
    rng = np.random.default_rng(13)
    W = torch.as_tensor(0.1 * rng.standard_normal(coarse + (27, 3, 3)),
                        dtype=dtype)
    b = transfer.restrict_grid_plain(xf, coarse)
    d = torch.as_tensor(0.5 + rng.random(b.shape), dtype=dtype)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    emin, emax = npdt(0.1), npdt(1.9)
    scale = float(treeops.cheb_scale(emin, emax))
    _, p1 = transfer.restrict_grid_cheb_first_plain(xf, coarse, d, scale)
    for op in (stencil.StencilOp(W), lambda x: stencil.stencil_apply(W, x)):
        want = treeops.cheb_smooth(op, None, emin, emax, 3, b,
                                   torch.zeros_like(b), x0_zero=True,
                                   diag=d)
        got = treeops.cheb_smooth(op, None, emin, emax, 3, b,
                                  torch.zeros_like(b), x0_zero=True, diag=d,
                                  p1=p1)
        assert _same(got, want)
    with pytest.raises(ValueError, match="x0_zero"):
        treeops.cheb_smooth(op, None, emin, emax, 3, b, torch.zeros_like(b),
                            diag=d, p1=p1)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_entries_on_cpu_are_the_twins(dtype):
    """Every entry on CPU tensors returns its twin's bits and counts no
    launch; abf.py's four names are the entries."""
    assert (tabf.prolong_parity, tabf.restrict_parity, tabf.prolong_grid,
            tabf.restrict_grid) == (transfer.prolong_parity,
                                    transfer.restrict_parity,
                                    transfer.prolong_grid,
                                    transfer.restrict_grid)
    m_el, cls = PARITY_CASES["cart_shard"]
    xc, x, b, y = _parity_inputs(m_el, cls, dtype)
    w = _weights(b.numel(), dtype)
    _, fine, gc, gf, gx = _grid_inputs(3, 3, dtype)
    coarse = GRID_COARSE[3]
    transfer.LAUNCHES.reset()
    pairs = [(transfer.prolong_parity(xc, cls, m_el),
              transfer.prolong_parity_plain(xc, cls, m_el)),
             (transfer.prolong_parity(xc, cls, m_el, add=x),
              transfer.prolong_parity_plain(xc, cls, m_el, add=x)),
             (transfer.restrict_parity(b, cls, m_el),
              transfer.restrict_parity_plain(b, cls, m_el)),
             (transfer.restrict_parity_residual(b, y, cls, m_el),
              transfer.restrict_parity_residual_plain(b, y, cls, m_el)),
             (transfer.restrict_parity_weighted_residual(b, y, w, cls, m_el),
              transfer.restrict_parity_weighted_residual_plain(
                  b, y, w, cls, m_el)),
             (transfer.prolong_grid(gc, fine),
              transfer.prolong_grid_plain(gc, fine)),
             (transfer.prolong_grid(gc, fine, add=gx),
              transfer.prolong_grid_plain(gc, fine, add=gx)),
             (transfer.restrict_grid(gf, coarse),
              transfer.restrict_grid_plain(gf, coarse))]
    gd = torch.ones(coarse + (3,), dtype=dtype)
    pairs += zip(transfer.restrict_grid_cheb_first(gf, coarse, gd, 0.5),
                 transfer.restrict_grid_cheb_first_plain(gf, coarse, gd, 0.5))
    assert all(_same(a, w) for a, w in pairs)
    assert transfer.LAUNCHES.n == 0
    assert transfer.LAUNCHES.by == dict.fromkeys(transfer.FORMS, 0)


def test_checks_refuse_what_the_kernel_cannot_take():
    """The launch checks, run on CPU tensors (a CPU tensor itself takes
    the twin): one float dtype and device, the shapes, contiguity, class
    shapes inside the coarse grid, ndim and dofs per node of 2 or 3; any
    device but the CPU and CUDA raises."""
    m_el, cls = PARITY_CASES["3d"]
    xc, x, b, y = _parity_inputs(m_el, cls)
    cshape, n, table = transfer.parity_layout(cls, m_el, 3)
    assert cshape + (3,) == tuple(xc.shape) and n == x.numel()
    assert table[:3] == list(cshape) and len(table) == 3 * 9
    transfer._check("prolong_parity", xc, cshape + (3,), add=((n,), x))
    with pytest.raises(ValueError, match="not contiguous"):
        transfer._check("prolong_parity", xc.transpose(0, 1).contiguous()
                        .transpose(0, 1), cshape + (3,))
    with pytest.raises(ValueError, match="not contiguous"):
        transfer._check("restrict_parity", b[::2], tuple(b[::2].shape))
    with pytest.raises(ValueError, match="not contiguous"):
        transfer._check("restrict_parity_residual", b, (n,),
                        y=((n,), torch.stack([y, y], 1)[:, 0]))
    with pytest.raises(TypeError, match="not supported"):
        transfer._check("restrict_parity", b.half(), (n,))
    with pytest.raises(ValueError, match="float32"):
        transfer._check("prolong_parity", xc, cshape + (3,),
                        add=((n,), x.float()))
    with pytest.raises(ValueError, match="has shape"):
        transfer._check("restrict_parity", b[:-1], (n,))
    with pytest.raises(ValueError, match="does not fit"):
        transfer.parity_layout(((cshape[0] + 1,) + cls[0][1:],) + cls[1:],
                               m_el, 3)
    with pytest.raises(ValueError, match="does not fit"):
        transfer.parity_layout(cls[:4] + ((cshape[0],) + cls[4][1:],)
                               + cls[5:], m_el, 3)
    with pytest.raises(ValueError, match="classes"):
        transfer.parity_layout(cls[:4], m_el, 3)
    with pytest.raises(ValueError, match="ndim"):
        transfer._dims("restrict_grid", 1, 3)
    with pytest.raises(ValueError, match="dofs per node"):
        transfer._dims("restrict_grid", 3, 4)
    meta = torch.device("meta")
    _, fine, gc, gf, _ = _grid_inputs(3, 3)
    for call in (lambda: transfer.prolong_parity(xc.to(meta), cls, m_el),
                 lambda: transfer.restrict_parity(b.to(meta), cls, m_el),
                 lambda: transfer.restrict_parity_residual(
                     b.to(meta), y.to(meta), cls, m_el),
                 lambda: transfer.restrict_parity_weighted_residual(
                     b.to(meta), y.to(meta), y.to(meta), cls, m_el),
                 lambda: transfer.prolong_grid(gc.to(meta), fine),
                 lambda: transfer.restrict_grid(gf.to(meta),
                                                GRID_COARSE[3]),
                 lambda: transfer.restrict_grid_cheb_first(
                     gf.to(meta), GRID_COARSE[3], gc.to(meta), 1.0)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()


def test_checks_refuse_a_bad_weight():
    """The weighted residual form's checks, on CPU tensors: a w of another
    shape, dtype or device than b, or not contiguous, raises."""
    m_el, cls = PARITY_CASES["3d"]
    _, _, b, y = _parity_inputs(m_el, cls)
    _, n, _ = transfer.parity_layout(cls, m_el, 3)
    w = _weights(n, torch.float64)
    name = "restrict_parity_weighted_residual"
    transfer._check(name, b, (n,), y=((n,), y), w=((n,), w))
    with pytest.raises(ValueError, match="w has shape"):
        transfer._check(name, b, (n,), y=((n,), y), w=((n,), w[:-1]))
    with pytest.raises(ValueError, match="w is torch.float32"):
        transfer._check(name, b, (n,), y=((n,), y), w=((n,), w.float()))
    with pytest.raises(ValueError, match="w is torch.float64 on meta"):
        transfer._check(name, b, (n,), y=((n,), y),
                        w=((n,), w.to("meta")))
    with pytest.raises(ValueError, match="not contiguous"):
        transfer._check(name, b, (n,), y=((n,), y),
                        w=((n,), torch.stack([w, w], 1)[:, 0]))


def _count_entries(monkeypatch):
    """Counts of every K5 entry by name, the prolongations split by
    whether they were given add= (each call still runs)."""
    calls = dict.fromkeys(transfer.FORMS, 0)

    def counted(name, fn):
        def wrapped(*a, **k):
            form = name + ("_add" if k.get("add") is not None else "")
            calls[form] += 1
            return fn(*a, **k)
        return wrapped

    for name in transfer.TWINS:
        monkeypatch.setattr(transfer, name,
                            counted(name, getattr(transfer, name)))
    return calls


def test_single_device_vcycle_goes_through_k5(monkeypatch):
    """A 4-level mx=8 V-cycle makes 6 transfers: the fine residual
    restricted by the fused restrict_parity_residual_cheb_first (L-2's
    first pre-smoothing step in its store), the correction
    prolonged and added by prolong_parity(add=), and on the two stencil
    levels prolong_grid(add=) and the restriction: into the smoothed L-3
    restrict_grid_cheb_first (L-3's first pre-smoothing step in its
    store), into the coarse solve restrict_grid."""
    _, t = problems(3, (8, 8, 8), ["-model", "2"])
    slv = tabf.ABFSolver(*t[1:], device="cpu", nlevels=4)
    calls = _count_entries(monkeypatch)
    rng = np.random.default_rng(4)
    slv.bodies()["mg_pc"](torch.as_tensor(rng.standard_normal(
        slv.data["op"].nu)))
    assert calls == {**dict.fromkeys(transfer.FORMS, 0),
                     "restrict_parity_residual_cheb_first": 1,
                     "prolong_parity_add": 1,
                     "restrict_grid_cheb_first": 1, "restrict_grid": 1,
                     "prolong_grid_add": 2}


def test_cart_vcycle_goes_through_k5(monkeypatch):
    """A cart V-cycle over 1x2x2 shards with 4 levels: the parity pair on
    every shard (the restriction of the ownership-weighted residual
    w_u * (r - A x) fused, none unfused; the prolongation adding the
    correction), and on the
    replicated levels the grid pair (once per distinct device): the L-2
    grid to L-3 and back (no add: the correction goes back to the shards
    first; into the smoothed L-3 the restriction computes L-3's first
    pre-smoothing step in its store), L-3 to the coarse grid and back with
    the add."""
    _, t = problems(3, (8, 8, 8), ["-model", "2"])
    slv = CartABFSolver(CartPartition(t[1], (1, 2, 2)), t[0], *t[4:],
                        ["cpu"] * 4, nlevels=4, loop="plain")
    calls = _count_entries(monkeypatch)
    rng = np.random.default_rng(5)
    r = slv.blocks.fine_mult(slv.ddata["inv_diag_fine"].map(
        lambda v: torch.as_tensor(rng.standard_normal(tuple(v.shape)),
                                  dtype=v.dtype)))
    _cart_bodies(slv.dcfg, slv.smesh, slv.ddata, slv.blocks)["mg_pc"](r)
    shards = 4
    assert calls == {**dict.fromkeys(transfer.FORMS, 0),
                     "restrict_parity_weighted_residual": shards,
                     "prolong_parity_add": shards,
                     "restrict_grid_cheb_first": 1, "restrict_grid": 1,
                     "prolong_grid": 1, "prolong_grid_add": 1}


def _jax_vcycle(slv):
    """The JAX package's V-cycle (exsaddle_tpu/abf.py make_abf_solver's
    vcycle and mg_pc, float64 on the CPU) over the JAX solver's data,
    assembled from the package's own functions."""
    cfg, data = slv.cfg, slv.data
    nlev, nd = cfg.nlevels, cfg.ndim
    op, aux = data["op"], data["aux"]
    pre_its = cfg.cheb_pre_its if cfg.cheb_pre_its > 0 else cfg.cheb_its

    def merge(x):
        return x.reshape(x.shape[:-2] + (x.shape[-2] * x.shape[-1],))

    def unmerge(x):
        return x.reshape(x.shape[:-1] + (x.shape[-1] // nd, nd))

    ops, pcs = {}, {}
    for k in range(1, nlev):
        if k == nlev - 1:
            ops[k] = lambda s: jabf.mult_u_tree(op, aux, s)
            pcs[k] = lambda t, d=data["inv_diag_fine"]: [
                a * b for a, b in zip(d, t)]
        else:
            ops[k] = lambda xm, V=data["stencils_m"][k - 1]: \
                jabf.stencil_apply_merged(V, xm)
            pcs[k] = lambda t, d=merge(data["inv_diag_lvls"][k - 1]): d * t

    def smooth(k, b, x0, pre=False):
        emin, emax = data["bounds"][k - 1]
        return jtreeops.cheb_smooth(ops[k], pcs[k], emin, emax,
                                    pre_its if pre else cfg.cheb_its, b, x0,
                                    unroll=(k < nlev - 1), x0_zero=pre)

    def vcycle(k, b):
        if k == 0:
            return (data["coarse_inv"] @ b.reshape(-1)).reshape(b.shape)
        if k == nlev - 1:
            x = smooth(k, b, jtreeops.tzeros_like(b), pre=True)
            r = jtreeops.tsub(b, ops[k](x))
            xc = vcycle(k - 1, jabf.restrict_parity(r, cfg.cls_shapes,
                                                    cfg.m_el))
            x = jtreeops.taxpy(1.0, jabf.prolong_parity(
                xc, cfg.cls_shapes, cfg.m_el), x)
            return smooth(k, b, x)
        bm = merge(b)
        xm = smooth(k, bm, jnp.zeros_like(bm), pre=True)
        rm = bm - ops[k](xm)
        xc = vcycle(k - 1, jabf.restrict_grid(unmerge(rm),
                                              cfg.level_grids[k - 1]))
        xm = xm + merge(jabf.prolong_grid(xc, cfg.level_grids[k]))
        return unmerge(smooth(k, bm, xm))

    return lambda subs: vcycle(nlev - 1, subs)


@pytest.mark.parametrize("ndim,m_el,args,size,nlevels", [
    (3, (4, 4, 4), ["-model", "11", "-size_x", "0.1"], (0.1, 1.0, 1.0), 3),
    (2, (16, 16), ["-model", "0"], None, 4),
], ids=["pseudoice_mx4_3lev", "solcx_2d_4lev"])
def test_vcycle_matches_jax(ndim, m_el, args, size, nlevels):
    """One V-cycle of the port's ABFSolver (its mg_pc body over the JAX
    build's numbers, data_from_numpy) against the JAX package's V-cycle on
    the same residual: float64, within 1e-12 of max |y| (K1's, the
    stencils' and the restrictions' twins sum in other orders than XLA;
    the two cases read 4e-16 and 8e-16)."""
    j, t = problems(ndim, m_el, args, size=size)
    jslv = jabf.ABFSolver(*j[1:], nlevels=nlevels)
    cfg, data, setup = tabf.data_from_numpy(
        dataclasses.asdict(jslv.cfg), jax.device_get(jslv.data),
        jax.device_get(jslv.setup), "cpu", torch.float64)
    tslv = tabf.ABFSolver.from_parts(cfg, data, setup, device="cpu",
                                     dtype=torch.float64)
    nu = data["op"].nu
    r = np.random.default_rng(8).standard_normal(nu)
    got = tslv.bodies()["mg_pc"](torch.as_tensor(r)).numpy()
    jop = jslv.data["op"]
    want = _jax_vcycle(jslv)(jop._split_u(jnp.asarray(r)))
    want = np.concatenate([np.asarray(s).reshape(-1) for s in want])
    assert got.shape == want.shape == (nu,)
    assert np.all(np.isfinite(got))
    assert _rel(got, want) < TOL64, _rel(got, want)
