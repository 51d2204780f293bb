"""The plain twins of the port's multigrid kernels against the JAX package:
K4, the block stencil apply (kernels/stencil.py; exsaddle_tpu/abf.py
stencil_accum and its TPU production form stencil_apply_merged), and K6,
the Chebyshev update (kernels/cheb.py, taken by treeops.cheb_smooth when
it is given the Jacobi diagonal; exsaddle_tpu/treeops.py cheb_smooth).

On the CPU the wrappers run their twins; the kernels themselves run on the
card (tests/test_torch_gpu.py). Inputs are numpy draws from fixed seeds
handed to both packages; JAX runs on the CPU in float64."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from exsaddle_tpu import abf as jabf
from exsaddle_tpu import treeops as jtreeops

from exsaddle_tpu_torch import abf as tabf
from exsaddle_tpu_torch import bench, treeops
from exsaddle_tpu_torch.kernels import cheb, stencil

torch.set_num_threads(1)

# float64: the packages sum in different orders
TOL64 = 1e-12

GRIDS = {2: (5, 7), 3: (3, 4, 5)}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _stencil_case(ndim, nd, seed):
    grid = GRIDS[ndim]
    rng = np.random.default_rng(seed)
    W = rng.standard_normal(grid + (3 ** ndim, nd, nd))
    xp = rng.standard_normal(tuple(g + 2 for g in grid) + (nd,))
    return W, xp


@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("ndim", [2, 3])
def test_stencil_plain_matches_jax_stencil_accum(ndim, nd):
    """Nonzero ghosts (the cart path's neighbour planes)."""
    W, xp = _stencil_case(ndim, nd, 10 * ndim + nd)
    got = stencil.stencil_accum_plain(torch.as_tensor(W), torch.as_tensor(xp))
    want = jabf.stencil_accum(jnp.asarray(W), jnp.asarray(xp))
    assert got.shape == want.shape == GRIDS[ndim] + (nd,)
    assert _rel(got.numpy(), want) < TOL64
    # on a CPU tensor the wrapper is the plain version
    assert torch.equal(tabf.stencil_accum(torch.as_tensor(W),
                                          torch.as_tensor(xp)), got)


@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("ndim", [2, 3])
def test_stencil_plain_matches_jax_merged_form(ndim, nd):
    """Zero ghosts against the TPU's production form: stencil_to_merged
    and stencil_apply_merged on the (x, dof)-merged lane layout."""
    W, xp = _stencil_case(ndim, nd, 20 * ndim + nd)
    grid = GRIDS[ndim]
    x = xp[tuple(slice(1, -1) for _ in grid)]
    y = tabf.stencil_apply(torch.as_tensor(W), torch.as_tensor(x))
    V = jabf.stencil_to_merged(W)
    ym = jabf.stencil_apply_merged(jnp.asarray(V), jnp.asarray(
        x.reshape(grid[:-1] + (grid[-1] * nd,))))
    assert _rel(y.numpy(), np.asarray(ym).reshape(grid + (nd,))) < TOL64


def test_stencil_check_refuses_bad_input():
    """What the kernel's wrapper refuses before a launch (its shape,
    dtype and layout checks, run here on CPU tensors)."""
    W, xp = _stencil_case(3, 3, 1)
    W, xp = torch.as_tensor(W), torch.as_tensor(xp)
    assert stencil._check(W, xp) == (3, 3, GRIDS[3])
    with pytest.raises(ValueError, match="not contiguous"):
        stencil._check(W, xp.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="expected W"):
        stencil._check(W[:, :, :-1].contiguous(), xp)
    with pytest.raises(ValueError):
        stencil._check(W.float(), xp)
    with pytest.raises(TypeError):
        stencil._check(W.half(), xp.half())
    with pytest.raises(ValueError, match="dofs per node"):
        stencil._check(torch.zeros(GRIDS[3] + (27, 4, 4)),
                       torch.zeros(tuple(g + 2 for g in GRIDS[3]) + (4,)))


def test_kernels_refuse_other_devices():
    """A tensor neither on the CPU nor on CUDA raises; nothing falls back."""
    meta = torch.zeros(GRIDS[2] + (9, 2, 2), device="meta")
    xp = torch.zeros(tuple(g + 2 for g in GRIDS[2]) + (2,), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        stencil.stencil_accum(meta, xp)
    v = torch.zeros(6, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cheb.cheb_first(v, None, v, v, 0.5)
    with pytest.raises(ValueError, match="unsupported device"):
        cheb.cheb_step(v, v, v, v, v, 0.5, 1.2)


# --- K6: the Chebyshev update ------------------------------------------------

SHAPE = (4, 5, 3)


def _cheb_case(dtype, seed=5):
    """An SPD operator on a grid-shaped vector, its Jacobi diagonal, the
    Chebyshev bounds (0.1 and 1.1 of the largest eigenvalue of D^-1 A, as
    the ABF setup's esteig transform), b and a nonzero x0."""
    n = int(np.prod(SHAPE))
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    A = M @ M.T / n + np.diag(1.0 + rng.random(n))
    d = 1.0 / np.diag(A)
    lam = np.linalg.eigvals(d[:, None] * A).real.max()
    npdt = treeops.NP_DTYPE[dtype]
    emin, emax = npdt(0.1 * lam), npdt(1.1 * lam)
    b = rng.standard_normal(SHAPE)
    x0 = rng.standard_normal(SHAPE)
    return A, d.reshape(SHAPE), emin, emax, b, x0


def _torch_mult(A, dtype):
    At = torch.as_tensor(A, dtype=dtype)
    return lambda x: (At @ x.reshape(-1)).reshape(x.shape)


@pytest.mark.parametrize("x0_zero", [False, True])
def test_cheb_smooth_diag_matches_jax(x0_zero):
    A, d, emin, emax, b, x0 = _cheb_case(torch.float64)
    if x0_zero:
        x0 = np.zeros(SHAPE)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    got = treeops.cheb_smooth(_torch_mult(A, torch.float64), None, emin,
                              emax, 8, t(b), t(x0), x0_zero=x0_zero,
                              diag=t(d))
    Aj, dj = jnp.asarray(A), jnp.asarray(d)
    want = jtreeops.cheb_smooth(
        lambda x: (Aj @ x.reshape(-1)).reshape(x.shape),
        lambda r: dj * r, emin, emax, 8, jnp.asarray(b), jnp.asarray(x0),
        x0_zero=x0_zero)
    assert _rel(got.numpy(), want) < TOL64


@pytest.mark.parametrize("x0_zero", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cheb_smooth_diag_bitwise_callable_path(dtype, x0_zero):
    """The diag path (kernels.cheb's twins on the CPU) computes the bits of
    the callable Jacobi path it replaces on the ABF route."""
    A, d, emin, emax, b, x0 = _cheb_case(dtype, seed=6)
    t = lambda a: torch.as_tensor(a, dtype=dtype)  # noqa: E731
    x0 = torch.zeros(SHAPE, dtype=dtype) if x0_zero else t(x0)
    mult, dt = _torch_mult(A, dtype), t(d)
    got = treeops.cheb_smooth(mult, None, emin, emax, 12, t(b), x0,
                              x0_zero=x0_zero, diag=dt)
    want = treeops.cheb_smooth(mult, lambda r: dt * r, emin, emax, 12,
                               t(b), x0, x0_zero=x0_zero)
    assert got.dtype == dtype
    assert torch.equal(got, want)


def test_cheb_twins_are_the_recurrence_ops():
    """cheb_first / cheb_step on CPU tensors: the twins, and the twins are
    the recurrence's ops in its order (scale, omega rounded as torch
    rounds a Python scalar)."""
    rng = np.random.default_rng(9)
    b, ap, d, pk, pkm1 = (torch.as_tensor(rng.standard_normal(7),
                                          dtype=torch.float32)
                          for _ in range(5))
    scale, omega = 0.3, 1.7
    p1 = cheb.cheb_first(b, ap, d, pk, scale)
    assert torch.equal(p1, cheb.cheb_first_plain(b, ap, d, pk, scale))
    assert torch.equal(p1, scale * (d * (b - ap)) + pk)
    assert torch.equal(cheb.cheb_first(b, None, d, pk, scale),
                       scale * (d * b) + pk)
    p2 = cheb.cheb_step(b, ap, d, pk, pkm1, scale, omega)
    assert torch.equal(p2, cheb.cheb_step_plain(b, ap, d, pk, pkm1, scale,
                                                omega))
    t = scale * (d * (b - ap)) + pk
    assert torch.equal(p2, omega * (t - pkm1) + pkm1)


@pytest.fixture(scope="module")
def solver():
    """A 3D mx=4 pseudoice float64 solver with 3 levels: one block-stencil
    level between the fine level and the coarse inverse."""
    p = bench._build_problem(4)
    return tabf.ABFSolver(p["mesh"], p["fes"], p["coeff"], p["bc_idx"],
                          p["bc_vals"], device="cpu", nlevels=3)


def test_abf_bodies_go_through_the_kernel_wrappers(solver, monkeypatch):
    """The V-cycle smooths every level with the Jacobi diagonals passed as
    diag: the fine level through kernels.cheb, the stencil level through
    K4's fused entries (each Chebyshev step one stencil_cheb_* call, its
    residual one stencil_residual call; its zero-guess first step, which
    applies nothing, in the store of K5's fused parity restriction); the
    p-block's polynomial goes through kernels.cheb (on the CPU K3's fused
    steps run their twins, K3's plain version then K6)."""
    k4 = tuple(stencil.TWINS)
    calls = dict.fromkeys(("cheb_first", "cheb_step") + k4, 0)

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for name in ("cheb_first", "cheb_step"):
        monkeypatch.setattr(cheb, name, counted(name, getattr(cheb, name)))
    for name in k4:
        monkeypatch.setattr(stencil, name,
                            counted(name, getattr(stencil, name)))
    cfg = solver.cfg
    op = solver.data["op"]
    rng = np.random.default_rng(4)
    solver.bodies()["mg_pc"](torch.as_tensor(rng.standard_normal(op.nu)))
    # a pre- and a post-smooth on each of the 2 smoothed levels; the
    # stencil level applies W once per Chebyshev step and once for its
    # residual, every apply fused; K6's first steps: the fine level's
    # pre-smooth and (on the CPU, K1's fused twin) its post-smooth
    pre = cfg.cheb_pre_its or cfg.cheb_its
    assert calls == {"cheb_first": 2,
                     "cheb_step": pre - 1 + cfg.cheb_its - 1,
                     "stencil_accum": 0, "stencil_apply": 0,
                     "stencil_residual": 1, "stencil_cheb_first": 1,
                     "stencil_cheb_step": pre - 1 + cfg.cheb_its - 1}
    assert sum(calls[k] for k in k4) == (pre - 1) + 1 + cfg.cheb_its
    calls.update(dict.fromkeys(calls, 0))
    solver.bodies()["p_solve"](torch.as_tensor(
        rng.standard_normal(op.p_shape)))
    assert calls == {**dict.fromkeys(calls, 0), "cheb_first": 1,
                     "cheb_step": cfg.p_cheb_its - 1}


# --- the build: one nvcc per source, started together, then one link --------

FAKE_NVCC = """#!/bin/sh
# records its arguments; writes its -o output; fails on a source named bad.cu
echo "$@" >> "$NVCC_CALLS"
out=""
prev=""
compile=""
for a in "$@"; do
  [ "$prev" = "-o" ] && out="$a"
  [ "$a" = "-c" ] && compile=1
  case "$a" in *bad.cu) echo "error: bad.cu"; exit 2;; esac
  prev="$a"
done
[ -n "$compile" ] && echo "ptxas info    : Used 1 registers"
echo built > "$out"
"""


@pytest.mark.parametrize("bad", [False, True], ids=["ok", "failing_source"])
def test_kernel_build_compiles_each_source_then_links(tmp_path, monkeypatch,
                                                      bad):
    """kernels/_build.build with a stand-in nvcc: one compile per source
    (-c, the same flags), one link of their objects (-shared), the log of
    every command; a failing source raises and leaves no library."""
    from exsaddle_tpu_torch.kernels import _build
    csrc, bin_dir = tmp_path / "csrc", tmp_path / "bin"
    csrc.mkdir()
    bin_dir.mkdir()
    names = ["a.cu", "b.cu"] + (["bad.cu"] if bad else [])
    for name in names:
        (csrc / name).write_text(f"// {name}\n")
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    calls = tmp_path / "calls"
    monkeypatch.setenv("NVCC_CALLS", str(calls))
    monkeypatch.setenv("PATH", f"{bin_dir}:{os.environ['PATH']}")
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    if bad:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            _build.build()
        assert not os.path.exists(_build.library_path())
        return
    path, built, log = _build.build()
    lines = calls.read_text().splitlines()
    compiles = [ln for ln in lines if " -c " in f" {ln} "]
    assert built and os.path.exists(path)
    assert sorted(ln.split()[-1] for ln in compiles) == sorted(
        str(csrc / n) for n in names)
    assert all(ln.startswith(" ".join(_build.NVCC_FLAGS)) for ln in compiles)
    assert len(lines) == len(names) + 1 and "-shared" in lines[-1].split()
    assert log.count("ptxas info") == len(names)
    assert _build.build() == (path, False, log)
