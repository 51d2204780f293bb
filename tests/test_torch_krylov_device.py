"""The port's device-loop Krylov solvers (treeops.DeviceFGMRES / DeviceGCR,
the control twins of kernels/krylov_ctl.py, abf.DeviceLoopSolver) on the
CPU, where the plain driver (graphs.run_plain) runs the same steps the card
runs as one graph.

- the step-form FGMRES and GCR against the JAX make_fgmres / make_gcr on
  seeded dense systems (restarts included), in float64 and float32;
- each control twin against the numpy arithmetic of the host loop
  (treeops.make_fgmres / make_gcr, abf.make_ir_solver) on recorded states;
- ABFSolver(loop="device") against the JAX ABFSolver at mx=4;
- the host loop with the window arithmetic (make_abf_solver window=True,
  the default on CUDA) bit for bit the device loop's steps;
- the plain driver reads only the loop predicates.

Every input is made from a numpy seed; each test states its tolerance."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from exsaddle_tpu import treeops as jtreeops
from exsaddle_tpu_torch import abf as tabf
from exsaddle_tpu_torch import bench, graphs, treeops
from exsaddle_tpu_torch.kernels import krylov_ctl as kc

from test_torch_abf import _from_jax, _jax_solver, _own, _rel

torch.set_num_threads(1)

DT = {"f64": (torch.float64, jnp.float64, np.float64),
      "f32": (torch.float32, jnp.float32, np.float32)}

# (operator, rtol, atol, max_it, dtol) of each FGMRES case; restart 6 < its
# except where the Krylov space closes first. Happy breakdown: KSPConverged
# Default tests before the breakdown does, and an exact breakdown has a zero
# residual estimate, so rtol and atol are negative there (no convergence
# test can pass) and the breakdown decides.
FGMRES_CASES = {
    "rtol": ("dense", 1e-7, 1e-50, 200, 1e4),
    "happy": ("rank2", -1.0, -1.0, 200, 1e4),
    "max_it": ("dense", 1e-12, 1e-50, 9, 1e4),
    "dtol": ("dense", 1e-7, 1e-50, 200, 0.5),
}


def _system(kind, n=24, seed=0):
    """(A, diagonal right PC, F): a seeded nonsymmetric dense matrix, or
    identity plus the rank-2 shift e1 -> e2 -> e3 with F = e1: every
    Krylov vector is exact in binary, the space closes at dimension 3 and
    the third Arnoldi step breaks down with ||w|| exactly 0."""
    rng = np.random.default_rng(seed)
    if kind == "rank2":
        A = np.eye(n)
        A[1, 0], A[2, 1] = 0.5, 0.25
        return A, np.ones(n), np.eye(n)[0]
    else:
        A = 3.0 * np.eye(n) + rng.standard_normal((n, n)) / np.sqrt(n)
        P = 1.0 / (2.5 + rng.random(n))
    return A, P, rng.standard_normal(n)


def _fgmres_pair(case, dt):
    kind, rtol, atol, max_it, dtol = FGMRES_CASES[case]
    A, P, F = _system(kind)
    tdt, jdt, _ = DT[dt]
    kw = dict(restart=6, rtol=rtol, atol=atol, dtol=dtol, max_it=max_it,
              hist_len=64)
    Aj, Pj = jnp.asarray(A, jdt), jnp.asarray(P, jdt)
    jsolve = jax.jit(jtreeops.make_fgmres(lambda x: Aj @ x,
                                          lambda x: Pj * x, **kw))
    xj, itsj, rnj, stj, hj = jax.device_get(
        jsolve(jnp.asarray(F, jdt), jnp.zeros(len(F), jdt)))
    At, Pt = torch.as_tensor(A, dtype=tdt), torch.as_tensor(P, dtype=tdt)
    ctl = graphs.Control("cpu")
    fg = treeops.DeviceFGMRES(
        ctl, lambda x: At @ x,
        lambda vin, zout: [graphs.Piece(lambda: zout.copy_(Pt * vin), "pc")],
        len(F), tdt, "cpu", **kw)
    x, its, rn, st, h = fg.solve(torch.as_tensor(F, dtype=tdt))
    return (xj, int(itsj), rnj, int(stj), hj), (x.numpy(), int(its),
                                                 rn.numpy(), int(st),
                                                 h.numpy()), ctl, fg


# float64: its and state equal, hist and x to 1e-12 relative (the two
# packages sum the dots in other orders); float32: its and state equal,
# hist and x to 1e-4 relative (float32 rounding of the same recurrence)
TOL = {"f64": 1e-12, "f32": 1e-4}


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("case", list(FGMRES_CASES))
def test_step_fgmres_matches_jax(case, dt):
    (xj, itsj, rnj, stj, hj), (x, its, rn, st, h), ctl, fg = \
        _fgmres_pair(case, dt)
    want = {"rtol": kc.CONVERGED_RTOL, "happy": kc.CONVERGED_HAPPY,
            "max_it": kc.DIVERGED_ITS, "dtol": kc.DIVERGED_DTOL}[case]
    assert stj == want and st == want
    assert its == itsj
    if case in ("rtol", "max_it"):
        assert its > 6          # restarts happened
    if case == "happy":
        assert its == 3
    assert np.array_equal(h < 0, hj < 0)
    live = hj >= 0
    assert _rel(h[live], hj[live]) <= TOL[dt]
    assert _rel(x, xj) <= TOL[dt] if case != "dtol" else True
    # the counters: one init, a cycle start per restart, one Arnoldi step
    # per iteration, one build per cycle that ran a step
    counts = ctl.counts.numpy()[fg.c0:fg.c0 + 4]
    assert counts[0] == 1 and counts[2] == its
    assert counts[3] == -(-its // 6)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_step_gcr_matches_jax(dt):
    """GCR with a truncated restart (5 < its): its equal, rnorm and x to
    the FGMRES tolerances."""
    A, P, b = _system("dense", seed=1)
    A = A + 2.0 * np.diag(np.arange(len(b)) / len(b))
    tdt, jdt, _ = DT[dt]
    kw = dict(restart=5, rtol=1e-6, atol=1e-50, max_it=100)
    Aj, Pj = jnp.asarray(A, jdt), jnp.asarray(P, jdt)
    xj, itsj, rnj = jax.device_get(jax.jit(jtreeops.make_gcr(
        lambda x: Aj @ x, lambda x: Pj * x, **kw))(jnp.asarray(b, jdt)))
    At, Pt = torch.as_tensor(A, dtype=tdt), torch.as_tensor(P, dtype=tdt)
    ctl = graphs.Control("cpu")
    gcr = treeops.DeviceGCR(ctl, lambda x: At @ x, lambda x: Pt * x,
                            len(b), tdt, "cpu", **kw)
    x, its, rn = gcr.solve(torch.as_tensor(b, dtype=tdt))
    assert int(its) == int(itsj) > 5
    assert abs(float(rn) - float(rnj)) <= TOL[dt] * float(rnj) * 10
    assert _rel(x.numpy(), xj) <= TOL[dt]
    assert ctl.counts.numpy()[gcr.c0 + 1] == int(its)


# --- the control twins against the host loop's numpy arithmetic -------------

class _State:
    """An FGMRES control state (krylov_ctl's layout) on the CPU."""

    def __init__(self, k, hist_len, dtype, rng, it, itc, r0, par,
                 max_it=10000, git=None):
        npdt = DT[dtype][2]
        tdt = DT[dtype][0]
        self.k, self.hist_len, self.max_it = k, hist_len, max_it
        H = np.zeros((k + 1, k), npdt)
        g = np.zeros(k + 1, npdt)
        cs = np.zeros(k, npdt)
        sn = np.zeros(k, npdt)
        H[:it + 1, :it] = np.triu(rng.standard_normal((it + 1, it)))
        H[np.arange(it), np.arange(it)] += 2.0
        g[:it + 1] = rng.standard_normal(it + 1)
        if git is not None:
            g[it] = git
        ang = rng.random(it) * 2 * np.pi
        cs[:it], sn[:it] = np.cos(ang), np.sin(ang)
        self.np = {"H": H, "g": g, "cs": cs, "sn": sn}
        t = lambda a: torch.as_tensor(a.copy(), dtype=tdt)   # noqa: E731
        self.H, self.g, self.cs, self.sn = t(H), t(g), t(cs), t(sn)
        self.y = torch.zeros(k, dtype=tdt)
        self.hist = torch.full((hist_len,), -1.0, dtype=tdt)
        self.sc = torch.tensor([r0, 0.0, 0.0], dtype=tdt)
        self.par = torch.tensor(par, dtype=tdt)
        self.ints = torch.tensor([kc.RUNNING, it, itc], dtype=torch.int32)
        self.ix = torch.tensor([it, it + 1], dtype=torch.int64)
        self.p0 = 0
        self.c0 = 0


def _host_arnoldi(npdt, S, h, tt, it, itc, r0, rtol, atol, dtol, max_it, k):
    """The Arnoldi tail of treeops.make_fgmres (host loop), numpy scalars of
    the working dtype, with y from the padded triangle in the kernel's
    order; also y from scipy's triangular solve."""
    H, g, cs, sn = (S[n].copy() for n in ("H", "g", "cs", "sn"))
    git = g[it]
    hapbnd = min(abs(tt / (git if git != 0.0 else npdt(1))), npdt(1e-30))
    happy = tt <= hapbnd
    hcol = np.zeros(k + 1, npdt)
    hcol[: it + 1] = h[: it + 1]
    hcol[it + 1] = tt
    for i in range(it):
        t1, t2 = hcol[i], hcol[i + 1]
        hcol[i] = cs[i] * t1 + sn[i] * t2
        hcol[i + 1] = -sn[i] * t1 + cs[i] * t2
    h_it, h_it1 = hcol[it], hcol[it + 1]
    delta = np.sqrt(h_it * h_it + h_it1 * h_it1)
    safe_d = delta if delta != 0.0 else npdt(1)
    c_new, s_new = h_it / safe_d, h_it1 / safe_d
    cs[it], sn[it] = c_new, s_new
    hcol[it], hcol[it + 1] = delta, 0
    H[:, it] = hcol
    g_new = -s_new * git
    g[it] = c_new * git
    g[it + 1] = g_new
    rnorm = abs(g_new)
    it += 1
    itc += 1
    state = kc.RUNNING
    if delta == 0.0:
        state = kc.DIVERGED_ITS
    if state == kc.RUNNING and rnorm <= max(npdt(rtol) * r0, npdt(atol)):
        state = kc.CONVERGED_ATOL if rnorm < npdt(atol) else \
            kc.CONVERGED_RTOL
    if state == kc.RUNNING and rnorm > npdt(dtol) * r0:
        state = kc.DIVERGED_DTOL
    if state == kc.RUNNING and happy:
        state = kc.CONVERGED_HAPPY
    if state == kc.RUNNING and itc >= max_it:
        state = kc.DIVERGED_ITS
    end = state != kc.RUNNING or it >= k
    y = y_scipy = None
    if end:
        y = np.where(np.arange(k) < it, g[:k], 0).astype(npdt)
        with np.errstate(invalid="ignore", divide="ignore"):
            for j in reversed(range(k)):
                d = H[j, j] if j < it else npdt(1)
                y[j] = y[j] / d
                for i in range(j):
                    y[i] = y[i] - H[i, j] * y[j]
        if np.all(np.diag(H[:it, :it]) != 0):
            y_scipy = scipy.linalg.solve_triangular(H[:it, :it], g[:it])
    return dict(H=H, g=g, cs=cs, sn=sn, rnorm=rnorm, state=state,
                it=-1 if end else it, itc=itc, y=y, y_scipy=y_scipy)


# (it, itc, h scale, tt, r0, rtol, atol, dtol, max_it) of recorded states:
# a plain step, a converged step, happy breakdown, delta == 0, a cycle end,
# max_it, dtol, atol
ARNOLDI_STATES = {
    "step": (3, 3, 1.0, 0.7, 10.0, 1e-5, 1e-50, 1e4, 10000),
    "rtol": (4, 9, 1.0, 1e-9, 1.0, 1e-3, 1e-50, 1e4, 10000),
    "happy": (2, 2, 1.0, 1e-31, 1.0, 1e-45, 1e-50, 1e4, 10000),
    "delta0": (0, 0, 0.0, 0.0, 1.0, 1e-30, 1e-50, 1e4, 10000),
    "cycle_end": (5, 11, 1.0, 0.3, 100.0, 1e-12, 1e-50, 1e4, 10000),
    "max_it": (2, 6, 1.0, 0.3, 100.0, 1e-12, 1e-50, 1e4, 7),
    "dtol": (1, 1, 1.0, 0.5, 1e-3, 1e-12, 1e-50, 1.0, 10000),
    "atol": (3, 3, 1.0, 1e-12, 1.0, 1e-30, 1e-3, 1e4, 10000),
}


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("name", list(ARNOLDI_STATES))
def test_arnoldi_twin_matches_host_arithmetic(name, dt):
    """Bitwise the host loop's numpy arithmetic (y in the kernel's order;
    scipy's y to 1e-5 / 1e-12 relative)."""
    it, itc, hs, tt, r0, rtol, atol, dtol, max_it = ARNOLDI_STATES[name]
    k = 6
    npdt = DT[dt][2]
    rng = np.random.default_rng(len(name))
    S = _State(k, 16, dt, rng, it, itc, r0, [rtol, atol, dtol], max_it,
               git=0.5 if name == "happy" else None)
    h = (hs * rng.standard_normal(k + 1)).astype(npdt)
    h[it + 1:] = 0
    if name in ("rtol", "atol", "happy"):
        h[it] = 3.0         # a well-scaled column: the tiny tt decides
    want = _host_arnoldi(npdt, S.np, h, npdt(tt), it, itc, npdt(r0), rtol,
                         atol, dtol, max_it, k)
    ctl = graphs.Control("cpu")
    kc.fgmres_arnoldi_ctl(S, torch.as_tensor(h), torch.tensor(tt,
                          dtype=S.H.dtype), ctl)
    for key in ("H", "g", "cs", "sn"):
        assert np.array_equal(getattr(S, key).numpy(), want[key]), key
    assert S.sc[1].item() == want["rnorm"]
    assert S.ints.tolist() == [want["state"], want["it"], want["itc"]]
    assert S.hist[min(want["itc"], 15)].item() == want["rnorm"]
    end = want["it"] < 0
    run = want["state"] == kc.RUNNING
    assert ctl.pred[:4].tolist() == [run, run and end, run and not end, end]
    assert ctl.counts[2].item() == 1 and ctl.counts[3].item() == end
    if end:
        n = it + 1
        # delta == 0 leaves a zero pivot: NaN in both, in the same places
        assert np.array_equal(S.y.numpy(), want["y"], equal_nan=True)
        if want["y_scipy"] is not None:
            assert _rel(S.y.numpy()[:n], want["y_scipy"]) <= (
                1e-5 if dt == "f32" else 1e-12)
        assert np.all(S.y.numpy()[n:] == 0)


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("beta,itc,par", [
    (2.5, 0, [1e-5, 1e-50, 1e4]), (0.0, 0, [1e-5, 1e-50, 1e4]),
    (1e-7, 30, [1e-5, 1e-50, 1e4]), (7.0, 30, [1e-5, 1e-50, 2.0]),
    (1e-9, 12, [1e-30, 1e-6, 1e4])],
    ids=["first", "zero", "rtol", "dtol", "atol"])
def test_start_twin_matches_host_arithmetic(beta, itc, par, dt):
    npdt = DT[dt][2]
    r0 = npdt(3.0)
    S = _State(6, 16, dt, np.random.default_rng(5), 3, itc, r0, par)
    ctl = graphs.Control("cpu")
    kc.fgmres_start_ctl(1, S, torch.tensor(beta, dtype=S.H.dtype), ctl)
    # treeops.make_fgmres's cycle start
    b = npdt(beta)
    r0w = b if itc == 0 else r0
    safe = b if b != 0.0 else npdt(1)
    state = kc.CONVERGED_ATOL if b == 0.0 else kc.RUNNING
    rtol, atol, dtol = (npdt(p) for p in par)
    if state == kc.RUNNING and b <= max(rtol * r0w, atol):
        state = kc.CONVERGED_ATOL if b < atol else kc.CONVERGED_RTOL
    if state == kc.RUNNING and b > dtol * r0w:
        state = kc.DIVERGED_DTOL
    assert S.sc.tolist() == [r0w, b, npdt(1.0) / safe]
    assert S.ints.tolist() == [state, 0, itc]
    assert S.hist[min(itc, 15)].item() == b
    assert np.all(S.H.numpy() == 0) and S.g[0].item() == b
    assert not S.g[1:].any() and not S.cs.any() and not S.sn.any()
    run = state == kc.RUNNING
    assert ctl.pred[:4].tolist() == [run, 0, run, 0]
    kc.fgmres_start_ctl(0, S, S.sc, ctl)
    assert S.ints.tolist() == [kc.RUNNING, -1, 0]
    assert ctl.pred[:4].tolist() == [1, 1, 0, 0]
    assert (S.hist == -1).all()
    assert ctl.counts[:2].tolist() == [1, 1]


class _GcrState:
    def __init__(self, dtype, restart, max_it, rtol, atol):
        self.sc = torch.zeros(3, dtype=dtype)
        self.par = torch.tensor([rtol, atol], dtype=dtype)
        self.ints = torch.zeros(3, dtype=torch.int32)
        self.ix = torch.zeros(1, dtype=torch.int64)
        self.restart, self.max_it, self.p, self.c0 = restart, max_it, 0, 0


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_gcr_twin_matches_host_arithmetic(dt):
    """treeops.make_gcr's scalar tail over a recorded residual sequence:
    target, the nv wrap, rtol, max_it and alpha == 0, step by step."""
    tdt, _, npdt = DT[dt]
    rtol, atol, restart, max_it = 1e-2, 1e-50, 3, 6
    S = _GcrState(tdt, restart, max_it, rtol, atol)
    ctl = graphs.Control("cpu")
    rn0 = npdt(4.0)
    kc.gcr_ctl(0, S, None, torch.tensor(rn0, dtype=tdt), ctl)
    target = max(npdt(rtol) * rn0, npdt(atol))
    assert S.sc.tolist() == [rn0, target, rn0]
    rns = [2.0, 1.0, 0.5, 0.3, 0.2, 0.1]
    nv = its = 0
    for rn in rns:
        kc.gcr_ctl(1, S, torch.tensor(1.0, dtype=tdt),
                   torch.tensor(rn, dtype=tdt), ctl)
        its += 1
        nv = 0 if nv + 1 >= restart else nv + 1
        state = kc.CONVERGED_RTOL if npdt(rn) <= target else kc.RUNNING
        if state == kc.RUNNING and its >= max_it:
            state = kc.DIVERGED_ITS
        assert S.ints.tolist() == [state, nv, its]
        assert S.ix.item() == nv
        assert ctl.pred[0].item() == (state == kc.RUNNING)
    kc.gcr_ctl(0, S, None, torch.tensor(rn0, dtype=tdt), ctl)
    kc.gcr_ctl(1, S, torch.tensor(0.0, dtype=tdt),
               torch.tensor(3.0, dtype=tdt), ctl)
    assert S.ints[0].item() == kc.DIVERGED_ITS
    kc.gcr_ctl(0, S, None, torch.tensor(0.0, dtype=tdt), ctl)
    assert S.ints[0].item() == kc.CONVERGED_ATOL and ctl.pred[0] == 0
    assert ctl.counts[:2].tolist() == [3, len(rns) + 1]


def test_ir_twin_matches_host_rounds():
    """abf.make_ir_solver's round logic (accept, history, done, stalled,
    the n_rounds bound) over a recorded residual sequence."""
    ctl = graphs.Control("cpu")
    st = tabf.DeviceIR(ctl, 4, "cpu", max_rounds=10)
    fg_ints = torch.tensor([kc.CONVERGED_RTOL, -1, 0], dtype=torch.int32)
    rtol, rn0 = 1e-8, 2.0
    st.sc[2], st.sc[3] = rtol, 3
    kc.ir_ctl(0, st, torch.tensor(rn0, dtype=torch.float64), fg_ints, ctl)
    assert ctl.pred[st.p] == 1 and st.hist[0] == rn0
    assert (st.hist[1:] == -1).all()
    rounds = inner = 0
    rnorm = rn0
    history = [rn0]
    for rn, its, state in [(1e-4, 7, kc.CONVERGED_RTOL),
                           (1e-6, 5, kc.DIVERGED_ITS)]:
        fg_ints[0], fg_ints[2] = state, its
        kc.ir_ctl(1, st, torch.tensor(rn, dtype=torch.float64), fg_ints,
                  ctl)
        rounds += 1
        inner += its
        accept = state >= 0 and rn < rnorm
        if accept:
            rnorm = rn
            history.append(rn)
        stalled = not accept
        done = stalled or rnorm <= rtol * rn0
        assert st.ints.tolist() == [rounds, inner, done, stalled, accept]
        assert st.sc[1].item() == rnorm
        assert ctl.pred[st.p].item() == (not done and rounds < 3)
    assert [h for h in st.hist.tolist() if h >= 0] == history
    # the bound: n_rounds rounds, none converged
    kc.ir_ctl(0, st, torch.tensor(rn0, dtype=torch.float64), fg_ints, ctl)
    fg_ints[0] = kc.CONVERGED_RTOL
    for r, rn in enumerate([1.0, 0.5, 0.25]):
        kc.ir_ctl(1, st, torch.tensor(rn, dtype=torch.float64), fg_ints,
                  ctl)
        assert ctl.pred[st.p].item() == (r < 2)
    st.sc[3] = 0
    kc.ir_ctl(0, st, torch.tensor(rn0, dtype=torch.float64), fg_ints, ctl)
    assert ctl.pred[st.p] == 0


# --- the ABF solve ----------------------------------------------------------

def test_device_loop_solve_matches_jax():
    """float64 direct solve, 3D pseudoice mx=4, 3 levels: the JAX reason and
    iteration count, history and x to 1e-8 (test_torch_abf.py's TOL)."""
    jslv, F = _jax_solver(3, (4, 4, 4), (0.1, 1.0, 1.0), 11, nlevels=3)
    rj = jslv.solve(F)
    t = _from_jax(jslv, torch.float64)
    slv = tabf.ABFSolver.from_parts(t.cfg, t.data, t.setup, device="cpu",
                                    dtype=torch.float64, loop="device")
    assert slv.loop == "device" and t.loop == "host"
    rt = slv.solve(F)
    assert (rt["reason"], rt["its"]) == (rj["reason"], rj["its"])
    assert len(rt["history"]) == len(rj["history"])
    assert _rel(rt["history"], rj["history"]) < 1e-8
    assert _rel(rt["x"], rj["x"]) < 1e-8


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_device_loop_solve_ir_matches_jax(dt):
    """Iterative refinement (float64 residuals) around inner solves in the
    working dtype, mx=4, 3 levels, the solver built from the JAX build's
    numbers and from its own setup. float64 inner solves: the JAX rounds,
    inner iterations and stalled flag, history and x to 1e-8. float32:
    the JAX rounds and stalled flag, total inner iterations within 15% of
    JAX's (float32 dots summed in another order -- here over the whole
    masked window -- move the inner iterates, and the inner counts move by
    ~10% under 1e-7 perturbations, PERF.md; in one CPU run JAX took 3 / 50,
    the device loop 3 / 56 and the host loop 3 / 53), x to 1e-6; both
    converge."""
    tdt, jdt, _ = DT[dt]
    jslv, F = _jax_solver(3, (4, 4, 4), (0.1, 1.0, 1.0), 11, nlevels=3,
                          dtype=jdt, ir=True)
    rj = jslv.solve_ir(F, rtol=1e-8)
    assert rj["converged"] and not rj["stalled"]
    for tslv in (_from_jax(jslv, tdt, ir=True),
                 _own(3, (4, 4, 4), (0.1, 1.0, 1.0), 11, nlevels=3,
                      dtype=tdt, ir=True)[0]):
        slv = tabf.ABFSolver.from_parts(tslv.cfg, tslv.data, tslv.setup,
                                        device="cpu", dtype=tdt, ir=True,
                                        loop="device")
        rt = slv.solve_ir(F, rtol=1e-8)
        assert rt["converged"] and not rt["stalled"]
        assert rt["rounds"] == rj["rounds"]
        assert rt["x"].dtype == np.float64
        assert rt["history"][0] == pytest.approx(rj["history"][0],
                                                 rel=1e-12)
        if dt == "f64":
            assert rt["inner_its"] == rj["inner_its"]
            assert _rel(rt["history"], rj["history"]) < 1e-8
            assert _rel(rt["x"], rj["x"]) < 1e-8
        else:
            assert abs(rt["inner_its"] - rj["inner_its"]) <= \
                0.15 * rj["inner_its"]
            assert _rel(rt["x"], rj["x"]) < 1e-6


def test_device_loop_fixed_vcycles_matches_host_loop(monkeypatch):
    """u_fixed_vcycles=2 (no GCR loop: the fieldsplit PC is one piece),
    float64 direct, mx=4, 3 levels. On the torch build's numbers: the
    sliced host loop's (window=False, the CPU's default) reason and
    iteration count, and the host loop with the device loop's arithmetic
    (make_abf_solver window=True: the Gram-Schmidt twins over the live
    rows, the control kernels' triangle) bit for bit in reason,
    iterations, history and x, torch.sqrt correctly rounded as in
    test_window_host_loop_equals_device_loop. The sliced host loop sums
    its dots in BLAS's order, the device loop in the Gram-Schmidt
    kernels' blocked order, so their x agree only to rounding amplified
    over the 52 iterations (4.0e-8 relative, history 9.0e-8, in one CPU
    run). So x is held to an independent computation, the JAX package's
    solve on its own build, with the device loop built from the JAX
    build's numbers: the JAX reason and first residual norm (1e-12),
    iterations within 5% (this configuration takes 54 in JAX and 52 in
    both torch loops) and x to 1e-4 (7.6e-6 for both torch loops in one
    CPU run)."""
    monkeypatch.setattr(torch, "sqrt", _ieee_sqrt)
    p = bench._build_problem(4, with_rhs=True)
    host = tabf.ABFSolver(p["mesh"], p["fes"], p["coeff"], p["bc_idx"],
                          p["bc_vals"], device="cpu", nlevels=3,
                          u_fixed_vcycles=2)
    dev = tabf.ABFSolver.from_parts(host.cfg, host.data, host.setup,
                                    device="cpu", dtype=torch.float64,
                                    loop="device")
    F = p["F_raw"] + host.setup["rhs_diri"]
    rh, rd = host.solve(F), dev.solve(F)
    assert (rd["reason"], rd["its"]) == (rh["reason"], rh["its"])
    solve, _ = tabf.make_abf_solver(host.cfg, host.data, window=True)
    Ft = host.vec_to_tree(F)
    x, its, _, state, hist = solve(Ft, torch.zeros_like(Ft))
    assert (treeops.reason_name(state), its) == (rd["reason"], rd["its"])
    assert [float(h) for h in hist[: its + 1] if h >= 0.0] == rd["history"]
    assert np.array_equal(host.tree_to_vec(x), rd["x"])

    jslv, Fj = _jax_solver(3, (4, 4, 4), (0.1, 1.0, 1.0), 11, nlevels=3,
                           u_fixed_vcycles=2)
    rj = jslv.solve(Fj)
    t = _from_jax(jslv, torch.float64)
    rt = tabf.ABFSolver.from_parts(t.cfg, t.data, t.setup, device="cpu",
                                   dtype=torch.float64,
                                   loop="device").solve(Fj)
    assert rt["reason"] == rj["reason"] == "CONVERGED_RTOL"
    assert abs(rt["its"] - rj["its"]) <= 0.05 * rj["its"]
    assert rt["history"][0] == pytest.approx(rj["history"][0], rel=1e-12)
    assert _rel(rt["x"], rj["x"]) < 1e-4


def _ieee_sqrt(t):
    """torch.sqrt correctly rounded on the CPU, as numpy's and CUDA's are
    (this build's vectorised CPU sqrt is not: it returns
    0.7183630846541311 for sqrt(0.5160455213937984), where the correctly
    rounded root is 0.7183630846541312)."""
    return torch.as_tensor(np.sqrt(t.detach().cpu().numpy()),
                           device=t.device)


@pytest.mark.parametrize("schedule", ["abfopts", "fixed3"])
def test_window_host_loop_equals_device_loop(schedule, monkeypatch):
    """float32 IR at mx=4, 3 levels: make_abf_solver(window=True) under
    make_ir_solver (the host loop, reading its scalars on the host) against
    DeviceLoopSolver's plain driver over one setup: x, history, rounds and
    inner iterations bit for bit, under the GCR u-block (abf.opts) and
    under 3 fixed V-cycles. torch.sqrt is made correctly rounded for the
    test, since the host loop's Givens roots are numpy's and the control
    twins' are torch's (CUDA's sqrt is correctly rounded, as are the
    kernels' __fsqrt_rn and __dsqrt_rn). The sliced host loop (window=False,
    the CPU's default) differs: here fixed3 takes 3 / 111 against the
    device loop's 2 / 69 in one CPU run."""
    monkeypatch.setattr(torch, "sqrt", _ieee_sqrt)
    p = bench._build_problem(4, with_rhs=True)
    kw = {"u_fixed_vcycles": 3} if schedule == "fixed3" else {}
    slv = tabf.ABFSolver(p["mesh"], p["fes"], p["coeff"], p["bc_idx"],
                         p["bc_vals"], device="cpu", nlevels=3,
                         dtype=torch.float32, ir=True, **kw)
    op64, aux64 = slv.setup["op64"], slv.setup["aux64"]
    F64 = slv.vec_to_tree(p["F_raw"] + slv.setup["rhs_diri"],
                          dtype=torch.float64)
    solve, _ = tabf.make_abf_solver(slv.cfg, slv.data, window=True)
    x64, rounds, inner, _, _, hist, stalled = tabf.make_ir_solver(
        solve, torch.float32)(op64, aux64, F64, 1e-8, 10)
    dev = tabf.DeviceLoopSolver(
        slv.cfg, tabf._plain_bodies(slv.cfg, slv.data), slv.data["op"].ndof,
        torch.float32, "cpu", graph=False, ir_ops=(op64, aux64))
    xd, rd, innerd, _, _, histd, stalledd, _ = dev.solve_ir(
        F64.numpy(), 1e-8, 10)
    assert not stalled and not stalledd
    assert (rounds, int(inner)) == (rd, innerd)
    assert hist == histd
    assert np.array_equal(x64.numpy(), xd)


# --- the plain driver reads only the predicates -----------------------------

HOST_READS = ("item", "cpu", "numpy", "tolist", "__float__", "__bool__",
              "__int__", "__index__")


def test_plain_driver_reads_only_the_predicates(monkeypatch):
    """A float32 IR solve by the plain driver at mx=4 with every host read
    of a tensor patched to raise unless it reads Control.pred: it runs to
    the result of the unpatched solve, and the reads it makes are loop
    tests, one per Control.read."""
    p = bench._build_problem(4, with_rhs=True)
    slv = tabf.ABFSolver(p["mesh"], p["fes"], p["coeff"], p["bc_idx"],
                         p["bc_vals"], device="cpu", nlevels=3,
                         dtype=torch.float32, ir=True, loop="device")
    F = p["F_raw"] + slv.setup["rhs_diri"]
    want = slv.solve_ir(F, rtol=1e-8)
    dev = slv._dev
    pred = dev.ctl.pred
    reads, tests = [], []
    orig_read = graphs.Control.read

    def counted(self, slot):
        tests.append(slot)
        return orig_read(self, slot)

    def guard(name):
        orig = getattr(torch.Tensor, name)

        def f(self, *a, **k):
            if self._base is pred or self is pred:
                reads.append(name)
                return orig(self, *a, **k)
            raise AssertionError(f"host read ({name}) in the solve")
        return f

    monkeypatch.setattr(graphs.Control, "read", counted)
    run = dev._run

    def patched_run(*arrays, ir=False):
        assert ir
        dev.stage(*arrays, ir=ir)
        with monkeypatch.context() as m:
            for attr in HOST_READS:
                m.setattr(torch.Tensor, attr, guard(attr))
            graphs.run_plain(dev.items, dev.ctl)
        return dev.out.numpy().copy()

    monkeypatch.setattr(dev, "_run", patched_run)
    got = slv.solve_ir(F, rtol=1e-8)
    monkeypatch.setattr(dev, "_run", run)
    assert np.array_equal(got["x"], want["x"])
    assert got["history"] == want["history"]
    assert (got["rounds"], got["inner_its"]) == (want["rounds"],
                                                 want["inner_its"])
    assert len(reads) == len(tests) > 0
    assert set(reads) == {"__bool__"}
    # the direct solve of an ir=True solver (its own ends around the one
    # FGMRES loop): the bits of an ir=False solver over the same setup,
    # and a refinement after it gives the first one's bits again
    direct = tabf.ABFSolver.from_parts(slv.cfg, slv.data, slv.setup,
                                       device="cpu", dtype=torch.float32,
                                       loop="device")
    a, b = slv.solve(F), direct.solve(F)
    assert (a["its"], a["reason"]) == (b["its"], b["reason"])
    assert np.array_equal(a["x"], b["x"]) and a["history"] == b["history"]
    again = slv.solve_ir(F, rtol=1e-8)
    assert np.array_equal(again["x"], want["x"])
    assert again["history"] == want["history"]


def test_loop_option_and_defaults():
    """loop defaults to "host" on the CPU, and to it under eager=True;
    "device" and "plain" on the CPU both run the plain driver; eager=True
    with a loop other than "host", and an unknown loop, raise; a
    ControlGraph refuses the CPU."""
    p = bench._build_problem(4)
    slv = tabf.ABFSolver(p["mesh"], p["fes"], p["coeff"], p["bc_idx"],
                         p["bc_vals"], device="cpu", nlevels=3)
    assert slv.loop == "host"
    assert tabf.ABFSolver.from_parts(
        slv.cfg, slv.data, slv.setup, device="cpu", dtype=torch.float64,
        eager=True).loop == "host"
    for loop in ("device", "plain"):
        s = tabf.ABFSolver.from_parts(slv.cfg, slv.data, slv.setup,
                                      device="cpu", dtype=torch.float64,
                                      loop=loop)
        assert s.loop == loop and s._dev.graph is None
        with pytest.raises(ValueError, match="eager"):
            tabf.ABFSolver.from_parts(slv.cfg, slv.data, slv.setup,
                                      device="cpu", dtype=torch.float64,
                                      eager=True, loop=loop)
    with pytest.raises(ValueError):
        tabf.ABFSolver.from_parts(slv.cfg, slv.data, slv.setup,
                                  device="cpu", dtype=torch.float64,
                                  loop="graph")
    ctl = graphs.Control("cpu")
    with pytest.raises(ValueError):
        graphs.ControlGraph([graphs.Piece(lambda: None, "noop")], ctl)
    fixed = dataclasses.replace(slv.cfg, u_fixed_vcycles=1)
    d = tabf.DeviceLoopSolver(fixed, tabf._plain_bodies(fixed, slv.data),
                              slv.data["op"].ndof, torch.float64, "cpu",
                              graph=False)
    assert d.gcr is None and d.graph is None
