"""Krylov kernels of the ABF solve, in PyTorch: FGMRES, GCR and the PETSc
Chebyshev recurrence, with the exact semantics of exsaddle_tpu/treeops.py.

Vectors are plain tensors (the flat parity-layout vectors of matfree.py, or
grid tensors on the stencil levels) or, in the sharded layouts of parallel/,
ShardVecs: one tensor per shard. Krylov bases are (k, n) buffers (one per
shard), so the classical Gram-Schmidt reduction is one matrix-vector product
per shard. The reductions come from a `make_dots` pair: plain dots on one
device, ownership-weighted per-shard dots summed by the mesh's psum in a
sharded layout.

PETSc's algorithmic choices are kept so iteration counts line up with the
JAX package: classical (unmodified) Gram-Schmidt, Givens residual
recurrence, right preconditioning with unpreconditioned norms,
KSPConvergedDefault (rtol/abstol/dtol, DIVERGED_ITS at max_it), happy
breakdown at min(|tt / g_it|, 1e-30), truncated GCR restart.

Two forms of the loops:

- make_gcr / make_fgmres (host loop control): each GCR or FGMRES iteration
  brings its few scalars to the host once (one device synchronisation)
  and the Python loop decides. The small Givens/Hessenberg arithmetic runs
  on the host in the working dtype (numpy float32/float64 scalars). The
  preconditioners they call may be CUDA graph replays (graphs.Captured);
  cheb_smooth stays host-read-free for that. The sharded solvers of
  parallel/ and the ABF solve's loop="host" use them; window=True gives
  them the device loop's arithmetic, so the two forms agree bit for bit.
  host_window states where the solvers take it.
- DeviceGCR / DeviceFGMRES (device loop control), the JAX formulation:
  a fixed-shape state of device tensors, masked Gram-Schmidt over the
  whole window (buf_dots/buf_comb, exsaddle_tpu/treeops.py:106-133), basis
  writes at a device index, and step functions that end in a Krylov
  control kernel (kernels/krylov_ctl.py) which updates the scalars and
  writes the loop predicates. Their loops are graphs.Loop items: one CUDA
  graph with conditional nodes on the card (graphs.ControlGraph), or
  graphs.run_plain, which reads only the predicates. In a sharded layout
  the vectors and windows are ShardVecs and the control state is single."""

import numpy as np
import scipy.linalg
import torch

from exsaddle_tpu_torch.graphs import Loop, Piece, run_plain
from exsaddle_tpu_torch.kernels import cheb
from exsaddle_tpu_torch.kernels import krylov_ctl
from exsaddle_tpu_torch.trace import span
# state codes (sign convention matches PETSc: >0 converged, <0 diverged)
from exsaddle_tpu_torch.kernels.krylov_ctl import (  # noqa: F401
    CONVERGED_ATOL, CONVERGED_HAPPY, CONVERGED_RTOL, DIVERGED_DTOL,
    DIVERGED_ITS, RUNNING)

NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def reason_name(state):
    """PETSc-style reason string for a solver state code."""
    return {CONVERGED_RTOL: "CONVERGED_RTOL",
            CONVERGED_ATOL: "CONVERGED_ATOL",
            CONVERGED_HAPPY: "CONVERGED_HAPPY_BREAKDOWN",
            DIVERGED_ITS: "DIVERGED_ITS",
            DIVERGED_DTOL: "DIVERGED_DTOL"}.get(int(state),
                                                str(int(state)))


def np_dtype(t):
    """numpy scalar type of a tensor's dtype."""
    return NP_DTYPE[t.dtype]


class ShardVec:
    """A sharded vector: one tensor per shard (`parts`), each on its shard's
    device. Arithmetic, indexing and `@` act shard by shard: a ShardVec
    operand pairs up part for part, anything else (a number, a 0-d tensor on
    the right device) is used as it is for every part. A replicated value,
    such as the sum a psum returns, is a ShardVec whose parts are copies, one
    object per distinct device."""

    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = tuple(parts)

    def map(self, fn, *others):
        """ShardVec of fn(part, other parts...), ShardVec others paired."""
        return ShardVec(fn(*a) for a in _zip_args((self,) + others))

    def __add__(self, o):
        return self.map(lambda a, b: a + b, o)

    def __radd__(self, o):
        return self.map(lambda a, b: b + a, o)

    def __sub__(self, o):
        return self.map(lambda a, b: a - b, o)

    def __rsub__(self, o):
        return self.map(lambda a, b: b - a, o)

    def __mul__(self, o):
        return self.map(lambda a, b: a * b, o)

    def __rmul__(self, o):
        return self.map(lambda a, b: b * a, o)

    def __truediv__(self, o):
        return self.map(lambda a, b: a / b, o)

    def __rtruediv__(self, o):
        return self.map(lambda a, b: b / a, o)

    def __matmul__(self, o):
        return self.map(lambda a, b: a @ b, o)

    def __rmatmul__(self, o):
        return self.map(lambda a, b: b @ a, o)

    def __neg__(self):
        return self.map(lambda a: -a)

    def __getitem__(self, idx):
        return self.map(lambda a: a[idx])

    def __setitem__(self, idx, value):
        for a, v in _zip_args((self, value)):
            a[idx] = v

    # in place, shard by shard (the static buffers of the device loops)
    def _each(self, name, *args):
        for a in _zip_args((self,) + args):
            getattr(a[0], name)(*a[1:])
        return self

    def zero_(self):
        return self._each("zero_")

    def copy_(self, src):
        return self._each("copy_", src)

    def add_(self, o):
        return self._each("add_", o)

    def index_copy_(self, dim, index, src):
        return self._each("index_copy_", dim, index, src)

    def index_select(self, dim, index):
        return self.map(lambda a: a.index_select(dim, index))

    @property
    def dtype(self):
        return self.parts[0].dtype


def _zip_args(args):
    """Per-shard argument tuples: ShardVec arguments give their parts in
    order, any other argument repeats."""
    n = next(len(a.parts) for a in args if isinstance(a, ShardVec))
    return zip(*[a.parts if isinstance(a, ShardVec) else (a,) * n
                 for a in args])


def smap(fn, *args):
    """fn(*args), shard by shard when any argument is a ShardVec. A tuple
    result comes back as a tuple of ShardVecs."""
    if not any(isinstance(a, ShardVec) for a in args):
        return fn(*args)
    outs = [fn(*a) for a in _zip_args(args)]
    if isinstance(outs[0], tuple):
        return tuple(ShardVec(o) for o in zip(*outs))
    return ShardVec(outs)


def first(t):
    """The tensor a host read takes: t itself, or shard 0's part (of a
    replicated value, every part holds the same numbers)."""
    return t.parts[0] if isinstance(t, ShardVec) else t


def tdot(a, b):
    """Global dot product (0-d tensor on the vectors' device)."""
    return torch.dot(a.reshape(-1), b.reshape(-1))


def tnorm(a):
    return torch.sqrt(tdot(a, a))


def _bdots(V, t):
    return V @ t


def make_dots(weight=None, psum=None):
    """(dot, bdots) pair for make_gcr / make_fgmres / compiled cycles:
    dot(a, b) and bdots(V, t) = the dots of the rows of the basis V with t.

    Default: plain tensors on one device. weight: ShardVec of per-entry
    ownership weights -- with interface planes stored on both neighbours,
    the duplicate copies weigh 0 so every dof counts once; it multiplies
    the first argument of dot and the vector t of bdots, never the basis.
    psum: the mesh's sum of per-shard partials (parallel.shard_mesh), which
    returns the replicated total."""
    if weight is None and psum is None:
        return tdot, _bdots

    def dot(a, b):
        aw = a if weight is None else weight * a
        s = smap(tdot, aw, b)
        return s if psum is None else psum(s)

    def bdots(V, t):
        tw = t if weight is None else weight * t
        s = V @ tw
        return s if psum is None else psum(s)

    return dot, bdots


def _masked(h, mask):
    """h (dots, or a ShardVec of them) times the window mask, formed on
    each part's own device: the sharded parts may sit on several cards
    while the mask is made on the first one's."""
    return smap(lambda t: t * mask.to(t.device, t.dtype), h)


def _safe(a):
    """a, with exact zeros replaced by 1 (a divisor that never branches)."""
    return torch.where(a == 0.0, torch.ones_like(a), a)


def _norm(dot, a):
    return smap(torch.sqrt, dot(a, a))


def _basis(t, k):
    """A zero (k, *t.shape) basis buffer on t's device (per shard)."""
    return smap(lambda a: torch.zeros((k,) + a.shape, dtype=a.dtype,
                                      device=a.device), t)


# --- Chebyshev smoother ------------------------------------------------------

def cheb_scale(emin, emax):
    """The Chebyshev smoother's first-step scale 2 / (emax + emin), a numpy
    scalar in the working dtype of the numpy scalars emin, emax: the value
    cheb_smooth steps with (the update kernels take it as a Python float)."""
    return 2.0 / (emax + emin)


def cheb_smooth(mult, pc_apply, emin, emax, its, b, x0, x0_zero=False,
                diag=None, p1=None):
    """KSPSolve_Chebyshev three-term recurrence with norm type NONE
    (abf.opts:8-12 smoother: fixed `its` applications, nonzero initial
    guess). emin/emax: numpy scalars of the working dtype (the scalar
    recurrence runs in that dtype); the coefficients are host numbers, so
    a CUDA graph capture bakes them in and the body reads nothing back.

    diag: the Jacobi preconditioner's inverse diagonal, a tensor of b's
    shape (a ShardVec of the parts' shapes in a sharded layout), in place
    of pc_apply (pass None): each step's vector update is then one
    kernels.cheb call per shard (K6: one kernel pass on CUDA, bitwise the
    ops of the callable path; those ops on the CPU).

    With diag given and `mult` an operator object with fused updates (one
    carrying cheb_first and cheb_step: kernels.stencil.StencilOp and the
    cart path's L-2 operator, K4 with K6's update in its store;
    kernels.a00.A00Op, K1 with the Dirichlet terms and the update in its
    loads and store; the cart path's fine operator, K1 with the keep in its
    loads, the halo, then K6's masked form), each apply and its update are
    one call of mult's fused form, bitwise the separate calls; a zero-guess
    first step, which applies nothing, stays K6.

    x0_zero=True asserts x0 is exactly zero and skips the initial
    r = b - A x0 apply (A 0 == 0 bitwise, so the result is identical with
    one fewer operator application).

    p1: the first iterate scale (d b) + x0, computed by the caller (only
    with x0_zero=True; x0 is still the zero that the second step reads as
    p_0): K5's restrict_grid_cheb_first computes it in the store of the
    restriction that made b, bitwise this function's first step, so the
    step launches nothing."""
    if p1 is not None and not x0_zero:
        raise ValueError("cheb_smooth: p1 is the zero-guess first iterate; "
                         "it needs x0_zero=True")
    scale = cheb_scale(emin, emax)
    alpha_ = 1.0 - scale * emin
    mu = 1.0 / alpha_
    omegaprod = 2.0 / alpha_

    if diag is None:
        def first(x0):
            r = b if x0_zero else b - mult(x0)
            return float(scale) * pc_apply(r) + x0

        def step(p_k, p_km1, omega):
            z = pc_apply(b - mult(p_k))
            # p_kp1 = omega (p_k + scale z - p_km1) + p_km1
            t = float(scale) * z + p_k
            return omega * (t - p_km1) + p_km1
    elif hasattr(mult, "cheb_step"):
        def first(x0):
            if x0_zero:
                return smap(lambda b_, d, x: cheb.cheb_first(
                    b_, None, d, x, float(scale)), b, diag, x0)
            return mult.cheb_first(b, x0, diag, float(scale))

        def step(p_k, p_km1, omega):
            return mult.cheb_step(b, p_k, p_km1, diag, float(scale), omega)
    else:
        def first(x0):
            ax0 = None if x0_zero else mult(x0)
            return smap(lambda b_, a, d, x: cheb.cheb_first(
                b_, a, d, x, float(scale)), b, ax0, diag, x0)

        def step(p_k, p_km1, omega):
            return smap(lambda b_, a, d, p, q: cheb.cheb_step(
                b_, a, d, p, q, float(scale), omega), b, mult(p_k), diag,
                p_k, p_km1)

    p_k = first(x0) if p1 is None else p1
    p_km1 = x0
    c_km1 = mu / mu
    c_k = mu * c_km1
    for _ in range(1, its):
        c_kp1 = 2.0 * mu * c_k - c_km1
        omega = float(omegaprod * c_k / c_kp1)
        p_kp1 = step(p_k, p_km1, omega)
        p_km1, p_k, c_km1, c_k = p_k, p_kp1, c_k, c_kp1
    return p_k


# --- GCR ---------------------------------------------------------------------

def host_window(device, sharded=False):
    """Whether a solver's host loop (make_gcr / make_fgmres) takes the
    device loop's window arithmetic (window=True), so that it gives
    DeviceGCR's / DeviceFGMRES's bits: on CUDA always, and in a sharded
    layout on every device. Only the single-device CPU host loop keeps the
    sliced form, whose bits test_cpu_ir_solve_bitwise_unchanged pins. The
    sharded host loop has no such pin: its CPU tests and its gloo groups
    are held bit for bit against the plain device-loop driver (one host
    read per loop test), which exists on every device."""
    return sharded or torch.device(device).type == "cuda"


def make_gcr(mult, pc_apply, restart=30, rtol=1e-2, atol=1e-50,
             max_it=200, dots=None, window=False):
    """KSPGCR: right-preconditioned, unpreconditioned norm, truncated
    restart (gcr.c semantics as in exsaddle_tpu/treeops.make_gcr).
    dots: optional (dot, bdots) pair from make_dots (sharded layouts).
    window=True: project against the whole window with the unused rows
    masked, as DeviceGCR does, so the two loops round alike (plain
    tensors and ShardVecs); False projects against the live rows only.
    Returns solve(b) -> (x, its, rnorm). Zero initial guess."""
    dot, bdots = dots if dots is not None else make_dots()

    def solve(b):
        npdt = np_dtype(b)
        x = smap(torch.zeros_like, b)
        r = smap(torch.clone, b)
        rnorm0 = npdt(first(_norm(dot, r)).item())
        V = _basis(b, restart)
        S = _basis(b, restart)
        ar = torch.arange(restart, device=first(b).device) if window \
            else None
        target = max(npdt(rtol) * rnorm0, npdt(atol))
        state = CONVERGED_ATOL if rnorm0 <= npdt(atol) else RUNNING
        nv = 0
        its = 0
        rnorm = rnorm0
        while state == RUNNING:
            s = pc_apply(r)
            v = mult(s)
            if window:
                beta = _masked(bdots(V, v), ar < nv)
                v = v - beta @ V
                s = s - beta @ S
            elif nv > 0:
                beta = bdots(V[:nv], v)
                v = v - beta @ V[:nv]
                s = s - beta @ S[:nv]
            alpha = _norm(dot, v)
            inv = 1.0 / smap(_safe, alpha)
            v = inv * v
            s = inv * s
            V[nv] = v
            S[nv] = s
            gamma = dot(r, v)
            x = gamma * s + x
            r = -gamma * v + r
            rn = _norm(dot, r)
            alpha_h, rn_h = torch.stack([first(alpha),
                                         first(rn)]).cpu().numpy()
            rnorm = npdt(rn_h)
            its += 1
            nv = 0 if nv + 1 >= restart else nv + 1
            if rnorm <= target:
                state = CONVERGED_RTOL
            if state == RUNNING and its >= max_it:
                state = DIVERGED_ITS
            if alpha_h == 0.0:
                state = DIVERGED_ITS
        return x, its, rnorm

    return solve


# --- FGMRES ------------------------------------------------------------------

def make_fgmres(mult, pc_apply, restart=30, rtol=1e-5, atol=1e-50,
                dtol=1e4, max_it=10000, hist_len=None, dots=None,
                window=False):
    """KSPFGMRES: right preconditioning, classical Gram-Schmidt, Givens
    recurrence, unpreconditioned norm, KSPConvergedDefault, restarts with
    the solution built at each cycle end (BuildGmresSoln).
    dots: optional (dot, bdots) pair from make_dots (sharded layouts).
    window=True: DeviceFGMRES's arithmetic (plain tensors and ShardVecs) --
    dots against the whole basis with the unused rows masked, the
    triangle solved in krylov_ctl's order and the correction summed over
    the whole Z -- so the host loop rounds as the device loop does; False
    works on the live rows and solves the triangle with scipy.

    Returns solve(F, x0) -> (x, its, rnorm, state, hist); hist[i] is the
    residual at iteration i (the -ksp_monitor_short values), length
    hist_len (default max_it+1); entries never reached hold -1."""
    if hist_len is None:
        hist_len = max_it + 1
    dot, bdots = dots if dots is not None else make_dots()
    k = restart

    def solve(F, x0):
        npdt = np_dtype(F)
        x = smap(torch.clone, x0)
        V = _basis(F, k + 1)
        Z = _basis(F, k)
        ar = torch.arange(k + 1, device=first(F).device) if window \
            else None
        H = np.zeros((k + 1, k), npdt)
        g = np.zeros(k + 1, npdt)
        cs = np.zeros(k, npdt)
        sn = np.zeros(k, npdt)
        hist = np.full(hist_len, -1.0, npdt)
        state = RUNNING
        it = -1
        itc = 0
        r0 = npdt(0)
        rnorm = npdt(0)
        lim_atol = npdt(atol)

        def test(state, rnorm):
            if state == RUNNING and rnorm <= max(npdt(rtol) * r0, lim_atol):
                state = CONVERGED_ATOL if rnorm < lim_atol else CONVERGED_RTOL
            if state == RUNNING and rnorm > npdt(dtol) * r0:
                state = DIVERGED_DTOL
            return state

        while state == RUNNING:
            if it < 0:
                # cycle start: true residual of the current iterate
                r = F - mult(x)
                beta = npdt(first(_norm(dot, r)).item())
                rnorm = beta
                hist[min(itc, hist_len - 1)] = rnorm
                if itc == 0:
                    r0 = beta
                safe = beta if beta != 0.0 else npdt(1)
                if window:
                    V.zero_()
                V[0] = float(1.0 / safe) * r
                H[:] = 0
                g[:] = 0
                g[0] = beta
                cs[:] = 0
                sn[:] = 0
                if beta == 0.0:
                    state = CONVERGED_ATOL
                state = test(state, rnorm)
                it = 0
                continue
            # Arnoldi step
            z = pc_apply(V[it])
            w = mult(z)
            Z[it] = z
            if window:
                h_t = _masked(bdots(V, w), ar <= it)
                w = w - h_t @ V
                h_t = h_t[: it + 1]
            else:
                h_t = bdots(V[: it + 1], w)
                w = w - h_t @ V[: it + 1]
            tt_t = _norm(dot, w)
            V[it + 1] = (1.0 / smap(_safe, tt_t)) * w
            hv = torch.cat([first(h_t), first(tt_t).reshape(1)]).cpu().numpy()
            h, tt = hv[:-1], hv[-1]
            git = g[it]
            hapbnd = min(abs(tt / (git if git != 0.0 else npdt(1))),
                         npdt(1e-30))
            happy = tt <= hapbnd
            hcol = np.zeros(k + 1, npdt)
            hcol[: it + 1] = h
            hcol[it + 1] = tt
            # apply previous rotations to the new column
            for i in range(it):
                t1, t2 = hcol[i], hcol[i + 1]
                hcol[i] = cs[i] * t1 + sn[i] * t2
                hcol[i + 1] = -sn[i] * t1 + cs[i] * t2
            h_it, h_it1 = hcol[it], hcol[it + 1]
            delta = np.sqrt(h_it * h_it + h_it1 * h_it1)
            safe_d = delta if delta != 0.0 else npdt(1)
            c_new = h_it / safe_d
            s_new = h_it1 / safe_d
            cs[it] = c_new
            sn[it] = s_new
            hcol[it] = delta
            hcol[it + 1] = 0
            H[:, it] = hcol
            g_new = -s_new * git
            g[it] = c_new * git
            g[it + 1] = g_new
            rnorm = abs(g_new)
            it += 1
            itc += 1
            hist[min(itc, hist_len - 1)] = rnorm
            if delta == 0.0:
                state = DIVERGED_ITS
            state = test(state, rnorm)
            if state == RUNNING and happy:
                state = CONVERGED_HAPPY
            if state == RUNNING and itc >= max_it:
                state = DIVERGED_ITS
            if state != RUNNING or it >= k:
                # end of cycle: x += Z y with y from the rotated triangle
                if window:
                    y = krylov_ctl._back_substitute(torch.from_numpy(H),
                                                    torch.from_numpy(g),
                                                    it, k)
                    x = x + smap(lambda f: y.to(f.device), F) @ Z
                else:
                    y = scipy.linalg.solve_triangular(H[:it, :it], g[:it],
                                                      lower=False)
                    yt = smap(lambda f: torch.as_tensor(y.astype(npdt),
                                                        device=f.device), F)
                    x = x + yt @ Z[:it]
                it = -1
        return x, itc, rnorm, state, hist

    return solve


# --- device loop control ------------------------------------------------------

def _zeros(device, dtype, *shape):
    return torch.zeros(shape, dtype=dtype, device=device)


def _vec(device, dtype, *shape):
    """A zero vector buffer: a tensor on `device`, or, where `device` is a
    sequence of devices (one per shard), a ShardVec of one per shard."""
    if isinstance(device, (list, tuple)):
        return ShardVec(_zeros(d, dtype, *shape) for d in device)
    return _zeros(device, dtype, *shape)


class DeviceGCR:
    """GCR (make_gcr's semantics; the JAX make_gcr's while loop) over a
    fixed-shape device state: x, r, the (restart, n) windows V and S, and
    the control state of kernels/krylov_ctl.gcr_ctl. start(b) is a piece
    (x = 0, r = b, ||b||, gcr_ctl mode 0); loop() the WHILE over step().
    The step projects against the whole window with masked dots, writes
    the new basis row at a device index and ends in gcr_ctl: nothing in it
    is read on the host.

    device: the vectors' device, or one device per shard (the vectors are
    then ShardVecs, each shard's window its own); the control state lives
    on ctl's device, which every shard must share. dots: the (dot, bdots)
    pair of make_dots; in a sharded layout its psum hands the control
    kernel the replicated sum (first), and the window mask multiplies the
    summed dots, as in the JAX body. With ctl.trace the step's
    orthogonalisation and normalisation are the device span gram_schmidt.
    Counts: gcr_solves (starts), gcr_steps."""

    def __init__(self, ctl, mult, pc_apply, n, dtype, device, restart=30,
                 rtol=1e-2, atol=1e-50, max_it=200, dots=None):
        self.ctl, self.mult, self.pc_apply = ctl, mult, pc_apply
        self.dot, self.bdots = dots if dots is not None else make_dots()
        self.restart, self.max_it = restart, max_it
        cdev = ctl.pred.device
        self.x = _vec(device, dtype, n)
        self.r = _vec(device, dtype, n)
        self.V = _vec(device, dtype, restart, n)
        self.S = _vec(device, dtype, restart, n)
        self.sc = _zeros(cdev, dtype, 3)
        self.par = torch.tensor([rtol, atol], dtype=dtype, device=cdev)
        self.ints = torch.zeros(3, dtype=torch.int32, device=cdev)
        self.ix = torch.zeros(1, dtype=torch.int64, device=cdev)
        self.ar = torch.arange(restart, device=cdev)
        self.p = ctl.pred_slots(1)
        self.c0 = ctl.count_slots("gcr_solves", "gcr_steps")

    def start(self, b):
        self.x.zero_()
        self.r.copy_(b)
        rn0 = first(_norm(self.dot, self.r))
        krylov_ctl.gcr_ctl(0, self, rn0, rn0, self.ctl)

    def step(self):
        s = self.pc_apply(self.r)
        v = self.mult(s)
        with span(self.ctl.trace, "gram_schmidt"):
            mask = (self.ar < self.ints[1]).to(v.dtype)
            beta = self.bdots(self.V, v) * mask
            v = v - beta @ self.V
            s = s - beta @ self.S
            alpha = _norm(self.dot, v)
            inv = 1.0 / smap(_safe, alpha)
            v = inv * v
            s = inv * s
            self.V.index_copy_(0, self.ix, v[None])
            self.S.index_copy_(0, self.ix, s[None])
        gamma = self.dot(self.r, v)
        self.x.add_(gamma * s)
        self.r.add_(-gamma * v)
        rn = _norm(self.dot, self.r)
        krylov_ctl.gcr_ctl(1, self, first(alpha), first(rn), self.ctl)

    def loop(self):
        return Loop("while", self.p, [Piece(self.step, "gcr step")],
                    count=self.c0 + 1)

    def solve(self, b):
        """The plain driver: x, its, rnorm as tensors (reads only the
        loop predicate)."""
        run_plain([Piece(lambda: self.start(b), "gcr start"), self.loop()],
                  self.ctl)
        return (smap(torch.clone, self.x), self.ints[2].clone(),
                self.sc[2].clone())


class DeviceFGMRES:
    """FGMRES (make_fgmres's semantics; the JAX make_fgmres's while loop)
    over a fixed-shape device state: x, F, the bases V (k+1, n) and Z
    (k, n), and the Hessenberg/Givens/history state of
    kernels/krylov_ctl (H, g, cs, sn, y, hist, sc, par, ints, ix).
    device and dots as in DeviceGCR: with one device per shard the vectors
    and bases are ShardVecs and the control state stays single.

    pc_items(vin, zout) gives the preconditioner as items (Pieces and
    Loops) that compute zout from vin, two static vectors: one Piece for a
    fixed-work preconditioner, a Piece, a nested GCR loop and a Piece for
    the fieldsplit PC with GCR (abf.DeviceLoopSolver).

    init(x0) is a piece (a new solve: x = x0 or 0, bases zeroed,
    fgmres_start_ctl mode 0), loop() the WHILE whose body is IF(cycle
    start) then IF(arnoldi) -- the JAX body's lax.cond -- with the
    arnoldi body ending in IF(build_soln). With ctl.trace each operator
    apply is the device span saddle_apply and the Arnoldi step's
    orthogonalisation and normalisation gram_schmidt. Counts:
    fgmres_solves, fgmres_cycles (cycle starts), fgmres_its (Arnoldi
    steps), build_soln."""

    def __init__(self, ctl, mult, pc_items, n, dtype, device, restart=30,
                 rtol=1e-5, atol=1e-50, dtol=1e4, max_it=10000,
                 hist_len=None, dots=None):
        k = restart
        self.ctl, self.mult = ctl, mult
        self.dot, self.bdots = dots if dots is not None else make_dots()
        self.k, self.max_it = k, max_it
        self.hist_len = max_it + 1 if hist_len is None else hist_len
        v = lambda *shape: _vec(device, dtype, *shape)      # noqa: E731
        self.x, self.F, self.vin, self.zout = v(n), v(n), v(n), v(n)
        self.V, self.Z = v(k + 1, n), v(k, n)
        cdev = ctl.pred.device
        z = lambda *shape: _zeros(cdev, dtype, *shape)      # noqa: E731
        self.H, self.g, self.cs, self.sn, self.y = (z(k + 1, k), z(k + 1),
                                                    z(k), z(k), z(k))
        self.hist = z(self.hist_len)
        self.sc = z(3)
        self.par = torch.tensor([rtol, atol, dtol], dtype=dtype,
                                device=cdev)
        self.ints = torch.zeros(3, dtype=torch.int32, device=cdev)
        self.ix = torch.zeros(2, dtype=torch.int64, device=cdev)
        self.ar = torch.arange(k + 1, device=cdev)
        self.p0 = ctl.pred_slots(4)
        self.c0 = ctl.count_slots("fgmres_solves", "fgmres_cycles",
                                  "fgmres_its", "build_soln")
        self.pc_items = pc_items(self.vin, self.zout)

    def init(self, x0=None):
        if x0 is None:
            self.x.zero_()
        else:
            self.x.copy_(x0)
        self.V.zero_()
        self.Z.zero_()
        krylov_ctl.fgmres_start_ctl(0, self, self.sc, self.ctl)

    def cycle_start(self):
        """True residual of the current iterate; V[0] = r / beta."""
        with span(self.ctl.trace, "saddle_apply"):
            ax = self.mult(self.x)
        r = self.F - ax
        beta = first(_norm(self.dot, r))
        krylov_ctl.fgmres_start_ctl(1, self, beta, self.ctl)
        self.V.zero_()
        self.V[0].copy_(self.sc[2] * r)

    def arnoldi_pre(self):
        self.vin.copy_(self.V.index_select(0, self.ix[0:1])[0])

    def arnoldi_post(self):
        z = self.zout
        with span(self.ctl.trace, "saddle_apply"):
            w = self.mult(z)
        self.Z.index_copy_(0, self.ix[0:1], z[None])
        with span(self.ctl.trace, "gram_schmidt"):
            mask = (self.ar <= self.ints[1]).to(w.dtype)
            h = self.bdots(self.V, w) * mask
            w = w - h @ self.V
            tt = _norm(self.dot, w)
            self.V.index_copy_(0, self.ix[1:2],
                               ((1.0 / smap(_safe, tt)) * w)[None])
        krylov_ctl.fgmres_arnoldi_ctl(self, first(h), first(tt), self.ctl)

    def build_soln(self):
        self.x.add_(self.y @ self.Z)

    def loop(self):
        p0, c0 = self.p0, self.c0
        arnoldi = ([Piece(self.arnoldi_pre, "arnoldi V[it]")]
                   + list(self.pc_items)
                   + [Piece(self.arnoldi_post, "arnoldi"),
                      Loop("if", p0 + 3, [Piece(self.build_soln,
                                                "build_soln")],
                           count=c0 + 3)])
        return Loop("while", p0, [
            Loop("if", p0 + 1, [Piece(self.cycle_start, "cycle start")],
                 count=c0 + 1),
            Loop("if", p0 + 2, arnoldi, count=c0 + 2)])

    def result(self):
        """(x, its, rnorm, state, hist) as device tensors (copies)."""
        return (smap(torch.clone, self.x), self.ints[2].clone(),
                self.sc[1].clone(), self.ints[0].clone(), self.hist.clone())

    def solve(self, F, x0=None):
        """The plain driver over F (and x0): result() after the loop; it
        reads only the loop predicates."""
        self.F.copy_(F)
        run_plain([Piece(lambda: self.init(x0), "fgmres init"),
                   self.loop()], self.ctl)
        return self.result()
