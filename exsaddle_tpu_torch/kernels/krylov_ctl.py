"""The Krylov control kernels: the scalar tails of the GCR, FGMRES and
iterative-refinement loop bodies, hand-written for the card (source
csrc/krylov_ctl.cu, built by kernels/_build.py), each with its plain
PyTorch twin beside it.

They are new in the port: the JAX package's loops are lax.while_loops
whose scalar code XLA compiles into the loop (exsaddle_tpu/treeops.py:
338-359 cycle_start, :369-420 arnoldi, :256-285 GCR; exsaddle_tpu/abf.py:
1133-1161 the refinement round). Here they let a whole solve run as one
graph launch (graphs.ControlGraph): each kernel updates its loop's small
state in device memory, writes its loops' predicates to `ctl.pred` and,
inside the graph, sets the same values into the conditional nodes'
handles, and adds one to `ctl.counts` per execution of its loop body.

  fgmres_start_ctl    mode 0 a new solve, mode 1 a cycle start after
                      beta = ||F - A x||: beta, r0, hist, g[0], 1/safe(beta)
                      (sc[2]), the state tests
  fgmres_arnoldi_ctl  after the masked Gram-Schmidt dots h and tt = ||w||:
                      the rotations, the new Givens pair, H, g, cs, sn,
                      hist, it, itc, rnorm, the state tests in the JAX
                      order (delta == 0, rtol/atol, dtol, happy breakdown,
                      max_it) and at a cycle's end y from the padded
                      unit-diagonal triangle, it = -1
  gcr_ctl             mode 0 after rnorm0 = ||b|| (target, state), mode 1
                      after a step (its, the nv wrap, state)
  ir_ctl              mode 0 after rnorm0, mode 1 after a round (accept,
                      history, rounds, inner_total, done, stalled, the
                      n_rounds bound); float64

On a CUDA tensor a wrapper launches its kernel (or raises) and adds one to
its count in LAUNCHES; on a CPU tensor it runs the twin. Kernel and twin
are bitwise equal: the kernels round every operation explicitly in the
twin's order (see the source).

The state a wrapper takes is any object with the tensors it names
(treeops.DeviceFGMRES, DeviceGCR, abf.DeviceIR): for FGMRES in the working
dtype H (k+1, k), g (k+1), cs, sn, y (k), hist (hist_len), sc [r0, rnorm,
1/safe(beta)], par [rtol, atol, dtol], and ints int32 [state, it, itc], ix
int64 [max(it, 0), max(it, 0) + 1], k, hist_len, max_it, pred slots p0..p0+3
(loop, cycle start, arnoldi, build_soln) and count slots c0..c0+3 (solve,
cycle starts, arnoldi steps, builds); for GCR sc [rnorm0, target, rnorm],
par [rtol, atol], ints [state, nv, its], ix [nv], restart, max_it, slot p,
counts c0 (starts), c0+1 (steps); for IR (float64) sc [rnorm0, rnorm,
rtol, n_rounds], ints [rounds, inner_total, done, stalled, accept], hist,
slot p, counts c0, c0+1. `ctl` is a graphs.Control (pred, counts,
handles_ptr())."""

import ctypes

import torch

from exsaddle_tpu_torch.kernels import _build

# state codes (sign convention matches PETSc: >0 converged, <0 diverged)
RUNNING = 0
CONVERGED_RTOL = 2
CONVERGED_ATOL = 3
CONVERGED_HAPPY = 5
DIVERGED_ITS = -3
DIVERGED_DTOL = -4

# the kernel's local Hessenberg column (csrc/krylov_ctl.cu KMAX)
KMAX = 256

NAMES = ("fgmres_start_ctl", "fgmres_arnoldi_ctl", "gcr_ctl", "ir_ctl")


class Launches:
    """Device launches each wrapper sent to its kernel (twin calls are not
    counted). Inside a CUDA graph capture a wrapper records a launch that
    the graph repeats; graphs.ControlGraph takes those back out and adds
    the executions the device counted."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.n = dict.fromkeys(NAMES, 0)


LAUNCHES = Launches()

_V = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "kc_fgmres_start": [_I, _I, _I] + [_V] * 13 + [_I, _I, _V],
    "kc_fgmres_arnoldi": [_I, _I, _I] + [_V] * 15 + [_I, _I, _V],
    "kc_gcr": [_I, _I, _I] + [_V] * 9 + [_I, _I, _V],
    "kc_ir": [_I, _I] + [_V] * 8 + [_I, _I, _V],
}
_bound = False


def _lib():
    global _bound
    lib = _build.load()
    if not _bound:
        for base, args in _ARGTYPES.items():
            for sfx in ("_f32", "_f64"):
                if base == "kc_ir" and sfx == "_f32":
                    continue
                f = getattr(lib, base + sfx)
                f.argtypes = args
                f.restype = ctypes.c_int
        lib.a00_error_string.argtypes = [ctypes.c_int]
        lib.a00_error_string.restype = ctypes.c_char_p
        _bound = True
    return lib


def _sfx(dtype):
    if dtype == torch.float32:
        return "_f32"
    if dtype == torch.float64:
        return "_f64"
    raise TypeError(f"krylov_ctl: dtype {dtype} not supported")


def _check(name, ctl, tensors, dtype):
    """Every tensor on one CUDA device, contiguous, of its expected dtype."""
    dev = ctl.pred.device
    want = {"pred": (ctl.pred, torch.int32),
            "counts": (ctl.counts, torch.int64)}
    want.update(tensors)
    for key, (t, dt) in want.items():
        if t.device != dev:
            raise ValueError(f"{name}: {key} on {t.device}, pred on {dev}")
        if t.dtype != (dtype if dt is None else dt):
            raise TypeError(f"{name}: {key} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")


def _launch(name, fn, *args):
    err = fn(*args, _V(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{_lib().a00_error_string(err).decode()} ({err})")
    LAUNCHES.n[name] += 1


def _p(t):
    return _V(t.data_ptr())


def _cuda(name, t):
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def _fgmres_tensors(st):
    return {"H": (st.H, None), "g": (st.g, None), "cs": (st.cs, None),
            "sn": (st.sn, None), "y": (st.y, None), "hist": (st.hist, None),
            "sc": (st.sc, None), "par": (st.par, None),
            "ints": (st.ints, torch.int32), "ix": (st.ix, torch.int64)}


# --- twins -------------------------------------------------------------------

def _i32(v, like):
    return torch.full((), v, dtype=torch.int32, device=like.device)


def _set_pred(ctl, slot, v):
    ctl.pred[slot] = v.to(torch.int32) if isinstance(v, torch.Tensor) else v


def _conv_test(state, rnorm, r0, par):
    """KSPConvergedDefault after a residual: rtol/atol, then dtol."""
    rtol, atol, dtol = par[0], par[1], par[2]
    a = rtol * r0
    lim = torch.where(atol > a, atol, a)
    conv = (state == RUNNING) & (rnorm <= lim)
    state = torch.where(conv, torch.where(rnorm < atol,
                                          _i32(CONVERGED_ATOL, state),
                                          _i32(CONVERGED_RTOL, state)), state)
    return torch.where((state == RUNNING) & (rnorm > dtol * r0),
                       _i32(DIVERGED_DTOL, state), state)


def _fgmres_preds(ctl, p0, run, start, arnoldi, build):
    for i, v in enumerate((run, start, arnoldi, build)):
        _set_pred(ctl, p0 + i, v)


def _clamp_index(i, n):
    return i.clamp(0, n - 1).to(torch.int64).reshape(1)


def fgmres_start_ctl_plain(mode, st, beta, ctl):
    """The twin of the fgmres_start_ctl kernel."""
    if mode == 0:
        st.hist.fill_(-1.0)
        st.ints[0] = RUNNING
        st.ints[1] = -1
        st.ints[2] = 0
        st.sc[0] = 0.0
        st.sc[1] = 0.0
        st.ix[0] = 0
        st.ix[1] = 1
        _fgmres_preds(ctl, st.p0, 1, 1, 0, 0)
        ctl.counts[st.c0] += 1
        return
    st.H.zero_()
    st.g.zero_()
    st.cs.zero_()
    st.sn.zero_()
    itc = st.ints[2].clone()
    beta = beta.reshape(())
    st.sc[1] = beta
    st.hist.index_copy_(0, _clamp_index(itc, st.hist_len), beta.reshape(1))
    r0 = torch.where(itc == 0, beta, st.sc[0])
    st.sc[0] = r0
    one = torch.ones_like(beta)
    st.sc[2] = one / torch.where(beta == 0, one, beta)
    st.g[0] = beta
    state = torch.where(beta == 0, _i32(CONVERGED_ATOL, st.ints),
                        st.ints[0])
    state = _conv_test(state, beta, r0, st.par)
    st.ints[0] = state
    st.ints[1] = 0
    st.ix[0] = 0
    st.ix[1] = 1
    run = state == RUNNING
    _fgmres_preds(ctl, st.p0, run, 0, run, 0)
    ctl.counts[st.c0 + 1] += 1


def _back_substitute(H, g, n, k):
    """y from the rotated triangle H[:n, :n], padded to k x k with a unit
    diagonal and a zero right-hand side; columns right to left."""
    ar = torch.arange(k, device=H.device)
    colmask = ar < n
    y = torch.where(colmask, g[:k], torch.zeros_like(g[:k]))
    d = torch.where(colmask, torch.diagonal(H[:k]), torch.ones_like(y))
    for j in reversed(range(k)):
        yj = y[j] / d[j]
        y[j] = yj
        if j:
            y[:j] = y[:j] - H[:j, j] * yj
    return y


def fgmres_arnoldi_ctl_plain(st, h, tt, ctl):
    """The twin of the fgmres_arnoldi_ctl kernel."""
    k = st.k
    it = st.ints[1].clone()
    itc = st.ints[2].clone()
    tt = tt.reshape(())
    ix0, ix1 = st.ix[0:1], st.ix[1:2]
    git = st.g.index_select(0, ix0)[0]
    one = torch.ones_like(tt)
    q = torch.abs(tt / torch.where(git == 0, one, git))
    cap = torch.full_like(tt, 1e-30)
    happy = tt <= torch.where(cap < q, cap, q)
    ar = torch.arange(k + 1, device=h.device)
    hcol = torch.where(ar <= it, h, torch.zeros_like(h))
    hcol = torch.where(ar == it + 1, tt, hcol)
    cs, sn = st.cs, st.sn
    for i in range(k):
        act = i < it
        t1, t2 = hcol[i].clone(), hcol[i + 1].clone()
        n1 = cs[i] * t1 + sn[i] * t2
        n2 = (-sn[i]) * t1 + cs[i] * t2
        hcol[i] = torch.where(act, n1, t1)
        hcol[i + 1] = torch.where(act, n2, t2)
    h_it = hcol.index_select(0, ix0)[0]
    h_it1 = hcol.index_select(0, ix1)[0]
    delta = torch.sqrt(h_it * h_it + h_it1 * h_it1)
    safe_d = torch.where(delta == 0, one, delta)
    c = h_it / safe_d
    s = h_it1 / safe_d
    cs.index_copy_(0, ix0, c.reshape(1))
    sn.index_copy_(0, ix0, s.reshape(1))
    hcol = torch.where(ar == it, delta, hcol)
    hcol = torch.where(ar == it + 1, torch.zeros_like(hcol), hcol)
    st.H.index_copy_(1, ix0, hcol[:, None])
    g_new = (-s) * git
    st.g.index_copy_(0, ix0, (c * git).reshape(1))
    st.g.index_copy_(0, ix1, g_new.reshape(1))
    rnorm = torch.abs(g_new)
    st.sc[1] = rnorm
    it = it + 1
    itc = itc + 1
    st.hist.index_copy_(0, _clamp_index(itc, st.hist_len), rnorm.reshape(1))
    state = st.ints[0].clone()
    state = torch.where(delta == 0, _i32(DIVERGED_ITS, state), state)
    state = _conv_test(state, rnorm, st.sc[0], st.par)
    running = state == RUNNING
    state = torch.where(running & happy, _i32(CONVERGED_HAPPY, state), state)
    running = state == RUNNING
    state = torch.where(running & (itc >= st.max_it),
                        _i32(DIVERGED_ITS, state), state)
    end = (state != RUNNING) | (it >= k)
    y = _back_substitute(st.H, st.g, it, k)
    st.y.copy_(torch.where(end, y, st.y))
    it = torch.where(end, _i32(-1, it), it)
    st.ints[0] = state
    st.ints[1] = it
    st.ints[2] = itc
    row = it.clamp(min=0).to(torch.int64)
    st.ix[0] = row
    st.ix[1] = row + 1
    run = state == RUNNING
    _fgmres_preds(ctl, st.p0, run, run & (it < 0), run & (it >= 0), end)
    ctl.counts[st.c0 + 2] += 1
    ctl.counts[st.c0 + 3] += end.to(torch.int64)


def gcr_ctl_plain(mode, st, alpha, rn, ctl):
    """The twin of the gcr_ctl kernel (alpha is not read in mode 0)."""
    rtol, atol = st.par[0], st.par[1]
    rn = rn.reshape(())
    if mode == 0:
        a = rtol * rn
        st.sc[0] = rn
        st.sc[1] = torch.where(atol > a, atol, a)
        st.sc[2] = rn
        state = torch.where(rn <= atol, _i32(CONVERGED_ATOL, st.ints),
                            _i32(RUNNING, st.ints))
        st.ints[1] = 0
        st.ints[2] = 0
        st.ix[0] = 0
    else:
        alpha = alpha.reshape(())
        st.sc[2] = rn
        its = st.ints[2] + 1
        nv = st.ints[1] + 1
        nv = torch.where(nv >= st.restart, torch.zeros_like(nv), nv)
        state = st.ints[0].clone()
        state = torch.where(rn <= st.sc[1], _i32(CONVERGED_RTOL, state),
                            state)
        state = torch.where((state == RUNNING) & (its >= st.max_it),
                            _i32(DIVERGED_ITS, state), state)
        state = torch.where(alpha == 0, _i32(DIVERGED_ITS, state), state)
        st.ints[1] = nv
        st.ints[2] = its
        st.ix[0] = nv.to(torch.int64)
    st.ints[0] = state
    _set_pred(ctl, st.p, state == RUNNING)
    ctl.counts[st.c0 + mode] += 1


def ir_ctl_plain(mode, st, rn, fg_ints, ctl):
    """The twin of the ir_ctl kernel (fg_ints is not read in mode 0)."""
    rn = rn.reshape(())
    n_rounds = st.sc[3].to(torch.int32)
    if mode == 0:
        st.sc[0] = rn
        st.sc[1] = rn
        st.hist.fill_(-1.0)
        st.hist[0] = rn
        st.ints.zero_()
        _set_pred(ctl, st.p, n_rounds > 0)
        ctl.counts[st.c0] += 1
        return
    rounds = st.ints[0] + 1
    st.ints[0] = rounds
    st.ints[1] += fg_ints[2]
    accept = (fg_ints[0] >= 0) & (rn < st.sc[1])
    st.sc[1] = torch.where(accept, rn, st.sc[1])
    idx = _clamp_index(rounds, st.hist.numel())
    st.hist.index_copy_(0, idx, torch.where(accept, rn,
                                            st.hist.index_select(0, idx)[0]
                                            ).reshape(1))
    stalled = ~accept
    done = stalled | (accept & (st.sc[1] <= st.sc[2] * st.sc[0]))
    st.ints[2] = done
    st.ints[3] = stalled
    st.ints[4] = accept
    _set_pred(ctl, st.p, ~done & (rounds < n_rounds))
    ctl.counts[st.c0 + 1] += 1


# --- wrappers ----------------------------------------------------------------

def fgmres_start_ctl(mode, st, beta, ctl):
    """FGMRES cycle-start control (mode 0: a new solve; 1: a cycle start
    after beta, a 1-element tensor of the working dtype)."""
    name = "fgmres_start_ctl"
    if not _cuda(name, st.H):
        return fgmres_start_ctl_plain(mode, st, beta, ctl)
    tensors = _fgmres_tensors(st)
    tensors["beta"] = (beta, None)
    _check(name, ctl, tensors, st.H.dtype)
    fn = getattr(_lib(), "kc_fgmres_start" + _sfx(st.H.dtype))
    _launch(name, fn, mode, st.k, st.hist_len, _p(st.H), _p(st.g), _p(st.cs),
            _p(st.sn), _p(st.hist), _p(st.sc), _p(st.par), _p(st.ints),
            _p(st.ix), _p(beta), _p(ctl.pred), _V(ctl.handles_ptr()),
            _p(ctl.counts), st.p0, st.c0)


def fgmres_arnoldi_ctl(st, h, tt, ctl):
    """FGMRES Arnoldi-step control after the masked dots h (k+1) and
    tt = ||w|| (a 1-element tensor)."""
    name = "fgmres_arnoldi_ctl"
    if not _cuda(name, st.H):
        return fgmres_arnoldi_ctl_plain(st, h, tt, ctl)
    if st.k > KMAX:
        raise ValueError(f"{name}: restart {st.k} > {KMAX}")
    tensors = _fgmres_tensors(st)
    tensors.update(h=(h, None), tt=(tt, None))
    _check(name, ctl, tensors, st.H.dtype)
    fn = getattr(_lib(), "kc_fgmres_arnoldi" + _sfx(st.H.dtype))
    _launch(name, fn, st.k, st.hist_len, st.max_it, _p(st.H), _p(st.g),
            _p(st.cs), _p(st.sn), _p(st.y), _p(st.hist), _p(st.sc),
            _p(st.par), _p(st.ints), _p(st.ix), _p(h), _p(tt), _p(ctl.pred),
            _V(ctl.handles_ptr()), _p(ctl.counts), st.p0, st.c0)


def gcr_ctl(mode, st, alpha, rn, ctl):
    """GCR control (mode 0 after rn = ||b||, 1 after a step)."""
    name = "gcr_ctl"
    if not _cuda(name, st.sc):
        return gcr_ctl_plain(mode, st, alpha, rn, ctl)
    _check(name, ctl, {"sc": (st.sc, None), "par": (st.par, None),
                       "ints": (st.ints, torch.int32),
                       "ix": (st.ix, torch.int64), "alpha": (alpha, None),
                       "rn": (rn, None)}, st.sc.dtype)
    fn = getattr(_lib(), "kc_gcr" + _sfx(st.sc.dtype))
    _launch(name, fn, mode, st.restart, st.max_it, _p(st.sc), _p(st.par),
            _p(st.ints), _p(st.ix), _p(alpha), _p(rn), _p(ctl.pred),
            _V(ctl.handles_ptr()), _p(ctl.counts), st.p, st.c0)


def ir_ctl(mode, st, rn, fg_ints, ctl):
    """Refinement-round control (mode 0 after rn = ||F||, 1 after a
    round); float64."""
    name = "ir_ctl"
    if not _cuda(name, st.sc):
        return ir_ctl_plain(mode, st, rn, fg_ints, ctl)
    _check(name, ctl, {"sc": (st.sc, None), "ints": (st.ints, torch.int32),
                       "hist": (st.hist, None), "rn": (rn, None),
                       "fg_ints": (fg_ints, torch.int32)}, torch.float64)
    _launch(name, _lib().kc_ir_f64, mode, st.hist.numel(), _p(st.sc),
            _p(st.ints), _p(st.hist), _p(rn), _p(fg_ints), _p(ctl.pred),
            _V(ctl.handles_ptr()), _p(ctl.counts), st.p, st.c0)
