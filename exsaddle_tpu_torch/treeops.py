"""Krylov kernels of the ABF solve, in PyTorch: FGMRES, GCR and the PETSc
Chebyshev recurrence, with the exact semantics of exsaddle_tpu/treeops.py.

Vectors are plain tensors (the flat parity-layout vectors of matfree.py, or
grid tensors on the stencil levels). Krylov bases are (k, n) buffers, so the
classical Gram-Schmidt reduction is one matrix-vector product.

PETSc's algorithmic choices are kept so iteration counts line up with the
JAX package: classical (unmodified) Gram-Schmidt, Givens residual
recurrence, right preconditioning with unpreconditioned norms,
KSPConvergedDefault (rtol/abstol/dtol, DIVERGED_ITS at max_it), happy
breakdown at min(|tt / g_it|, 1e-30), truncated GCR restart.

Loop control is host-synced: each GCR or FGMRES iteration brings its few
scalars to the host once (one device synchronisation) and the Python loop
decides. The small Givens/Hessenberg arithmetic runs on the host in the
working dtype (numpy float32/float64 scalars), as the JAX package runs it
on device in that dtype. Device-side control (CUDA graphs) is later work."""

import numpy as np
import scipy.linalg
import torch

# state codes (sign convention matches PETSc: >0 converged, <0 diverged)
RUNNING = 0
CONVERGED_RTOL = 2
CONVERGED_ATOL = 3
CONVERGED_HAPPY = 5
DIVERGED_ITS = -3
DIVERGED_DTOL = -4

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


def tdot(a, b):
    """Global dot product (0-d tensor on the vectors' device)."""
    return torch.dot(a.reshape(-1), b.reshape(-1))


def tnorm(a):
    return torch.sqrt(tdot(a, a))


# --- Chebyshev smoother ------------------------------------------------------

def cheb_smooth(mult, pc_apply, emin, emax, its, b, x0, x0_zero=False):
    """KSPSolve_Chebyshev three-term recurrence with norm type NONE
    (abf.opts:8-12 smoother: fixed `its` applications, nonzero initial
    guess). emin/emax: numpy scalars of the working dtype (the scalar
    recurrence runs in that dtype).

    x0_zero=True asserts x0 is exactly zero and skips the initial
    r = b - A x0 apply (A 0 == 0 bitwise, so the result is identical with
    one fewer operator application)."""
    scale = 2.0 / (emax + emin)
    alpha_ = 1.0 - scale * emin
    mu = 1.0 / alpha_
    omegaprod = 2.0 / alpha_

    r = b if x0_zero else b - mult(x0)
    p_k = float(scale) * pc_apply(r) + x0
    p_km1 = x0
    c_km1 = mu / mu
    c_k = mu * c_km1
    for _ in range(1, its):
        c_kp1 = 2.0 * mu * c_k - c_km1
        omega = float(omegaprod * c_k / c_kp1)
        r = b - mult(p_k)
        z = pc_apply(r)
        # p_kp1 = omega (p_k + scale z - p_km1) + p_km1
        t = float(scale) * z + p_k
        p_kp1 = omega * (t - p_km1) + p_km1
        p_km1, p_k, c_km1, c_k = p_k, p_kp1, c_k, c_kp1
    return p_k


# --- GCR ---------------------------------------------------------------------

def make_gcr(mult, pc_apply, restart=30, rtol=1e-2, atol=1e-50,
             max_it=200):
    """KSPGCR: right-preconditioned, unpreconditioned norm, truncated
    restart (gcr.c semantics as in exsaddle_tpu/treeops.make_gcr).
    Returns solve(b) -> (x, its, rnorm). Zero initial guess."""

    def solve(b):
        npdt = np_dtype(b)
        x = torch.zeros_like(b)
        r = b.clone()
        rnorm0 = npdt(tnorm(r).item())
        V = torch.zeros((restart,) + b.shape, dtype=b.dtype, device=b.device)
        S = torch.zeros_like(V)
        target = max(npdt(rtol) * rnorm0, npdt(atol))
        state = CONVERGED_ATOL if rnorm0 <= npdt(atol) else RUNNING
        nv = 0
        its = 0
        rnorm = rnorm0
        while state == RUNNING:
            s = pc_apply(r)
            v = mult(s)
            if nv > 0:
                beta = V[:nv] @ v
                v = v - beta @ V[:nv]
                s = s - beta @ S[:nv]
            alpha = tnorm(v)
            inv = 1.0 / torch.where(alpha == 0.0, torch.ones_like(alpha),
                                    alpha)
            v = inv * v
            s = inv * s
            V[nv] = v
            S[nv] = s
            gamma = tdot(r, v)
            x = gamma * s + x
            r = -gamma * v + r
            rn = tnorm(r)
            alpha_h, rn_h = torch.stack([alpha, rn]).cpu().numpy()
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
                dtol=1e4, max_it=10000, hist_len=None):
    """KSPFGMRES: right preconditioning, classical Gram-Schmidt, Givens
    recurrence, unpreconditioned norm, KSPConvergedDefault, restarts with
    the solution built at each cycle end (BuildGmresSoln).

    Returns solve(F, x0) -> (x, its, rnorm, state, hist); hist[i] is the
    residual at iteration i (the -ksp_monitor_short values), length
    hist_len (default max_it+1); entries never reached hold -1."""
    if hist_len is None:
        hist_len = max_it + 1
    k = restart

    def solve(F, x0):
        npdt = np_dtype(F)
        x = x0.clone()
        V = torch.zeros((k + 1,) + F.shape, dtype=F.dtype, device=F.device)
        Z = torch.zeros((k,) + F.shape, dtype=F.dtype, device=F.device)
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
                beta_t = tnorm(r)
                beta = npdt(beta_t.item())
                rnorm = beta
                hist[min(itc, hist_len - 1)] = rnorm
                if itc == 0:
                    r0 = beta
                safe = beta if beta != 0.0 else npdt(1)
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
            h_t = V[: it + 1] @ w
            w = w - h_t @ V[: it + 1]
            tt_t = tnorm(w)
            V[it + 1] = (1.0 / torch.where(tt_t == 0.0,
                                           torch.ones_like(tt_t), tt_t)) * w
            hv = torch.cat([h_t, tt_t.reshape(1)]).cpu().numpy()
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
                y = scipy.linalg.solve_triangular(H[:it, :it], g[:it],
                                                  lower=False)
                yt = torch.as_tensor(y.astype(npdt), device=F.device)
                x = x + yt @ Z[:it]
                it = -1
        return x, itc, rnorm, state, hist

    return solve
