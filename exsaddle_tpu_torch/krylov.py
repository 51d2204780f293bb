"""Krylov solvers with reference-matching semantics (the torch port of
exsaddle_tpu/krylov.py).

Capability parity with the PETSc KSP subset the reference exercises
(SURVEY.md section 2.2): GMRES, FGMRES, GCR, Chebyshev (+ eigenvalue
estimation), Richardson, preonly -- with PETSc's exact algorithmic choices so
residual histories reproduce testref/:

  - classical (unmodified) Gram-Schmidt orthogonalization, no refinement;
  - Givens-rotation residual recurrence; happy-breakdown tolerance 1e-30;
  - norm types preconditioned/unpreconditioned/none; left/right pc sides;
  - KSPConvergedDefault semantics (rtol 1e-5, abstol 1e-50, dtol 1e4,
    DIVERGED_ITS at max_it) and KSPConvergedSkip;
  - monitor called at cycle entry, per iteration, and at final acceptance
    (matching -ksp_monitor_short line placement across restarts);
  - nullspace removal after every preconditioner application
    (KSP_PCApply + MatNullSpaceRemove).

Vectors are torch tensors on one device; the Krylov bases live on that device
too. The orchestration is host-side Python, mirroring PETSc's host-driven
loops: every iteration reads its norms and Gram-Schmidt coefficients on the
host (one synchronisation each), and the Hessenberg/Givens recurrences and
the Ritz extraction of the Chebyshev eigenvalue estimate run in numpy.
"""

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch


# --- converged reasons (PETSc names/values used in output) -----------------
class Reason:
    CONVERGED_RTOL = "CONVERGED_RTOL"
    CONVERGED_ATOL = "CONVERGED_ATOL"
    CONVERGED_ITS = "CONVERGED_ITS"
    CONVERGED_HAPPY_BREAKDOWN = "CONVERGED_HAPPY_BREAKDOWN"
    DIVERGED_ITS = "DIVERGED_ITS"
    DIVERGED_DTOL = "DIVERGED_DTOL"
    DIVERGED_BREAKDOWN = "DIVERGED_BREAKDOWN"
    DIVERGED_PC_FAILED = "DIVERGED_PC_FAILED"

    @staticmethod
    def is_converged(reason):
        return reason is not None and reason.startswith("CONVERGED")


@dataclass
class KSPConfig:
    """Mirrors the PETSc KSP runtime configuration surface used by the
    reference tests."""
    type: str = "gmres"
    rtol: float = 1e-5
    abstol: float = 1e-50
    dtol: float = 1e4
    max_it: int = 10000
    restart: int = 30
    pc_side: str = None          # "left"/"right"; None = type default
    norm_type: str = None        # "preconditioned"/"unpreconditioned"/"none"
    view_norm_type: str = None   # PETSc's resolved norm (solver_config note)
    convergence_test: str = "default"   # or "skip"
    initial_guess_nonzero: bool = False
    monitor: Optional[Callable] = None  # monitor(its, rnorm)
    converged_reason_log: Optional[Callable] = None  # -ksp_converged_reason
    prefix: str = ""
    # chebyshev
    cheb_esteig: bool = True
    cheb_esteig_transform: tuple = (0.0, 0.2, 0.0, 1.1)
    cheb_emin: float = 0.0
    cheb_emax: float = 0.0

    def resolved_pc_side(self):
        if self.pc_side:
            return self.pc_side
        return {"gmres": "left", "fgmres": "right", "gcr": "right",
                "chebyshev": "left", "preonly": "left",
                "richardson": "left"}.get(self.type, "left")

    def resolved_norm_type(self):
        if self.norm_type:
            return self.norm_type
        if self.type == "preonly":
            return "none"
        if self.type in ("fgmres", "gcr"):
            return "unpreconditioned"
        if self.type == "gmres":
            return ("unpreconditioned"
                    if self.resolved_pc_side() == "right"
                    else "preconditioned")
        return "preconditioned"


@dataclass
class KSPResult:
    x: object
    its: int
    reason: str
    rnorm: float


def _norm(v):
    return float(torch.linalg.vector_norm(v))


class KSP:
    """A linear solver node: operator apply + preconditioner + config.

    `apply_A`: x -> A x (tensor). `pc`: object with .apply(x) (identity if
    None). `nullspace`: optional (ndof,) unit vector (numpy or tensor);
    projected out after every PC application and from the initial residual,
    matching MatNullSpaceRemove inside KSP_PCApply. It is moved to the
    right-hand side's device at the first solve."""

    def __init__(self, apply_A, pc=None, cfg=None, nullspace=None):
        self.A = apply_A
        self.pc = pc
        self.cfg = cfg or KSPConfig()
        self.nullspace = (None if nullspace is None
                          else torch.as_tensor(nullspace))

    # --- helpers ----------------------------------------------------------
    def _pc_apply(self, x):
        y = x if self.pc is None else self.pc.apply(x)
        if self.nullspace is not None:
            y = y - torch.dot(self.nullspace, y) * self.nullspace
        return y

    def _monitor(self, its, rnorm):
        if self.cfg.monitor is not None:
            self.cfg.monitor(its, rnorm)

    def _converged(self, its, rnorm, state):
        """KSPConvergedDefault (or skip). state dict holds rnorm0."""
        cfg = self.cfg
        if cfg.convergence_test == "skip":
            return None
        if its == 0:
            state["rnorm0"] = rnorm
        rnorm0 = state.get("rnorm0", rnorm)
        if np.isnan(rnorm):
            return Reason.DIVERGED_PC_FAILED
        if rnorm <= max(cfg.rtol * rnorm0, cfg.abstol):
            return (Reason.CONVERGED_ATOL if rnorm < cfg.abstol
                    else Reason.CONVERGED_RTOL)
        if rnorm > cfg.dtol * rnorm0:
            return Reason.DIVERGED_DTOL
        return None

    # --- dispatch ---------------------------------------------------------
    def solve(self, b, x0=None):
        if self.nullspace is not None:
            self.nullspace = self.nullspace.to(device=b.device,
                                               dtype=b.dtype)
        t = self.cfg.type
        if t == "preonly":
            res = self._solve_preonly(b, x0)
        elif t in ("gmres", "fgmres"):
            res = self._solve_gmres(b, x0, flexible=(t == "fgmres"))
        elif t == "gcr":
            res = self._solve_gcr(b, x0)
        elif t == "chebyshev":
            res = self._solve_chebyshev(b, x0)
        elif t == "richardson":
            res = self._solve_richardson(b, x0)
        else:
            raise ValueError(f"KSP type {t} not implemented")
        if self.cfg.converged_reason_log is not None:
            self.cfg.converged_reason_log(
                converged_reason_message(self.cfg.prefix, res))
        return res

    # --- preonly ----------------------------------------------------------
    def _solve_preonly(self, b, x0=None):
        x = self._pc_apply(b)
        return KSPResult(x, 1, Reason.CONVERGED_ITS, 0.0)

    # --- GMRES / FGMRES ---------------------------------------------------
    def _solve_gmres(self, b, x0=None, flexible=False):
        """KSPSolve_GMRES / KSPSolve_FGMRES with classical Gram-Schmidt and
        Givens recurrence. Restarts recompute the true (initial-style)
        residual."""
        cfg = self.cfg
        side = "right" if flexible else cfg.resolved_pc_side()
        norm_type = cfg.resolved_norm_type()
        n = b.shape[0]
        x = (torch.zeros_like(b)
             if (x0 is None or not cfg.initial_guess_nonzero) else x0)
        guess_nonzero = cfg.initial_guess_nonzero and x0 is not None

        itcount = 0
        reason = None
        rnorm = 0.0
        state = {}
        restart = cfg.restart
        haptol = 1e-30
        Hes = np.zeros((1, 0))
        it = 0
        # Krylov bases in preallocated device buffers; rows [0, it] are valid
        Vbuf = None
        Zbuf = None
        H = np.zeros((restart + 1, restart))
        g = np.zeros(restart + 1)
        built = False

        def build_current():
            """KSPBuildSolution mid-cycle (used by residual monitors)."""
            if built or it == 0 or Vbuf is None:
                return x
            y = torch.as_tensor(np.linalg.solve(H[:it, :it], g[:it]),
                                dtype=Vbuf.dtype, device=Vbuf.device)
            if flexible:
                return x + y @ Zbuf[:it]
            vy = y @ Vbuf[:it]
            return x + (self._pc_apply(vy) if side == "right" else vy)

        self.build_solution = build_current

        while True:
            # --- initial residual for this cycle (KSPInitialResidual) ---
            built = False
            r = b - self.A(x) if (guess_nonzero or itcount > 0) else b
            if side == "left":
                v0 = self._pc_apply(r)
            else:
                v0 = r
            res = _norm(v0)
            rnorm = res
            self._monitor(itcount, rnorm)
            if res == 0.0:
                reason = Reason.CONVERGED_ATOL
                break
            reason = self._converged(itcount, rnorm, state)
            if reason:
                break

            if Vbuf is None:
                Vbuf = v0.new_empty((restart + 1, n))
                if flexible:
                    Zbuf = v0.new_empty((restart, n))
            Vbuf[0] = v0 / res
            H = np.zeros((restart + 1, restart))       # rotated Hessenberg
            Hes = np.zeros((restart + 1, restart))     # unrotated (for eig)
            cs = np.zeros(restart)
            sn = np.zeros(restart)
            g = np.zeros(restart + 1)
            g[0] = res
            it = 0
            hapend = False

            while it < restart and itcount < cfg.max_it:
                if it > 0:
                    self._monitor(itcount, rnorm)
                # w = M^-1 A v (left) | A M^-1 v (right)
                vit = Vbuf[it]
                if side == "left":
                    w = self._pc_apply(self.A(vit))
                else:
                    z = self._pc_apply(vit)
                    if flexible:
                        Zbuf[it] = z
                    w = self.A(z)
                # mixed-dtype configurations (f32 rhs, f64 operator/PC):
                # promote the basis buffers instead of silently downcasting
                w_dt = torch.promote_types(w.dtype, Vbuf.dtype)
                if w_dt != Vbuf.dtype:
                    Vbuf = Vbuf.to(w_dt)
                    if Zbuf is not None:
                        Zbuf = Zbuf.to(w_dt)
                # classical (unmodified) Gram-Schmidt, no refinement
                Vm = Vbuf[: it + 1]                      # (it+1, n)
                h_t = Vm @ w.to(w_dt)                    # (it+1,)
                w = w - h_t @ Vm
                h = h_t.cpu().numpy()
                H[: it + 1, it] = h
                Hes[: it + 1, it] = h
                tt = _norm(w)
                H[it + 1, it] = tt
                Hes[it + 1, it] = tt
                # happy breakdown test (gmres.c: hapbnd)
                hapbnd = abs(tt / g[it]) if g[it] != 0 else 0.0
                if hapbnd > haptol:
                    hapbnd = haptol
                if tt > hapbnd:
                    Vbuf[it + 1] = w / tt
                else:
                    hapend = True
                # apply previous Givens rotations to the new column
                for i in range(it):
                    t1 = H[i, it]
                    t2 = H[i + 1, it]
                    H[i, it] = cs[i] * t1 + sn[i] * t2
                    H[i + 1, it] = -sn[i] * t1 + cs[i] * t2
                # new rotation
                delta = np.hypot(H[it, it], H[it + 1, it])
                if delta == 0.0:
                    reason = Reason.DIVERGED_BREAKDOWN
                    break
                cs[it] = H[it, it] / delta
                sn[it] = H[it + 1, it] / delta
                H[it, it] = delta
                H[it + 1, it] = 0.0
                g[it + 1] = -sn[it] * g[it]
                g[it] = cs[it] * g[it]
                res = abs(g[it + 1])
                it += 1
                itcount += 1
                if norm_type != "none":
                    rnorm = res
                reason = self._converged(itcount, rnorm, state)
                if reason:
                    break
                if hapend:
                    reason = Reason.CONVERGED_HAPPY_BREAKDOWN
                    break

            # --- build solution (BuildGmresSoln) ---
            built = True
            if it > 0:
                y = torch.as_tensor(np.linalg.solve(H[:it, :it], g[:it]),
                                    dtype=Vbuf.dtype, device=Vbuf.device)
                if flexible:
                    x = x + y @ Zbuf[:it]
                else:
                    vy = y @ Vbuf[:it]
                    if side == "left":
                        x = x + vy
                    else:
                        x = x + self._pc_apply(vy)
            guess_nonzero = True

            if reason or itcount >= cfg.max_it:
                if not reason:
                    reason = Reason.DIVERGED_ITS
                # final monitor on acceptance (gmres.c end-of-cycle monitor)
                self._monitor(itcount, rnorm)
                break

        self.last_hessenberg = (Hes[: it + 1, :it]
                                if itcount > 0 else np.zeros((1, 0)))
        return KSPResult(x, itcount, reason, rnorm)

    # --- GCR --------------------------------------------------------------
    def _solve_gcr(self, b, x0=None):
        """KSPSolve_GCR: right-preconditioned, unpreconditioned norm,
        truncated to `restart` directions per cycle. Tracks the cumulative
        'restarts performed' statistic printed by KSPView_GCR (each cycle
        after the very first across the KSP's lifetime restarts the
        direction set)."""
        cfg = self.cfg
        self.gcr_restarts = getattr(self, "gcr_restarts", -1) + 1
        x = (x0 if (cfg.initial_guess_nonzero and x0 is not None)
             else torch.zeros_like(b))
        r = b - self.A(x) if (cfg.initial_guess_nonzero and x0 is not None) \
            else b
        rnorm = _norm(r)
        its = 0
        state = {}
        self._monitor(its, rnorm)
        reason = self._converged(its, rnorm, state)
        n = b.shape[0]
        Vbuf = b.new_empty((cfg.restart, n))
        Sbuf = torch.empty_like(Vbuf)
        first_cycle = True
        while not reason:
            if not first_cycle:
                self.gcr_restarts += 1
            first_cycle = False
            ndir = 0
            while ndir < cfg.restart:
                s = self._pc_apply(r)
                v = self.A(s)
                if ndir:
                    Vm = Vbuf[:ndir]
                    beta = Vm @ v
                    v = v - beta @ Vm
                    s = s - beta @ Sbuf[:ndir]
                alpha = _norm(v)
                if alpha == 0.0:
                    reason = Reason.DIVERGED_BREAKDOWN
                    break
                v = v / alpha
                s = s / alpha
                Vbuf[ndir] = v
                Sbuf[ndir] = s
                ndir += 1
                gamma = float(torch.dot(r, v))
                x = x + gamma * s
                r = r - gamma * v
                rnorm = _norm(r)
                its += 1
                self._monitor(its, rnorm)
                reason = self._converged(its, rnorm, state)
                if not reason and its >= cfg.max_it:
                    reason = Reason.DIVERGED_ITS
                if reason:
                    break
        return KSPResult(x, its, reason, rnorm)

    # --- Chebyshev --------------------------------------------------------
    def _estimate_eigenvalues(self, b):
        """KSPChebyshevEstEig: GMRES (10 its, rtol 1e-12) on a noisy RHS,
        extreme REAL PARTS of the Ritz values (KSPComputeEigenvalues on the
        square unrotated Hessenberg). The noise vector comes from
        noisy_vector() (KSPSetNoisy_Private stand-in); the Ritz values are
        computed on the host from the Hessenberg matrix."""
        n = b.shape[0]
        noisy = torch.as_tensor(noisy_vector(n), dtype=b.dtype,
                                device=b.device)
        est_cfg = KSPConfig(type="gmres", rtol=1e-12, max_it=10,
                            restart=30, pc_side="left",
                            norm_type="preconditioned")
        est = KSP(self.A, self.pc, est_cfg, nullspace=self.nullspace)
        est.solve(noisy)
        Hbar = est.last_hessenberg
        it = Hbar.shape[1]
        if it == 0:
            return 0.0, 1.0
        ev = np.linalg.eigvals(Hbar[:it, :it])
        return float(ev.real.min()), float(ev.real.max())

    def _solve_chebyshev(self, b, x0=None):
        """KSPSolve_Chebyshev three-term recurrence (cheby.c)."""
        cfg = self.cfg
        if cfg.cheb_esteig and not hasattr(self, "_cheb_eigs"):
            emin_est, emax_est = self._estimate_eigenvalues(b)
            a, bb, c, d = cfg.cheb_esteig_transform
            emin = a * emin_est + bb * emax_est
            emax = c * emin_est + d * emax_est
            self._cheb_eigs = (emin, emax)
            self.cheb_eig_estimates = (emin_est, emax_est)
        elif hasattr(self, "_cheb_eigs"):
            emin, emax = self._cheb_eigs
        else:
            emin, emax = cfg.cheb_emin, cfg.cheb_emax

        scale = 2.0 / (emax + emin)
        alpha = 1.0 - scale * emin
        mu = 1.0 / alpha
        omegaprod = 2.0 / alpha

        norm_type = cfg.resolved_norm_type()
        state = {}
        x = (x0 if (cfg.initial_guess_nonzero and x0 is not None)
             else torch.zeros_like(b))
        nonzero = cfg.initial_guess_nonzero and x0 is not None
        r = b - self.A(x) if nonzero else b

        # first step: x1 = x0 + scale * M^-1 r
        p_km1 = x
        p_k = x + scale * self._pc_apply(r)
        its = 1
        c_km1, c_k = 1.0, mu
        rnorm = 0.0
        reason = None
        while its < cfg.max_it:
            c_kp1 = 2.0 * mu * c_k - c_km1
            omega = omegaprod * c_k / c_kp1
            r = b - self.A(p_k)
            if norm_type != "none":
                rn = (_norm(r) if norm_type == "unpreconditioned" else None)
            z = self._pc_apply(r)
            if norm_type == "preconditioned":
                rn = _norm(z)
            if norm_type != "none":
                rnorm = rn
                self._monitor(its, rnorm)
                reason = self._converged(its, rnorm, state)
                if reason:
                    break
            p_kp1 = omega * (p_k + scale * z - p_km1) + p_km1
            p_km1, p_k = p_k, p_kp1
            c_km1, c_k = c_k, c_kp1
            its += 1
        if not reason:
            reason = Reason.CONVERGED_ITS
        return KSPResult(p_k, its, reason, rnorm)

    # --- Richardson -------------------------------------------------------
    def _solve_richardson(self, b, x0=None, damping=1.0):
        cfg = self.cfg
        x = (x0 if (cfg.initial_guess_nonzero and x0 is not None)
             else torch.zeros_like(b))
        nonzero = cfg.initial_guess_nonzero and x0 is not None
        state = {}
        its = 0
        reason = None
        rnorm = 0.0
        norm_type = cfg.resolved_norm_type()
        while its < cfg.max_it:
            r = b - self.A(x) if (nonzero or its > 0) else b
            z = self._pc_apply(r)
            if norm_type != "none":
                rnorm = _norm(r if norm_type == "unpreconditioned" else z)
                self._monitor(its, rnorm)
                reason = self._converged(its, rnorm, state)
                if reason:
                    break
            x = x + damping * z
            its += 1
        if not reason:
            reason = (Reason.CONVERGED_ITS if norm_type == "none"
                      else Reason.DIVERGED_ITS)
        return KSPResult(x, its, reason, rnorm)


def converged_reason_message(prefix, result):
    """-ksp_converged_reason line, PETSc format."""
    label = prefix if prefix else ""
    if Reason.is_converged(result.reason):
        return (f"Linear {label} solve converged due to {result.reason} "
                f"iterations {result.its}")
    return (f"Linear {label} solve did not converge due to {result.reason} "
            f"iterations {result.its}")


def fmt_petsc_g(v):
    """PETSc '%g' float formatting."""
    return f"{v:g}"


def noisy_vector(n):
    """Deterministic 'noisy' esteig RHS -- the KSPSetNoisy_Private stand-in
    of the JAX package (b_i = sin(i); see exsaddle_tpu/krylov.py for why
    this formula was kept)."""
    return np.sin(np.arange(n, dtype=np.float64))


def monitor_short_line(its, rnorm):
    """KSPMonitorDefaultShort body (iterationsc.c): %g above 1e-9,
    %5.3e in (1e-11, 1e-9], literal below."""
    if rnorm > 1e-9:
        return f"{its:3d} KSP Residual norm {rnorm:g} "
    if rnorm > 1e-11:
        return f"{its:3d} KSP Residual norm {rnorm:5.3e} "
    return f"{its:3d} KSP Residual norm < 1.e-11"


def make_monitor_short(prefix, log=print):
    """-ksp_monitor_short with the 'Residual norms for <prefix> solve.'
    header on first call."""
    state = {"first": True}

    def monitor(its, rnorm):
        if state["first"] and its == 0:
            log(f"  Residual norms for {prefix} solve.")
        state["first"] = False
        log(monitor_short_line(its, rnorm))
    return monitor
