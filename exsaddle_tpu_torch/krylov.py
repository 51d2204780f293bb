"""Host-side pieces of exsaddle_tpu/krylov.py that the ABF route needs:
the esteig noisy right-hand side and the PETSc monitor / converged-reason
line formats. The host KSP/PC stack itself is not ported yet."""

import numpy as np


def is_converged(reason):
    return reason is not None and reason.startswith("CONVERGED")


def converged_reason_message(prefix, reason, its):
    """-ksp_converged_reason line, PETSc format."""
    label = prefix if prefix else ""
    if is_converged(reason):
        return (f"Linear {label} solve converged due to {reason} "
                f"iterations {its}")
    return (f"Linear {label} solve did not converge due to {reason} "
            f"iterations {its}")


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
