"""Fixed-iteration Krylov paths with no host synchronisation (the torch port
of exsaddle_tpu/compiled.py).

The host-orchestrated solvers in krylov.py reproduce PETSc's adaptive
control flow (convergence tests, restarts) and read their scalars on the
host every iteration; this module is the fixed-work path: a whole FGMRES
cycle or Chebyshev sweep is issued to the device without one host read.
Every scalar -- the Hessenberg matrix, beta, the safe divisors, the
least-squares solution -- stays a device tensor, and no Python branch looks
at a device value, so a cycle runs under
torch.cuda.set_sync_debug_mode("error").

Algorithms mirror the reference's solver configuration (abf.opts,
exSaddle.c:303-422): FGMRES with classical Gram-Schmidt and right
preconditioning, and Chebyshev smoothing iterations. The (k+1, k)
least-squares problem min ||beta e1 - H y|| is solved on the device by a
Householder QR and a triangular solve (k is the restart length, ~30): for a
full-column-rank H that is the JAX package's jnp.linalg.lstsq solution.
"""

import torch

from exsaddle_tpu_torch.matfree import mult_tree, tree_norm


def _safe(a):
    """a, with exact zeros replaced by 1 (a divisor that never branches)."""
    return torch.where(a == 0.0, torch.ones_like(a), a)


def _lstsq_hessenberg(H, beta):
    """y = argmin ||beta e1 - H y|| for the (k+1, k) Hessenberg H, on H's
    device with no host read: a Householder QR, then a triangular solve.
    After an exact breakdown the trailing columns of H are zero; their zero
    pivots are replaced by 1 with a zero right-hand side, which gives y = 0
    there (the minimum-norm solution jnp.linalg.lstsq returns)."""
    Q, R = torch.linalg.qr(H)                  # (k+1, k), (k, k)
    zero = torch.diagonal(R) == 0.0
    R = R + torch.diag(zero.to(R.dtype))
    rhs = torch.where(zero, torch.zeros_like(beta), beta * Q[0])
    return torch.linalg.solve_triangular(R, rhs.unsqueeze(1),
                                         upper=True).squeeze(1)


def _fgmres_cycle(mult, pc_apply, k, F, x0):
    """One FGMRES(k) cycle from x0: right preconditioning, classical
    Gram-Schmidt (one pass of dots against the basis, then one fused
    subtraction), the bases as (k+1, n) / (k, n) device matrices. Returns
    (x, ||F - A x||) with the norm a device scalar; k + 2 applies of mult."""
    n = F.shape[0]
    r0 = F - mult(x0)
    beta = tree_norm(r0)
    V = F.new_zeros((k + 1, n))
    Z = F.new_zeros((k, n))
    H = F.new_zeros((k + 1, k))
    V[0] = r0 / _safe(beta)
    for j in range(k):
        z = pc_apply(V[j])
        w = mult(z)
        h = V[: j + 1] @ w                        # (j+1,)
        w = w - h @ V[: j + 1]
        hj1 = tree_norm(w)
        V[j + 1] = w / _safe(hj1)
        Z[j] = z
        H[: j + 1, j] = h
        H[j + 1, j] = hj1
    y = _lstsq_hessenberg(H, beta)
    x = x0 + y @ Z
    return x, tree_norm(F - mult(x))


def make_fgmres_cycle(mult, pc_apply, k):
    """`cycle(F, x0) -> (x, rnorm)` performing one FGMRES(k) cycle with
    right preconditioning and classical Gram-Schmidt (the KSPFGMRES
    configuration the reference drives, exSaddle.c:405 + abf.opts:2).

    mult:     x -> A x
    pc_apply: x -> M^{-1} x
    k:        fixed iteration count (the restart length; no convergence
              test -- this is the fixed-work path). rnorm is a device
              scalar.
    """
    def cycle(F, x0):
        return _fgmres_cycle(mult, pc_apply, k, F, x0)
    return cycle


def make_fgmres(mult, pc_apply, k, ncycles):
    """Fixed-work FGMRES: `solve(F, x0) -> (x, rnorm)` running `ncycles`
    restarted FGMRES(k) cycles."""
    def solve(F, x0):
        x, rnorm = x0, F.new_zeros(())
        for _ in range(ncycles):
            x, rnorm = _fgmres_cycle(mult, pc_apply, k, F, x)
        return x, rnorm
    return solve


def make_chebyshev(mult, pc_apply, emin, emax, its):
    """Chebyshev(its) smoother `smooth(b, x0) -> x` over the interval
    [emin, emax] (KSPCHEBYSHEV as configured by abf.opts:8-12); emin, emax
    are host numbers, so the recurrence's coefficients are too."""
    theta = 0.5 * (emax + emin)
    delta = 0.5 * (emax - emin)

    def smooth(b, x0):
        r = b - mult(x0)
        d = pc_apply(r) / theta
        x = x0 + d
        alpha = theta
        for _ in range(1, its):
            r = b - mult(x)
            beta = (delta / 2.0) ** 2 / alpha
            alpha = theta - beta
            d = (pc_apply(r) + beta * d) / alpha
            x = x + d
        return x

    return smooth


def make_fgmres_cycle_tree(k):
    """Tree-form FGMRES(k) cycle: `cycle(op, aux, inv_diag, F, x0) ->
    (x, rnorm)` over matfree.mult_tree, the production apply (its u-u term
    is K1 on CUDA: 2 launches per apply, k + 2 applies per cycle). op: a
    ParityMatFreeOperator; aux: matfree.tree_aux(op); inv_diag, F, x0: flat
    parity-layout vectors (the port's tree form)."""
    def cycle(op, aux, inv_diag, F, x0):
        return _fgmres_cycle(lambda t: mult_tree(op, aux, t),
                             lambda t: inv_diag * t, k, F, x0)
    return cycle
