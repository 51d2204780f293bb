"""ex23: 1D tridiagonal KSP smoke test (the reference's ex23mod.c), in the
PyTorch port.

Solves the [-1 2 -1] tridiagonal system with exact solution of all ones,
through the full options-driven KSP/PC stack -- including the custom
ildl/ilupack preconditioners, which is the reason the reference carries
this modified tutorial (ex23mod.c:69-74). Prints the PETSc-format result
line "Norm of error <e>, Iterations <n>". The operator applies on the
device (precond_mg.csr_apply); -device {cuda,cpu}, default cuda.

    python -m exsaddle_tpu_torch.ex23 -n 50 -pc_type ildl
"""

import sys

import numpy as np
import torch

from exsaddle_tpu_torch import solver_config as sc
from exsaddle_tpu_torch.driver import resolve_device
from exsaddle_tpu_torch.krylov import KSPConfig
from exsaddle_tpu_torch.options import Options
from exsaddle_tpu_torch.precond_mg import csr_apply


def solve_ex23(opts, log=print, device=None):
    """device: a torch device; None reads -device (default cuda)."""
    import scipy.sparse as sp
    if device is None:
        device = resolve_device(opts.get_string("device", "cuda"))
    n = opts.get_int("n", 10)
    A = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n)).tocsr()
    u = np.ones(n)
    b = A @ u

    amat = sc.MatShell(n, csr_apply(A, device), device,
                       diagonal=lambda: A.diagonal(), csr=lambda: A,
                       dense=lambda: A.toarray())
    # ex23 sets rtol 1e-7 programmatically (ex23mod.c:175)
    ksp = sc.make_ksp(opts, "", amat,
                      ksp_defaults=KSPConfig(type="gmres", rtol=1e-7),
                      pc_default="jacobi", log=log)
    res = ksp.solve(torch.as_tensor(b, device=device))
    err = float(np.linalg.norm(res.x.cpu().numpy() - u))
    tol = 1000.0 * np.finfo(float).eps
    if err > tol:                      # ex23mod.c:241-243: silent when tiny
        log(f"Norm of error {err:g}, Iterations {res.its}")
    return res, err


def main(argv=None):
    args = sys.argv[1:] if argv is None else argv
    return solve_ex23(Options.from_args(args))


if __name__ == "__main__":
    main()
