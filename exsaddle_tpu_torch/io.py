"""Solution diagnostics in the reference's format (a numpy copy of
exsaddle_tpu/io.py:report_solution_diagnostics, SaddleReportSolutionDiagnostics
of exSaddle_io.c:7-58). The dumps and VTK output of that module are not
ported yet."""

import numpy as np


def report_solution_diagnostics(mesh, X, log=print):
    """-diagnostics output (exSaddle_io.c:7-58), exact PETSc formats.
    X: numpy array (ndof,)."""
    nd = mesh.ndim
    Xu = np.asarray(X[: mesh.nu]).reshape(-1, nd)
    Xp = np.asarray(X[mesh.nu:])

    def f(v):
        return f"{v:+1.6e}"

    n1 = np.abs(Xu).sum(axis=0)
    n2 = np.sqrt((Xu ** 2).sum(axis=0))
    ninf = np.abs(Xu).max(axis=0)
    vmin = Xu.min(axis=0)
    vmax = Xu.max(axis=0)
    if nd == 2:
        log(f"|u,v|_1   {f(n1[0])} , {f(n1[1])} ")
        log(f"|u,v|_2   {f(n2[0])} , {f(n2[1])} ")
        log(f"|u,v|_inf {f(ninf[0])} , {f(ninf[1])} ")
        log(f"|u,v|_min {f(vmin[0])} , {f(vmin[1])} ")
        log(f"|u,v|_max {f(vmax[0])} , {f(vmax[1])} ")
    else:
        log(f"|u,v,w|_1   {f(n1[0])} , {f(n1[1])} , {f(n1[2])}")
        log(f"|u,v,w|_2   {f(n2[0])} , {f(n2[1])} , {f(n2[2])}")
        log(f"|u,v,w|_inf {f(ninf[0])} , {f(ninf[1])} , {f(ninf[2])}")
        log(f"|u,v,w|_min {f(vmin[0])} , {f(vmin[1])} , {f(vmin[2])}")
        log(f"|u,v,w|_max {f(vmax[0])} , {f(vmax[1])} , {f(vmax[2])}")
    log(f"|p|_1          {f(np.abs(Xp).sum())}")
    log(f"|p|_2          {f(np.sqrt((Xp ** 2).sum()))}")
    log(f"|p|_inf        {f(np.abs(Xp).max())}")
    log(f"|p|_min        {f(Xp.min())}")
    log(f"|p|_max        {f(Xp.max())}")
