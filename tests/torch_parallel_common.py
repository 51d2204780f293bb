"""Shared set-up of the port's distributed-runtime tests
(tests/test_torch_{parallel,cart,dist_abf,cart_abf,multihost,driver_cart}.py):
one problem built by both packages from the same options, and the
comparison of two ABF solve results.

Both packages' setup modules are numpy copies of one another, so the two
problems hold the same numbers; the right-hand side is assembled once."""

import numpy as np
import torch

from exsaddle_tpu import assembly as jassembly
from exsaddle_tpu import driver as jdriver
from exsaddle_tpu import mesh as jmesh
from exsaddle_tpu import models as jmodels
from exsaddle_tpu import options as joptions

from exsaddle_tpu_torch import assembly as tassembly
from exsaddle_tpu_torch import driver as tdriver
from exsaddle_tpu_torch import mesh as tmesh
from exsaddle_tpu_torch import models as tmodels
from exsaddle_tpu_torch import options as toptions

# one intra-op thread: the suite runs several test processes side by side,
# and these small CPU solves gain nothing from more threads
torch.set_num_threads(1)

PSEUDOICE = ["-model", "11", "-size_x", "0.1"]
LAME = ["-model", "6", "-lambda1", "10"]


def _build(pkg, ndim, m_el, args, lame, size, project):
    models, driver, options, mesh_mod, assembly = pkg
    ctx = models.ModelContext(options.Options.from_args(list(args)), ndim,
                              lame=lame, log=lambda *a, **k: None)
    mesh = mesh_mod.SaddleMesh(ndim, tuple(m_el), tuple(size))
    fes = assembly.FESpace(mesh)
    bc_idx, bc_vals = models.create_bc_list(ctx, mesh)
    c = models.evaluate_coefficients(
        ctx, fes.qp_coords.reshape(-1, ndim)).reshape(mesh.nel, fes.nqp, -1)
    if project:
        c = assembly.interp_q1_to_qp(fes, assembly.project_qp_to_q1(fes, c))
    coeff = driver._qp_dict(ctx, c)
    return ctx, mesh, fes, coeff, bc_idx, bc_vals


def problems(ndim, m_el, args, lame=False, size=None, project=True):
    """(jax, torch): each (ctx, mesh, fes, coeff, bc_idx, bc_vals) of the
    same problem, built by the JAX package and by the port."""
    size = size or (1.0,) * ndim
    j = _build((jmodels, jdriver, joptions, jmesh, jassembly), ndim, m_el,
               args, lame, size, project)
    t = _build((tmodels, tdriver, toptions, tmesh, tassembly), ndim, m_el,
               args, lame, size, project)
    return j, t


def rhs(prob, rhs_diri):
    """The driver's right-hand side: F with BC values and rhs_diri."""
    _, mesh, fes, coeff, bc_idx, bc_vals = prob
    f1, f2 = tassembly.assemble_rhs(fes, np.asarray(coeff["Fu"]),
                                    np.asarray(coeff["Fp"]))
    F = tassembly.scatter_vector(mesh, f1, f2)
    F[: mesh.nu][np.asarray(bc_idx)] = np.asarray(bc_vals)
    return F + np.asarray(rhs_diri)


def assert_same_solve(got, ref, tol=1e-10):
    """The port's result dict against the JAX one: the same iteration count
    and converged state, the monitor history to tol of its first value,
    x to tol relative."""
    assert got["its"] == ref["its"]
    assert got["state"] == int(ref["state"]) == 2       # CONVERGED_RTOL
    assert got["reason"] == "CONVERGED_RTOL"
    h, hr = np.array(got["history"]), np.array(ref["history"])
    assert h.shape == hr.shape
    assert np.abs(h - hr).max() <= tol * hr[0]
    x, xr = np.asarray(got["x"]), np.asarray(ref["x"])
    assert np.linalg.norm(x - xr) <= tol * np.linalg.norm(xr)
