"""The PyTorch port's ABF solver against the JAX package's, on the CPU.

Each case solves one system with both packages. The port's solver is built
twice: from the JAX build's own numbers (abf.data_from_numpy) and from the
port's own setup (abf.build_abf). In float64 the converged reason and the
iteration count must be identical, and the monitor history and the
solution must agree to 1e-8 relative to their largest entry (the packages
sum in different orders; that moves the iterates at ~1e-13). The 4-level
case and iterative refinement live in test_torch_abf_deep.py and
test_torch_abf_ir.py, so the parallel test runner spreads the JAX compiles
over workers."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from exsaddle_tpu import abf as jabf
from exsaddle_tpu import assembly as jasm
from exsaddle_tpu import driver as jdriver
from exsaddle_tpu import models as jmodels
from exsaddle_tpu.mesh import SaddleMesh as JMesh
from exsaddle_tpu.options import Options as JOptions

from exsaddle_tpu_torch import abf as tabf
from exsaddle_tpu_torch import assembly as tasm
from exsaddle_tpu_torch import driver as tdriver
from exsaddle_tpu_torch import models as tmodels
from exsaddle_tpu_torch import treeops
from exsaddle_tpu_torch.mesh import SaddleMesh as TMesh
from exsaddle_tpu_torch.options import Options as TOptions

# one intra-op thread: the suite runs several test processes side by
# side, and these small CPU solves gain nothing from more threads
torch.set_num_threads(1)

TOL = 1e-8


def _problem(pkg, ndim, m_el, size, model):
    Options, Mesh, models, asm, qp_dict = pkg
    names = ["-size_x", "-size_y", "-size_z"][:ndim]
    opts = Options.from_args(["-model", str(model)] + sum(
        ([n, str(v)] for n, v in zip(names, size)), []))
    ctx = models.ModelContext(opts, ndim, log=lambda *a, **k: None)
    mesh = Mesh(ndim, m_el, size)
    fes = asm.FESpace(mesh)
    bc_idx, bc_vals = models.create_bc_list(ctx, mesh)
    c = models.evaluate_coefficients(
        ctx, fes.qp_coords.reshape(-1, ndim)).reshape(mesh.nel, fes.nqp, -1)
    coeff = qp_dict(ctx, asm.interp_q1_to_qp(fes, asm.project_qp_to_q1(
        fes, c)))
    f1, f2 = asm.assemble_rhs(fes, coeff["Fu"], coeff["Fp"])
    F = asm.scatter_vector(mesh, f1, f2)
    F[: mesh.nu][bc_idx] = bc_vals
    return mesh, fes, coeff, bc_idx, bc_vals, F


JAX = (JOptions, JMesh, jmodels, jasm, jdriver._qp_dict)
TORCH = (TOptions, TMesh, tmodels, tasm, tdriver._qp_dict)


def _jax_solver(ndim, m_el, size, model, **kw):
    mesh, fes, coeff, bc_idx, bc_vals, F = _problem(JAX, ndim, m_el, size,
                                                    model)
    slv = jabf.ABFSolver(mesh, fes, coeff, bc_idx, bc_vals, **kw)
    return slv, F + slv.setup["rhs_diri"]


def _from_jax(slv, dtype, ir=False):
    cfg, data, setup = tabf.data_from_numpy(
        dataclasses.asdict(slv.cfg), jax.device_get(slv.data),
        jax.device_get(slv.setup), "cpu", dtype)
    return tabf.ABFSolver.from_parts(cfg, data, setup, device="cpu",
                                     dtype=dtype, ir=ir)


def _own(ndim, m_el, size, model, **kw):
    mesh, fes, coeff, bc_idx, bc_vals, F = _problem(TORCH, ndim, m_el, size,
                                                    model)
    slv = tabf.ABFSolver(mesh, fes, coeff, bc_idx, bc_vals, device="cpu",
                         **kw)
    return slv, F + slv.setup["rhs_diri"]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _same_solve(rt, rj):
    assert rt["reason"] == rj["reason"]
    assert rt["its"] == rj["its"]
    assert len(rt["history"]) == len(rj["history"])
    assert _rel(rt["history"], rj["history"]) < TOL
    assert _rel(rt["x"], rj["x"]) < TOL


@pytest.mark.parametrize("ndim,m_el,size,model,nlevels", [
    (3, (4, 4, 4), (0.1, 1.0, 1.0), 11, 3),
    (2, (32, 32), (1.0, 0.1), 0, 3),
], ids=["pseudoice_mx4", "ar_2d"])
def test_abf_solve_matches_jax(ndim, m_el, size, model, nlevels):
    jslv, F = _jax_solver(ndim, m_el, size, model, nlevels=nlevels)
    rj = jslv.solve(F)
    assert rj["reason"] == "CONVERGED_RTOL"
    _same_solve(_from_jax(jslv, torch.float64).solve(F), rj)
    tslv, Ft = _own(ndim, m_el, size, model, nlevels=nlevels)
    assert np.array_equal(Ft, F)
    _same_solve(tslv.solve(Ft), rj)


def test_fgmres_gcr_state_codes():
    """Port-only checks of the Krylov state machine on a small SPD system:
    FGMRES converges (RTOL), a 2-iteration cap gives DIVERGED_ITS, a zero
    right-hand side gives CONVERGED_ATOL; GCR stops at its rtol."""
    rng = np.random.default_rng(9)
    B = rng.standard_normal((40, 40))
    A = torch.as_tensor(B @ B.T + 40 * np.eye(40))
    b = torch.as_tensor(rng.standard_normal(40))
    mult = lambda v: A @ v
    ident = lambda v: v
    x, its, rn, state, hist = treeops.make_fgmres(
        mult, ident, restart=10, rtol=1e-10)(b, torch.zeros_like(b))
    assert treeops.reason_name(state) == "CONVERGED_RTOL"
    assert float(torch.linalg.norm(b - A @ x)) <= 1.01e-10 * hist[0]
    assert hist[its] == rn and hist[its + 1] == -1.0
    _, its2, _, state2, _ = treeops.make_fgmres(
        mult, ident, restart=10, max_it=2)(b, torch.zeros_like(b))
    assert (its2, treeops.reason_name(state2)) == (2, "DIVERGED_ITS")
    _, _, _, state0, _ = treeops.make_fgmres(mult, ident)(
        torch.zeros_like(b), torch.zeros_like(b))
    assert treeops.reason_name(state0) == "CONVERGED_ATOL"
    xg, gits, grn = treeops.make_gcr(mult, ident, restart=5, rtol=1e-6)(b)
    assert grn <= 1e-6 * float(torch.linalg.norm(b))
    assert float(torch.linalg.norm(b - A @ xg)) <= 1.01e-6 * float(
        torch.linalg.norm(b))
