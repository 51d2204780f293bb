"""The port's matrix-free/grid operators, nnz models and compiled Krylov
paths against the JAX package (exsaddle_tpu/{matfree,grid_ops,compiled}.py)
on the CPU in float64: the same numpy setup from fixed seeds goes through
both packages.

Tolerances: applies 1e-12 relative (test_fast_apply.py:51-61); the compiled
builders 1e-10 relative in rnorm and x against the JAX builders, and 1e-8
against the port's host KSP (test_fast_apply.py:89,135)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as graft
from exsaddle_tpu import compiled as jcomp
from exsaddle_tpu import matfree as jmf
from exsaddle_tpu.grid_ops import GridSaddleOperator as JGrid

from exsaddle_tpu_torch import compiled as tcomp
from exsaddle_tpu_torch import matfree as tmf
from exsaddle_tpu_torch import precond as tprecond
from exsaddle_tpu_torch.grid_ops import GridSaddleOperator as TGrid
from exsaddle_tpu_torch.krylov import KSP, KSPConfig
from exsaddle_tpu_torch.operator import apply_dirichlet_elimination

from test_fast_apply import CASES, _build

torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _pair(case):
    """(JAX element op, port element op, mesh, fes, coeff, bc_mask)."""
    mesh, fes, coeff, op, bc_mask = _build(*case)
    from exsaddle_tpu import models as emodels
    from exsaddle_tpu.assembly import assemble_element_matrices
    from exsaddle_tpu.options import Options
    nd, lame, model = case[0], case[2], case[3]
    ctx = emodels.ModelContext(Options.from_args(["-model", model]), nd,
                               lame=lame, log=lambda *a, **k: None)
    bci, bcv = emodels.create_bc_list(ctx, mesh)
    elm = assemble_element_matrices(fes, coeff, lame=lame)
    top, _, _, _ = apply_dirichlet_elimination(mesh, elm, bci, bcv, "cpu")
    return op, top, mesh, fes, coeff, np.asarray(bc_mask)


@pytest.mark.parametrize("nd,m_el", [(2, (3, 2)), (2, (4, 4)),
                                     (3, (2, 3, 2))])
def test_nnz_models_match_jax(nd, m_el):
    mesh, _, _, op, _ = _build(nd, m_el)
    assert tmf.assembled_nnz(mesh) == jmf.assembled_nnz(mesh) \
        == op.to_csr().nnz
    assert tmf.coupling_nnz(mesh) == jmf.coupling_nnz(mesh)
    assert tmf.allocated_nnz(mesh) == jmf.allocated_nnz(mesh)


@pytest.mark.parametrize("case", CASES)
def test_grid_matfree_parity_match_jax(case):
    nd, m_el, lame, model, size = case
    jop, top, mesh, fes, coeff, bc_mask = _pair(case)
    x = np.random.default_rng(0).standard_normal(mesh.ndof)
    xt = torch.as_tensor(x)
    y_ref = np.asarray(jax.jit(jop.mult)(jnp.asarray(x)))

    jg = JGrid.from_operator(mesh, jop)
    tg = TGrid.from_operator(mesh, top)
    yg = tg.mult(xt).numpy()
    assert _rel(yg, np.asarray(jax.jit(jg.mult)(jnp.asarray(x)))) < 1e-12
    assert _rel(yg, y_ref) < 1e-12

    jm = jmf.MatFreeSaddleOperator.build(mesh, fes, coeff, bc_mask,
                                         lame=lame, dtype=jnp.float64)
    tm = tmf.MatFreeSaddleOperator.build(mesh, fes, coeff, bc_mask,
                                         lame=lame, dtype=torch.float64,
                                         device="cpu")
    ym = tm.mult(xt).numpy()
    assert _rel(ym, np.asarray(jax.jit(jm.mult)(jnp.asarray(x)))) < 1e-12
    assert _rel(ym, y_ref) < 1e-12

    perm, iperm = tmf.parity_permutation(mesh)
    jp = jmf.ParityMatFreeOperator.from_matfree(jm, mesh)
    tp = tmf.ParityMatFreeOperator.from_matfree(tm, mesh)
    yp = tp.mult(torch.as_tensor(x[perm])).numpy()
    assert _rel(yp, np.asarray(jax.jit(jp.mult)(jnp.asarray(x[perm])))) < 1e-12
    assert _rel(yp[iperm], y_ref) < 1e-12
    # the flat mult is the tree apply; the factored diagonal is the
    # assembled one
    assert np.array_equal(
        yp, tmf.mult_tree(tp, tmf.tree_aux(tp),
                          torch.as_tensor(x[perm])).numpy())
    assert _rel(tp.diagonal().numpy(), np.asarray(jop.diagonal())[perm]) \
        < 1e-12
    v = torch.as_tensor(x[perm])
    jv = jmf.to_tree(jp, jnp.asarray(x[perm]))
    jw = jmf.to_tree(jp, jnp.asarray(yp))
    assert abs(float(tmf.tree_norm(v)) - float(jmf.tree_norm(jv))) \
        < 1e-12 * np.linalg.norm(x)
    assert abs(float(tmf.tree_dot(v, torch.as_tensor(yp)))
               - float(jmf.tree_dot(jv, jw))) \
        < 1e-12 * np.linalg.norm(x) * np.linalg.norm(yp)


def _host_fgmres(mult, diag, F, k):
    """The port's host KSP: FGMRES(k), k its, convergence test skipped;
    returns the last monitored residual."""
    hist = []
    cfg = KSPConfig(type="fgmres", restart=k, max_it=k,
                    convergence_test="skip",
                    monitor=lambda i, r: hist.append(r))
    KSP(mult, pc=tprecond.PCJacobi(diag, "cpu"), cfg=cfg).solve(F)
    return hist[-1]


def _element_setup():
    case = (3, (3, 3, 3), False, "11", (0.1, 1.0, 1.0))
    jop, top, mesh, _, _, _ = _pair(case)
    F = np.random.default_rng(2).standard_normal(mesh.ndof)
    d = np.asarray(jop.diagonal())
    inv = 1.0 / np.where(d == 0.0, 1.0, d)
    return jop, top, F, d, inv


def test_fgmres_cycle_matches_jax_and_host_ksp():
    jop, top, F, d, inv = _element_setup()
    jx, jr = jax.jit(jcomp.make_fgmres_cycle(
        jop.mult, lambda v: jnp.asarray(inv) * v, 20))(jnp.asarray(F),
                                                       jnp.zeros(len(F)))
    invt, Ft = torch.as_tensor(inv), torch.as_tensor(F)
    tx, tr = tcomp.make_fgmres_cycle(top.mult, lambda v: invt * v, 20)(
        Ft, torch.zeros_like(Ft))
    assert abs(float(tr) - float(jr)) < 1e-10 * float(jr)
    assert _rel(tx.numpy(), np.asarray(jx)) < 1e-10
    host = _host_fgmres(top.mult, d, Ft, 20)
    assert abs(host - float(tr)) < 1e-8 * host


def test_fgmres_restarted_and_chebyshev_match_jax():
    jop, top, F, d, inv = _element_setup()
    invt, Ft = torch.as_tensor(inv), torch.as_tensor(F)
    jx, jr = jcomp.make_fgmres(jop.mult, lambda v: jnp.asarray(inv) * v,
                               8, 3)(jnp.asarray(F), jnp.zeros(len(F)))
    tx, tr = tcomp.make_fgmres(top.mult, lambda v: invt * v, 8, 3)(
        Ft, torch.zeros_like(Ft))
    assert abs(float(tr) - float(jr)) < 1e-10 * float(jr)
    assert _rel(tx.numpy(), np.asarray(jx)) < 1e-10

    # Chebyshev on the (SPD) velocity block with Jacobi, Ritz-like bounds
    nu = top.nu
    du = d[:nu]
    b = F[:nu]
    jsm = jcomp.make_chebyshev(jop.mult_u, lambda v: v / jnp.asarray(du),
                               0.05, 1.8, 6)
    tsm = tcomp.make_chebyshev(top.mult_u,
                               lambda v: v / torch.as_tensor(du), 0.05, 1.8,
                               6)
    jxs = np.asarray(jsm(jnp.asarray(b), jnp.zeros(nu)))
    txs = tsm(torch.as_tensor(b), torch.zeros(nu, dtype=torch.float64))
    assert _rel(txs.numpy(), jxs) < 1e-10


def test_fgmres_cycle_tree_matches_jax_and_host_ksp():
    mesh, jpop, jFp, jdiag = graft._build_flagship_parity(
        mx=4, dtype=jnp.float64)
    _, fes, coeff, bc_idx, _ = graft._assemble_flagship(4)
    bc_mask = np.zeros(mesh.ndof)
    bc_mask[:mesh.nu][bc_idx] = 1.0
    tpop = tmf.ParityMatFreeOperator.build(mesh, fes, coeff, bc_mask,
                                           dtype=torch.float64, device="cpu")
    jinv = 1.0 / jnp.where(jdiag == 0.0, 1.0, jdiag)
    jx, jr = jax.jit(jcomp.make_fgmres_cycle_tree(6))(
        jpop, jmf.tree_aux(jpop), jmf.to_tree(jpop, jinv),
        jmf.to_tree(jpop, jFp), jmf.to_tree(jpop, jnp.zeros_like(jFp)))

    tdiag = tpop.diagonal()
    assert _rel(tdiag.numpy(), np.asarray(jdiag)) < 1e-12
    tinv = 1.0 / torch.where(tdiag == 0.0, torch.ones_like(tdiag), tdiag)
    Ft = torch.as_tensor(np.asarray(jFp))
    tx, tr = tcomp.make_fgmres_cycle_tree(6)(
        tpop, tmf.tree_aux(tpop), tinv, Ft, torch.zeros_like(Ft))
    assert abs(float(tr) - float(jr)) < 1e-10 * float(jr)
    assert _rel(tx.numpy(), np.asarray(jmf.from_tree(jx))) < 1e-10
    host = _host_fgmres(tpop.mult, tdiag.numpy(), Ft, 6)
    assert abs(host - float(tr)) < 1e-8 * host
