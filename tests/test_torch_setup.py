"""The PyTorch port's host setup against the JAX package: its copies of the
mesh, FE space, coefficient pipeline, BCs, RHS, factored operator data and
the whole ABF build (stencils, Jacobi diagonals, esteig bounds, coarse
inverse, Schur weights) must produce EXACTLY the same arrays -- they are the
same numpy arithmetic, so any difference is a copying error."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from exsaddle_tpu import abf as jabf
from exsaddle_tpu import assembly as jasm
from exsaddle_tpu import driver as jdriver
from exsaddle_tpu import matfree as jmf
from exsaddle_tpu import models as jmodels
from exsaddle_tpu import precond_mg as jmg
from exsaddle_tpu.mesh import SaddleMesh as JMesh
from exsaddle_tpu.options import Options as JOptions

from exsaddle_tpu_torch import abf as tabf
from exsaddle_tpu_torch import assembly as tasm
from exsaddle_tpu_torch import driver as tdriver
from exsaddle_tpu_torch import matfree as tmf
from exsaddle_tpu_torch import models as tmodels
from exsaddle_tpu_torch import precond_mg as tmg
from exsaddle_tpu_torch.mesh import SaddleMesh as TMesh
from exsaddle_tpu_torch.options import Options as TOptions

# one intra-op thread: the suite runs several test processes side by
# side, and these small CPU solves gain nothing from more threads
torch.set_num_threads(1)

# (name, ndim, m_el, size, model): mx=4 pseudoice and 2D SolCx
CASES = [("pseudoice", 3, (4, 4, 4), (0.1, 1.0, 1.0), 11),
         ("solcx2d", 2, (8, 8), (1.0, 1.0), 0)]
IDS = [c[0] for c in CASES]


def _args(ndim, size, model):
    names = ["-size_x", "-size_y", "-size_z"][:ndim]
    return ["-model", str(model)] + sum(
        ([n, str(v)] for n, v in zip(names, size)), [])


def _side(pkg, ndim, m_el, size, model):
    """Fine-level problem through one package's modules."""
    Options, Mesh, models, asm, qp_dict = pkg
    opts = Options.from_args(_args(ndim, size, model))
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
    return {"mesh": mesh, "fes": fes, "coeff": coeff, "bc_idx": bc_idx,
            "bc_vals": bc_vals, "F": F, "c": c}


JAX = (JOptions, JMesh, jmodels, jasm, jdriver._qp_dict)
TORCH = (TOptions, TMesh, tmodels, tasm, tdriver._qp_dict)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fe_setup_is_identical(case):
    _, ndim, m_el, size, model = case
    j = _side(JAX, ndim, m_el, size, model)
    t = _side(TORCH, ndim, m_el, size, model)
    jm, tm = j["mesh"], t["mesh"]
    for name in ("u_el_dofs", "p_el_nodes", "u_coords", "p_coords"):
        assert _same(getattr(tm, name), getattr(jm, name)), name
    for name in ("detJ_u", "dNu_glob", "detJ_p", "qp_coords", "Nu", "Np"):
        assert _same(getattr(t["fes"], name), getattr(j["fes"], name)), name
    assert _same(t["c"], j["c"])
    assert sorted(t["coeff"]) == sorted(j["coeff"])
    for k in j["coeff"]:
        assert _same(t["coeff"][k], j["coeff"][k]), k
    assert _same(t["bc_idx"], j["bc_idx"])
    assert _same(t["bc_vals"], j["bc_vals"])
    assert _same(t["F"], j["F"])
    fj = jmf.factored_host(jm, j["fes"], j["coeff"])
    ft = tmf.factored_host(tm, t["fes"], t["coeff"])
    for k in fj:
        assert _same(ft[k], fj[k]), k
    assert all(_same(a, b) for a, b in zip(tmf.parity_permutation(tm),
                                           jmf.parity_permutation(jm)))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_prolongation_is_identical(case):
    _, ndim, m_el, _, _ = case
    fine = tuple(2 * m + 1 for m in m_el)
    coarse = tuple((n + 1) // 2 for n in fine)
    pj = jmg.Prolongation(coarse, fine, ndim)
    pt = tmg.Prolongation(coarse, fine, ndim)
    assert _same(pt.cidx, pj.cidx) and _same(pt.wts, pj.wts)
    assert (pt.to_scipy() != pj.to_scipy()).nnz == 0
    assert _same(pt.restriction_scale(), pj.restriction_scale())
    A = (pj.to_scipy() @ pj.to_scipy().T).tocsr()
    for Aj, At in zip(jmg.galerkin_coarse_operators(A, [pj], dof=ndim),
                      tmg.galerkin_coarse_operators(A, [pt], dof=ndim)):
        assert _same(At.indptr, Aj.indptr) and _same(At.indices, Aj.indices)
        assert _same(At.data, Aj.data)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_build_abf_is_identical(case):
    """The ABF setup: rhs_diri, Jacobi diagonals, esteig bounds, block
    stencils, coarse inverse, Schur weights and bounds; also after the
    JAX-output route (data_from_numpy)."""
    _, ndim, m_el, size, model = case
    j = _side(JAX, ndim, m_el, size, model)
    t = _side(TORCH, ndim, m_el, size, model)
    jcfg, jdata, jsetup = jabf.build_abf(j["mesh"], j["fes"], j["coeff"],
                                         j["bc_idx"], j["bc_vals"],
                                         dtype=jnp.float64, nlevels=3)
    tcfg, tdata, tsetup = tabf.build_abf(t["mesh"], t["fes"], t["coeff"],
                                         t["bc_idx"], t["bc_vals"],
                                         device="cpu", dtype=torch.float64,
                                         nlevels=3)
    jdata = jax.device_get(jdata)
    for k in ("rhs_diri", "bc_mask", "x_bc", "perm", "iperm"):
        assert _same(tsetup[k], jsetup[k]), k
    for a, b in zip(tsetup["stencils_w"], jsetup["stencils_w"]):
        assert _same(a, b)
    for a, b in zip(tsetup["coarse_csrs"], jsetup["coarse_csrs"]):
        assert (a != b).nnz == 0
    assert (tsetup["Mp"] != jsetup["Mp"]).nnz == 0
    for k in ("level_grids", "cls_shapes", "m_el", "nlevels"):
        assert getattr(tcfg, k) == getattr(jcfg, k), k

    def check_data(tdata):
        assert _same(tdata["inv_diag_fine"].numpy(),
                     np.concatenate([np.asarray(a).reshape(-1)
                                     for a in jdata["inv_diag_fine"]]))
        for a, b in zip(tdata["inv_diag_lvls"], jdata["inv_diag_lvls"]):
            assert _same(a.numpy(), b)
        for (t0, t1), (j0, j1) in zip(tdata["bounds"], jdata["bounds"]):
            assert t0 == j0 and t1 == j1
        assert tdata["p_bounds"] == tuple(np.asarray(b)
                                          for b in jdata["p_bounds"])
        for k in ("coarse_inv", "pscale", "inv_diag_p"):
            assert _same(tdata[k].numpy(), jdata[k]), k
        for a, b in zip(tdata["stencils"], jsetup["stencils_w"]):
            assert _same(a.numpy(), b)
        jop, top = jdata["op"], tdata["op"]
        for k in ("Bs", "Dm", "Np", "scale_visc", "fac", "facp_lam", "keep",
                  "bc_mask"):
            assert _same(getattr(top, k).numpy(), getattr(jop, k)), k
        assert top.cls_shapes == jop.cls_shapes

    check_data(tdata)
    _, ndata, nsetup = tabf.data_from_numpy(
        dataclasses.asdict(jcfg), jdata, jax.device_get(jsetup), "cpu",
        torch.float64)
    check_data(ndata)
    for k in ("Bs", "scale_visc", "keep", "bc_mask"):
        assert _same(getattr(nsetup["op64"], k).numpy(),
                     getattr(tsetup["op64"], k).numpy()), k
