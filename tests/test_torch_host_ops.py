"""The port's host KSP/PC stack against the JAX package's, module by module.

The same inputs, made from a seed with numpy, go through the JAX package and
through exsaddle_tpu_torch on the CPU, in float64:

  - operator.SaddleOperator (mult, mult_u/up/pu/p, diagonal) and
    PressureOperator at mx=4, 2D and 3D, Stokes and Lame: 1e-12 relative;
  - precond_mg.Prolongation / BlockDiagProlongation transfers and csr_apply
    (dense and ELL branches): 1e-12 relative;
  - the apply of every preconditioner solver_config builds: 1e-12 relative
    (1e-10 where an inner Krylov solve sits inside the PC);
  - every KSP type, pc side and norm type on the same operator and PC:
    identical iteration counts and reasons, histories to 1e-10 relative.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from exsaddle_tpu import driver as jdriver
from exsaddle_tpu import krylov as jkrylov
from exsaddle_tpu import models as jmodels
from exsaddle_tpu import precond as jprecond
from exsaddle_tpu import precond_mg as jmg
from exsaddle_tpu import solver_config as jsc
from exsaddle_tpu.assembly import FESpace as JFESpace
from exsaddle_tpu.assembly import assemble_element_matrices as j_assemble
from exsaddle_tpu.mesh import SaddleMesh as JMesh
from exsaddle_tpu.operator import apply_dirichlet_elimination as j_elim
from exsaddle_tpu.options import Options as JOptions

from exsaddle_tpu_torch import driver as tdriver
from exsaddle_tpu_torch import krylov as tkrylov
from exsaddle_tpu_torch import models as tmodels
from exsaddle_tpu_torch import precond as tprecond
from exsaddle_tpu_torch import precond_mg as tmg
from exsaddle_tpu_torch import solver_config as tsc
from exsaddle_tpu_torch.assembly import FESpace as TFESpace
from exsaddle_tpu_torch.assembly import assemble_element_matrices as t_assemble
from exsaddle_tpu_torch.mesh import SaddleMesh as TMesh
from exsaddle_tpu_torch.operator import apply_dirichlet_elimination as t_elim
from exsaddle_tpu_torch.options import Options as TOptions

torch.set_num_threads(1)
CPU = torch.device("cpu")
APPLY_TOL = 1e-12


def _quiet(*a, **k):
    pass


def _levels(pkg, ndim, m_el, lame, model, nlevels=1, nranks=1):
    """LevelData list (coarse -> fine) with assembled operators, built by
    one package's own modules exactly as its driver builds them."""
    if pkg == "jax":
        Opt, models, Mesh, FES, drv = (JOptions, jmodels, JMesh, JFESpace,
                                       jdriver)
    else:
        Opt, models, Mesh, FES, drv = (TOptions, tmodels, TMesh, TFESpace,
                                       tdriver)
    opts = Opt.from_args(["-model", model])
    opts.nranks = nranks
    ctx = models.ModelContext(opts, ndim, lame=lame, log=_quiet)
    levels = []
    for k in range(nlevels):
        f = 2 ** k
        coarse = tuple(m // 2 ** (nlevels - 1) for m in m_el)
        mesh = Mesh(ndim, tuple(m * f for m in coarse), (1.0,) * ndim)
        lv = drv.LevelData(mesh=mesh, fes=FES(mesh), coeff_qp=None)
        lv.bc_idx, lv.bc_vals = models.create_bc_list(ctx, mesh)
        levels.append(lv)
    drv._coefficient_pipeline(levels, ctx)
    for lv in levels:
        if pkg == "jax":
            elm = j_assemble(lv.fes, lv.coeff_qp, lame=lame)
            lv.op, lv.rhs_diri, _, _ = j_elim(lv.mesh, elm, lv.bc_idx,
                                              lv.bc_vals)
        else:
            elm = t_assemble(lv.fes, lv.coeff_qp, lame=lame)
            lv.op, lv.rhs_diri, _, _ = t_elim(lv.mesh, elm, lv.bc_idx,
                                              lv.bc_vals, CPU)
    return levels


def _pair(ndim, m_el, lame, model, nlevels=1, nranks=1):
    return (_levels("jax", ndim, m_el, lame, model, nlevels, nranks),
            _levels("torch", ndim, m_el, lame, model, nlevels, nranks))


def _shells(jl, tl, lame, nranks=1, overlap=0):
    dm = {"nranks": nranks, "overlap": overlap}
    return (jdriver._make_saddle_matshell(jl[-1], lame, dm_info=dm),
            tdriver._make_saddle_matshell(tl[-1], lame, CPU, dm_info=dm))


def _close(t, j, tol=APPLY_TOL):
    t = t.numpy() if torch.is_tensor(t) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    scale = max(np.abs(j).max(), 1e-300)
    err = np.abs(t - j).max()
    assert err <= tol * scale, f"max abs err {err:.3e}, scale {scale:.3e}"


def _vec(n, seed):
    return np.random.default_rng(seed).standard_normal(n)


# (ndim, m_el, lame, model)
OP_CASES = [(2, (4, 4), False, "0"), (3, (4, 4, 4), False, "2"),
            (2, (4, 4), True, "6"), (3, (4, 4, 4), True, "6")]


@pytest.mark.parametrize("case", OP_CASES)
def test_saddle_operator_applies(case):
    nd, m_el, lame, model = case
    jl, tl = _pair(nd, m_el, lame, model)
    jop, top = jl[-1].op, tl[-1].op
    nu, np_ = top.nu, top.np_
    x = _vec(nu + np_, 1)
    jx, tx = jnp.asarray(x), torch.as_tensor(x)
    _close(top.mult(tx), jop.mult(jx))
    _close(top.mult_u(tx[:nu]), jop.mult_u(jx[:nu]))
    _close(top.mult_up(tx[nu:]), jop.mult_up(jx[nu:]))
    _close(top.mult_pu(tx[:nu]), jop.mult_pu(jx[:nu]))
    if lame:
        _close(top.mult_p(tx[nu:]), jop.mult_p(jx[nu:]))
    else:
        assert float(top.mult_p(tx[nu:]).abs().max()) == 0.0
    _close(top.diagonal(), jop.diagonal())
    _close(tl[-1].rhs_diri, jl[-1].rhs_diri)
    # host conversions undo the colour order: the same CSR, entry for entry
    jc, tc = jop.to_csr(), top.to_csr()
    assert (jc != tc).nnz == 0
    if nd == 2:
        np.testing.assert_array_equal(top.to_dense(), jop.to_dense())
    # the Schur-pre PressureOperator of the level's MatShell
    jS, tS = jdriver._make_saddle_matshell(jl[-1], lame).Sp, \
        tdriver._make_saddle_matshell(tl[-1], lame, CPU).Sp
    p = _vec(np_, 2)
    _close(tS.apply(torch.as_tensor(p)), jS.apply(jnp.asarray(p)))
    _close(tS.diagonal(), jS.diagonal())
    assert (jS.csr() != tS.csr()).nnz == 0


@pytest.mark.parametrize("ndim", [2, 3])
def test_prolongation_transfers(ndim):
    coarse = (3, 4, 3)[:ndim]
    fine = (5, 7, 5)[:ndim]
    for dof in (1, ndim):
        pj = jmg.Prolongation(coarse, fine, dof)
        pt = tmg.Prolongation(coarse, fine, dof)
        xc, rf = _vec(pt.coarse_n, 3), _vec(pt.fine_n, 4)
        _close(pt.apply(torch.as_tensor(xc)), pj.apply(jnp.asarray(xc)))
        _close(pt.restrict(torch.as_tensor(rf)), pj.restrict(jnp.asarray(rf)))
    Puj, Pup = (jmg.Prolongation(coarse, fine, ndim),
                jmg.Prolongation(coarse, fine, 1))
    Ptu, Ptp = (tmg.Prolongation(coarse, fine, ndim),
                tmg.Prolongation(coarse, fine, 1))
    bj, bt = (jmg.BlockDiagProlongation(Puj, Pup),
              tmg.BlockDiagProlongation(Ptu, Ptp))
    xc, rf = _vec(bt.coarse_n, 5), _vec(bt.fine_n, 6)
    _close(bt.apply(torch.as_tensor(xc)), bj.apply(jnp.asarray(xc)))
    _close(bt.restrict(torch.as_tensor(rf)), bj.restrict(jnp.asarray(rf)))


@pytest.mark.parametrize("max_dense", [4096, 16])
def test_csr_apply_both_branches(max_dense):
    jl, tl = _pair(2, (4, 4), False, "0")
    A = tl[-1].op.to_csr()
    x = _vec(A.shape[0], 7)
    _close(tmg.csr_apply(A, CPU, max_dense=max_dense)(torch.as_tensor(x)),
           jmg.csr_apply(A, max_dense=max_dense)(jnp.asarray(x)))


# (name, extra options, nranks, tolerance): each builds its PC through
# solver_config.make_pc on the 2D mx=4 saddle operator (SOR and MG on its
# A00 block)
PC_CASES = [
    ("none", [], 1, APPLY_TOL),
    ("jacobi", [], 1, APPLY_TOL),
    ("ilu", [], 1, APPLY_TOL),
    ("lu", [], 1, 1e-10),
    ("sor", [], 1, 1e-10),
    ("bjacobi", [], 1, APPLY_TOL),
    ("bjacobi", ["-saddle_sub_pc_type", "lu"], 2, 1e-10),
    ("asm", ["-saddle_pc_asm_dm_subdomains", "-saddle_sub_pc_type", "lu"],
     4, 1e-10),
    ("ildl", ["-saddle_pc_ildl_droptol", "1e-3"], 1, APPLY_TOL),
    ("ilupack", ["-saddle_pc_ilupack_droptol", "1e-3"], 1, APPLY_TOL),
    ("fieldsplit", ["-saddle_fieldsplit_u_pc_type", "lu",
                    "-saddle_fieldsplit_u_ksp_type", "preonly",
                    "-saddle_fieldsplit_p_ksp_max_it", "5"], 1, 1e-10),
    ("mg", ["-saddle_pc_mg_levels", "2", "-saddle_pc_mg_galerkin",
            "-saddle_mg_levels_pc_type", "jacobi"], 1, 1e-10),
]


@pytest.mark.parametrize("name,extra,nranks,tol", PC_CASES,
                         ids=[f"{c[0]}-{c[2]}" for c in PC_CASES])
def test_pc_apply(name, extra, nranks, tol):
    jl, tl = _pair(2, (4, 4), False, "0", nranks=nranks)
    overlap = 1 if name == "asm" else 0
    jA, tA = _shells(jl, tl, False, nranks=nranks, overlap=overlap)
    if name in ("mg", "sor"):   # SPD A00 block (zero p diagonal otherwise)
        jA, tA = jA.fieldsplit["A00"], tA.fieldsplit["A00"]
    argv = ["-saddle_pc_type", name] + extra
    jo, to = JOptions.from_args(argv), TOptions.from_args(argv)
    jo.nranks = to.nranks = nranks
    jpc = jsc.make_pc(jo, "saddle_", jA, jA, log=_quiet)
    tpc = tsc.make_pc(to, "saddle_", tA, tA, log=_quiet)
    x = _vec(tA.n, 8)
    _close(tpc.apply(torch.as_tensor(x)), jpc.apply(jnp.asarray(x)), tol)


def test_pc_saddle_mg_and_additive_fieldsplit():
    """The driver's rediscretised saddle PCMG (2 levels) and the additive
    fieldsplit of ex42's field-based split."""
    jl, tl = _pair(2, (4, 4), False, "0", nlevels=2)
    argv = ["-saddle_mg_levels_ksp_type", "gmres",
            "-saddle_mg_levels_pc_type", "jacobi"]
    jpc = jdriver._build_saddle_mg(JOptions.from_args(argv), "saddle_", jl,
                                   False, False, log=_quiet)
    tpc = tdriver._build_saddle_mg(TOptions.from_args(argv), "saddle_", tl,
                                   False, False, CPU, log=_quiet)
    x = _vec(tl[-1].mesh.ndof, 9)
    _close(tpc.apply(torch.as_tensor(x)), jpc.apply(jnp.asarray(x)), 1e-10)

    jA, tA = _shells(jl, tl, False)
    nu = tl[-1].mesh.nu
    idx = (np.arange(nu), np.arange(nu, tA.n))
    jsplits, tsplits = [], []
    for i, blk in zip(idx, ("A00", "A11")):
        cfg = dict(type="preonly")
        jsplits.append((i, jkrylov.KSP(
            jA.fieldsplit[blk].apply,
            jprecond.PCJacobi(jA.fieldsplit[blk].diagonal()),
            jkrylov.KSPConfig(**cfg))))
        tsplits.append((i, tkrylov.KSP(
            tA.fieldsplit[blk].apply,
            tprecond.PCJacobi(tA.fieldsplit[blk].diagonal(), CPU),
            tkrylov.KSPConfig(**cfg))))
    jpc = jprecond.PCFieldSplitAdditive(jA.n, jsplits)
    tpc = tprecond.PCFieldSplitAdditive(tA.n, tsplits, CPU)
    _close(tpc.apply(torch.as_tensor(x)), jpc.apply(jnp.asarray(x)))


# (type, pc_side, norm_type)
KSP_CASES = ([("gmres", side, norm) for side in ("left", "right")
              for norm in ("preconditioned", "unpreconditioned", "none")]
             + [("fgmres", "right", norm)
                for norm in ("unpreconditioned", "none")]
             + [("gcr", "right", "unpreconditioned")]
             + [("chebyshev", "left", norm)
                for norm in ("preconditioned", "unpreconditioned", "none")]
             + [("richardson", "left", norm)
                for norm in ("preconditioned", "unpreconditioned", "none")]
             + [("preonly", "left", "none")])


@pytest.fixture(scope="module")
def a00_pair():
    jl, tl = _pair(2, (4, 4), False, "0")
    jA, tA = _shells(jl, tl, False)
    return jA.fieldsplit["A00"], tA.fieldsplit["A00"]


@pytest.mark.parametrize("ktype,side,norm", KSP_CASES,
                         ids=["-".join(c) for c in KSP_CASES])
def test_ksp_types(a00_pair, ktype, side, norm):
    """On the A00 block with Jacobi: restart 8 so GMRES and GCR restart,
    max_it 20, rtol 1e-8; Richardson is damped by the Jacobi scaling only
    and may diverge -- both packages must agree on how."""
    jA, tA = a00_pair
    hj, ht = [], []
    kw = dict(type=ktype, pc_side=side, norm_type=norm, max_it=20,
              rtol=1e-8, restart=8)
    if norm == "none" and ktype != "preonly":
        kw["convergence_test"] = "skip"
    jk = jkrylov.KSP(jA.apply, jprecond.PCJacobi(jA.diagonal()),
                     jkrylov.KSPConfig(**kw,
                                       monitor=lambda i, r: hj.append((i, r))))
    tk = tkrylov.KSP(tA.apply, tprecond.PCJacobi(tA.diagonal(), CPU),
                     tkrylov.KSPConfig(**kw,
                                       monitor=lambda i, r: ht.append((i, r))))
    b = _vec(tA.n, 10)
    jr = jk.solve(jnp.asarray(b))
    tr = tk.solve(torch.as_tensor(b))
    assert (tr.its, tr.reason) == (jr.its, jr.reason)
    assert [i for i, _ in ht] == [i for i, _ in hj]
    for (_, a), (_, c) in zip(ht, hj):
        assert abs(a - c) <= 1e-10 * abs(c)
    assert abs(tr.rnorm - jr.rnorm) <= 1e-10 * abs(jr.rnorm)
    _close(tr.x, jr.x, 1e-10)
    assert (tkrylov.converged_reason_message("saddle_", tr)
            == jkrylov.converged_reason_message("saddle_", jr))
