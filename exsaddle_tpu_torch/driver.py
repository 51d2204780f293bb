"""Driver: the abf.opts route of exsaddle_tpu/driver.saddle_solve, in the
PyTorch port.

Pipeline: options -> fine mesh -> BC list -> coefficient evaluation + Q1
projection -> ABF solver setup -> RHS with rhs_diri -> solve -> monitor and
converged-reason lines in the JAX driver's format. Two modes, as the JAX
driver's dispatch:

  direct  ABFSolver.solve in float64;
  -ir     float32 inner solves + float64 iterative refinement to
          -rtol_true (monitor lines are the true float64 residual per round).

-device {cuda,cpu} picks the device, default cuda; with no CUDA device the
default raises instead of falling back. Options trees other than the abf.opts
configuration (exsaddle_tpu/driver.py:_abf_options_match) are refused: the
host KSP/PC stack is not ported yet.

    python -m exsaddle_tpu_torch.driver [-ndim 3] [-device cuda] \
        <abf.opts flags> -model 11 -size_x 0.1 -mx 6 -saddle_ksp_monitor_short
"""

import sys
import time

import torch

from exsaddle_tpu_torch import models as emodels
from exsaddle_tpu_torch.abf import ABFSolver
from exsaddle_tpu_torch.assembly import (FESpace, assemble_rhs,
                                         scatter_vector, project_qp_to_q1,
                                         interp_q1_to_qp)
from exsaddle_tpu_torch.krylov import (converged_reason_message,
                                       make_monitor_short)
from exsaddle_tpu_torch.mesh import SaddleMesh
from exsaddle_tpu_torch.options import Options

# The abf.opts solver tree (abf.opts:1-16) as flags: the option set that
# _abf_options_match accepts.
ABF_OPTS = (
    "-fs -saddle_ksp_type fgmres "
    "-saddle_pc_fieldsplit_type schur "
    "-saddle_pc_fieldsplit_schur_fact_type upper "
    "-saddle_fieldsplit_u_ksp_type gcr -saddle_fieldsplit_u_ksp_rtol 1e-2 "
    "-saddle_fieldsplit_u_pc_type mg -saddle_fieldsplit_u_pc_mg_levels 3 "
    "-saddle_fieldsplit_u_pc_mg_galerkin "
    "-saddle_fieldsplit_u_mg_levels_ksp_type chebyshev "
    "-saddle_fieldsplit_u_mg_levels_ksp_max_it 8 "
    "-saddle_fieldsplit_u_mg_levels_ksp_chebyshev_esteig 0,0.2,0,1.1 "
    "-saddle_fieldsplit_u_mg_levels_pc_type jacobi "
    "-saddle_fieldsplit_p_ksp_type preonly "
    "-saddle_fieldsplit_p_pc_type bjacobi").split()

# flags whose output the port does not produce yet
_UNSUPPORTED = ("mg", "diagnostics", "view_fields", "view_coeffs",
                "dump_solution", "dump_operator", "dump_preconditioner",
                "dump_preconditioned_operator", "dump_smoother",
                "dump_scaled_mass_matrix", "check_solution",
                "constant_pressure_nullspace", "twosolves", "log_view",
                "saddle_ksp_view")


def _abf_options_match(opts, prefix="saddle_"):
    """True when the options tree requests the abf.opts ABF configuration
    (the JAX driver's test, exsaddle_tpu/driver.py:_abf_options_match)."""
    est = opts.get_real_list("fieldsplit_u_mg_levels_ksp_chebyshev_esteig",
                             None, prefix=prefix)
    return (opts.get_bool("fs", False)
            and opts.get_string("ksp_type", "gmres",
                                prefix=prefix) == "fgmres"
            and opts.get_string("fieldsplit_u_ksp_type", "gmres",
                                prefix=prefix) == "gcr"
            and opts.get_string("fieldsplit_u_pc_type", "ilu",
                                prefix=prefix) == "mg"
            and opts.get_bool("fieldsplit_u_pc_mg_galerkin", False,
                              prefix=prefix)
            and opts.get_string("fieldsplit_u_mg_levels_ksp_type",
                                "chebyshev",
                                prefix=prefix) == "chebyshev"
            and opts.get_string("fieldsplit_p_ksp_type", "preonly",
                                prefix=prefix) == "preonly"
            and opts.get_string("pc_fieldsplit_type", "schur",
                                prefix=prefix) == "schur"
            and opts.get_string("pc_fieldsplit_schur_fact_type", "upper",
                                prefix=prefix) == "upper"
            and opts.get_string("fieldsplit_u_mg_levels_pc_type",
                                "jacobi", prefix=prefix) == "jacobi"
            and (est is None or tuple(est) == (0.0, 0.2, 0.0, 1.1))
            and not opts.get_bool("ksp_initial_guess_nonzero", False,
                                  prefix=prefix)
            and opts.get_string("ksp_norm_type", "unpreconditioned",
                                prefix=prefix) == "unpreconditioned"
            and opts.get_string("ksp_pc_side", "right",
                                prefix=prefix) == "right"
            and opts.get_string("fieldsplit_p_pc_type", "bjacobi",
                                prefix=prefix) == "bjacobi"
            and opts.get_string("fieldsplit_p_sub_pc_type", "ilu",
                                prefix=prefix) == "ilu"
            and opts.get_string("fieldsplit_u_mg_coarse_pc_type",
                                "redundant", prefix=prefix) == "redundant"
            and opts.get_string("fieldsplit_u_mg_coarse_ksp_type",
                                "preonly", prefix=prefix) == "preonly"
            and opts.get_string("fieldsplit_u_mg_levels_ksp_norm_type",
                                "none", prefix=prefix) == "none")


def _qp_dict(ctx, cq):
    nel, nqp, _ = cq.shape
    d = emodels.unpack_coefficients(ctx, cq.reshape(nel * nqp, -1))
    out = {"Fu": d["Fu"].reshape(nel, nqp, ctx.ndim),
           "Fp": d["Fp"].reshape(nel, nqp)}
    if ctx.lame:
        out["mu"] = d["mu"].reshape(nel, nqp)
        out["lambda"] = d["lambda"].reshape(nel, nqp)
    else:
        out["eta"] = d["eta"].reshape(nel, nqp)
    return out


def fine_coefficients(ctx, fes):
    """FEMixedSpaceDefineQPwiseProperties_Q1Projection on the fine level
    (femixedspace.c:1937-2266): evaluate at the quadrature points, project
    to Q1 nodes, re-interpolate."""
    pts = fes.qp_coords.reshape(-1, ctx.ndim)
    c = emodels.evaluate_coefficients(ctx, pts).reshape(
        fes.mesh.nel, fes.nqp, -1)
    return _qp_dict(ctx, interp_q1_to_qp(fes, project_qp_to_q1(fes, c)))


def resolve_device(name):
    """torch.device for -device; 'cuda' without a CUDA device raises."""
    if name not in ("cuda", "cpu"):
        raise ValueError(f"-device {name}: expected cuda or cpu")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("-device cuda (the default) but no CUDA device "
                           "is available; pass -device cpu to run the "
                           "plain PyTorch path on the CPU")
    return torch.device(name)


def saddle_solve(opts, ndim, lame=False, log=print):
    """The abf.opts route of the reference's SaddleSolve_Q2Q1. Returns a
    dict with X (natural ordering, numpy), reason, its, rnorm, history,
    mesh, F, solver and the raw solver result."""
    prefix = "saddle_"
    device = resolve_device(opts.get_string("device", "cuda"))
    t0 = time.perf_counter()
    mx = opts.get_int("mx", 4)
    my = opts.get_int("my", mx)
    mz = opts.get_int("mz", mx)
    size = [opts.get_real("size_x", 1.0), opts.get_real("size_y", 1.0)]
    if ndim == 3:
        size.append(opts.get_real("size_z", 1.0))
    nlevels = opts.get_int("nlevels", 1)
    bad = [f for f in _UNSUPPORTED if opts.get_bool(f, False)]
    if not _abf_options_match(opts) or nlevels != 1 or bad:
        raise ValueError(
            "exsaddle_tpu_torch runs the abf.opts ABF configuration only "
            "(see driver.ABF_OPTS); the host KSP/PC stack, -mg -nlevels and "
            f"the output flags {bad or ''} are not ported yet")
    ir_flag = opts.get_bool("ir", False)
    rtol_true = opts.get_real("rtol_true", 1e-8)

    ctx = emodels.ModelContext(opts, ndim, lame=lame, log=log)
    m_el = (mx, my) if ndim == 2 else (mx, my, mz)
    mesh = SaddleMesh(ndim, m_el, tuple(size))
    fes = FESpace(mesh)
    bc_idx, bc_vals = emodels.create_bc_list(ctx, mesh)
    # banner-order parity with the JAX driver: the model banner fires on
    # the first qp evaluation
    emodels.evaluate_coefficients(ctx, fes.qp_coords.reshape(-1, ndim)[:1])
    coeff = fine_coefficients(ctx, fes)

    max_it = opts.get_int("ksp_max_it", 10000, prefix=prefix)
    cfg_kw = dict(
        nlevels=opts.get_int("fieldsplit_u_pc_mg_levels", 3, prefix=prefix),
        restart=opts.get_int("ksp_gmres_restart", 30, prefix=prefix),
        rtol=opts.get_real("ksp_rtol", 1e-5, prefix=prefix),
        atol=opts.get_real("ksp_atol", 1e-50, prefix=prefix),
        dtol=opts.get_real("ksp_divtol", 1e4, prefix=prefix),
        max_it=max_it,
        hist_len=max(256, min(max_it, 100000) + 1),
        gcr_rtol=opts.get_real("fieldsplit_u_ksp_rtol", 1e-5, prefix=prefix),
        gcr_restart=opts.get_int("fieldsplit_u_ksp_gcr_restart", 30,
                                 prefix=prefix),
        gcr_max_it=opts.get_int("fieldsplit_u_ksp_max_it", 200,
                                prefix=prefix),
        cheb_its=opts.get_int("fieldsplit_u_mg_levels_ksp_max_it", 8,
                              prefix=prefix))
    slv = ABFSolver(mesh, fes, coeff, bc_idx, bc_vals, device=device,
                    lame=lame, ir=ir_flag,
                    dtype=torch.float32 if ir_flag else torch.float64,
                    **cfg_kw)

    # RHS (exSaddle.c:273-282)
    f1, f2 = assemble_rhs(fes, coeff["Fu"], coeff["Fp"])
    F = scatter_vector(mesh, f1, f2)
    F[: mesh.nu][bc_idx] = bc_vals
    F = F + slv.setup["rhs_diri"]
    t_setup = time.perf_counter() - t0

    t0 = time.perf_counter()
    if ir_flag:
        res = slv.solve_ir(F, rtol=rtol_true)
        its = res["inner_its"]
        reason = "CONVERGED_RTOL" if res["converged"] else "DIVERGED_ITS"
    else:
        res = slv.solve(F)
        its = res["its"]
        reason = res["reason"]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_solve = time.perf_counter() - t0
    if opts.get_bool("ksp_monitor_short", False, prefix=prefix):
        monitor = make_monitor_short(prefix, log=log)
        for i, rn in enumerate(res["history"]):
            monitor(i, rn)
    if opts.get_bool("ksp_converged_reason", False, prefix=prefix):
        log(converged_reason_message(prefix, reason, its))
    return {"X": res["x"], "reason": reason, "its": its,
            "rnorm": res["rnorm"], "history": res["history"], "mesh": mesh,
            "F": F, "solver": slv, "res": res,
            "seconds": {"setup": t_setup, "solve": t_solve}}


def main(argv=None, ndim=3, lame=False):
    """CLI entry point."""
    args = sys.argv[1:] if argv is None else argv
    saddle_solve(Options.from_args(args), ndim, lame=lame)


if __name__ == "__main__":
    _args = sys.argv[1:]
    _ndim, _lame, _rest = 3, False, []
    _i = 0
    while _i < len(_args):
        if _args[_i] == "-ndim":
            _ndim = int(_args[_i + 1])
            _i += 2
        elif _args[_i] == "-lame":
            _lame = True
            _i += 1
        else:
            _rest.append(_args[_i])
            _i += 1
    main(_rest, ndim=_ndim, lame=_lame)
