"""Driver: end-to-end saddle solve in the PyTorch port, the counterpart of
exsaddle_tpu/driver.saddle_solve (the reference's SaddleSolve_Q2Q1,
exSaddle.c:124-566).

Pipeline: options -> MG mesh hierarchy -> BC lists -> coefficient evaluation
+ Q1 projection + restriction chain -> solver -> diagnostics / error checks
/ -ksp_view / VTK views and dumps. Output lines reproduce the reference's
stdout. Two routes, as the JAX driver's one-binary dispatch:

  ABF   the abf.opts tree (_abf_options_match) on one level: the factored
        ABFSolver, direct float64, or with -ir float32 inner solves + float64
        iterative refinement to -rtol_true (monitor lines are then the true
        float64 residual per round). This is the default for that tree;
        -tpu 0 sends it to the host route instead. Handed more than one
        device (saddle_solve's `devices`), it solves in float64 on the
        cartesian device grid _choose_dev_shape picks
        (parallel/cart_abf.CartABFSolver, mode "cart").
  host  every other tree, and abf.opts under -tpu 0, -constant_pressure_
        nullspace, virtual ranks or an introspection flag (-saddle_ksp_view
        and every -dump_* flag but -dump_solution): per-level element
        assembly with Dirichlet elimination into operator.SaddleOperator,
        MatShells with fieldsplit/MG/DM and -ksp_view info, and the KSP/PC
        tree built from the options (solver_config), including the
        programmatic rediscretised saddle PCMG of -mg -nlevels N.

-view_fields, -view_coeffs and -dump_solution write their files on both
routes.

-device {cuda,cpu} picks the device, default cuda; with no CUDA device the
default raises instead of falling back. The ABF route's devices default to
every visible CUDA device under -device cuda and to the CPU under -device
cpu; a caller may hand saddle_solve a list with repeats (4 shards on one
card).

    python -m exsaddle_tpu_torch.driver [-ndim 3] [-lame] [-device cuda] \\
        -model 2 -sinker_n 1 -mx 8 -mg -nlevels 2 -saddle_ksp_type fgmres \\
        -saddle_mg_levels_ksp_type gmres -saddle_mg_levels_pc_type jacobi \\
        -saddle_mg_levels_ksp_max_it 10 -saddle_ksp_monitor_short
"""

import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from exsaddle_tpu_torch import io as esio
from exsaddle_tpu_torch import models as emodels
from exsaddle_tpu_torch import solver_config as sc
from exsaddle_tpu_torch.assembly import (FESpace, assemble_element_matrices,
                                         assemble_rhs, assemble_schur_pre,
                                         scatter_vector, project_qp_to_q1,
                                         interp_q1_to_qp)
from exsaddle_tpu_torch.matfree import allocated_nnz, coupling_nnz
from exsaddle_tpu_torch.krylov import (KSPConfig, KSPResult, Reason,
                                       converged_reason_message,
                                       make_monitor_short)
from exsaddle_tpu_torch.mesh import SaddleMesh
from exsaddle_tpu_torch.operator import (apply_dirichlet_elimination,
                                         PressureOperator)
from exsaddle_tpu_torch.options import Options
from exsaddle_tpu_torch.precond_mg import Prolongation, BlockDiagProlongation

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


@dataclass
class LevelData:
    mesh: SaddleMesh
    fes: FESpace
    coeff_qp: dict          # per-qp coefficient dict (post-projection)
    op: object = None       # operator.SaddleOperator
    rhs_diri: object = None
    bc_idx: object = None
    bc_vals: object = None


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


def _fine_nodal(ctx, fes):
    """Coefficients evaluated at the quadrature points and projected to the
    Q1 nodes: (n_p_nodes, ncoef)."""
    pts = fes.qp_coords.reshape(-1, ctx.ndim)
    c = emodels.evaluate_coefficients(ctx, pts).reshape(
        fes.mesh.nel, fes.nqp, -1)
    return project_qp_to_q1(fes, c)


def fine_coefficients(ctx, fes):
    """FEMixedSpaceDefineQPwiseProperties_Q1Projection on the fine level
    (femixedspace.c:1937-2266): evaluate at the quadrature points, project
    to Q1 nodes, re-interpolate."""
    return _qp_dict(ctx, interp_q1_to_qp(fes, _fine_nodal(ctx, fes)))


def _coefficient_pipeline(levels, ctx):
    """FEMixedSpaceDefineQPwiseProperties_Q1Projection
    (femixedspace.c:1937-2266): evaluate at fine qps, project to Q1 nodes,
    re-interpolate; coarse levels by scaled restriction of the nodal fields.
    """
    nlev = len(levels)
    fine = levels[-1]
    nodal = _fine_nodal(ctx, fine.fes)
    fine.coeff_qp = _qp_dict(ctx, interp_q1_to_qp(fine.fes, nodal))

    view_coeffs = ctx.opts.get_bool("view_coeffs", False)

    def _dump_coeffs(lvl_idx, lvl, nod):
        """-view_coeffs: nodal Q1 coefficient fields as VTK
        (femixedspace.c:2092-2123, 2224-2254)."""
        names = (["mu", "Fu_x", "Fu_y", "Fp", "lambda", "Fu_z"][:nod.shape[1]]
                 if ctx.lame else
                 ["eta", "Fu_x", "Fu_y", "Fp", "Fu_z"][:nod.shape[1]])
        esio.write_vts(f"coeffs_{lvl_idx}.vts", lvl.mesh.nn_p,
                       lvl.mesh.p_coords,
                       {nm: nod[:, j] for j, nm in enumerate(names)})

    if view_coeffs:
        _dump_coeffs(nlev - 1, fine, nodal)

    nodal_f = nodal
    for k in range(nlev - 2, -1, -1):
        P = Prolongation(levels[k].mesh.nn_p, levels[k + 1].mesh.nn_p, dof=1)
        scale = P.restriction_scale()
        nodal_c = np.stack(
            [P.restrict(torch.from_numpy(
                np.ascontiguousarray(nodal_f[:, j]))).numpy() * scale
             for j in range(nodal_f.shape[1])], axis=1)
        levels[k].coeff_qp = _qp_dict(
            ctx, interp_q1_to_qp(levels[k].fes, nodal_c))
        if view_coeffs:
            _dump_coeffs(k, levels[k], nodal_c)
        nodal_f = nodal_c


def _make_saddle_matshell(lv, lame, device, dm_info=None,
                          names=("Asaddle", "Mpscaled")):
    """MatShell for a level's saddle operator, with fieldsplit block info,
    velocity-grid MG info, and DM decomposition info (for -pc_type asm
    virtual-rank subdomains) attached.

    names: (saddle matrix name, Schur-pre name) for -ksp_view. The
    reference names ONLY the fine-level objects "Asaddle"/"Mpscaled"
    (exSaddle.c:272,316) and the fs_coarse Schur-pre "Mpscaled_coarse"
    (exSaddle.c:369); rediscretized coarse saddle matrices are unnamed."""
    op = lv.op
    mesh = lv.mesh
    A00 = sc.MatShell(
        mesh.nu, op.mult_u, device,
        diagonal=lambda: op.diagonal()[: mesh.nu],
        csr=lambda: op.to_csr()[: mesh.nu, : mesh.nu].tocsr(),
        mg_info={"node_nn": mesh.nn_u, "dof": mesh.ndim})
    A11p = sc.MatShell(
        mesh.np_, op.mult_p, device,
        diagonal=lambda: op.diagonal()[mesh.nu:],
        csr=lambda: op.to_csr()[mesh.nu:, mesh.nu:].tocsr())
    Sel = assemble_schur_pre(lv.fes, lv.coeff_qp, lame=lame)
    pop = PressureOperator.build(mesh, Sel, device)
    Sp = sc.MatShell(mesh.np_, pop.mult, device, diagonal=pop.diagonal,
                     csr=pop.to_csr)
    fieldsplit = {"A00": A00, "A11": A11p, "mult_up": op.mult_up,
                  "mult_pu": op.mult_pu, "Sp": Sp}
    amat = sc.MatShell(mesh.ndof, op.mult, device, diagonal=op.diagonal,
                       csr=op.to_csr, fieldsplit=fieldsplit)
    amat.Sp = Sp
    # -ksp_view metadata (ksp_view.py): names, the reference's
    # preallocation estimate, I-node counts (dof-triple velocity rows
    # coalesce; pressure rows do not), coupling-block sizes
    amat.view_info = {"name": names[0],
                      "allocated": allocated_nnz(mesh),
                      "inode": mesh.n_u_nodes + mesh.np_}
    A00.view_info = {"inode": mesh.n_u_nodes}
    Sp.view_info = {"name": names[1]}
    fieldsplit["view"] = {"A10_nnz": coupling_nnz(mesh),
                          "A01_inode": mesh.n_u_nodes,
                          "A00_n": mesh.nu}
    if dm_info is not None:
        amat.dm_info = dict(dm_info, mesh=mesh)
        nranks = dm_info["nranks"]
        if nranks > 1:
            from exsaddle_tpu_torch import decomp
            blocks = decomp.bjacobi_block_ranges(mesh, nranks)
            amat.block_info = blocks
            A00.block_info = [b[b < mesh.nu] for b in blocks]
            pblocks = [b[b >= mesh.nu] - mesh.nu for b in blocks]
            A11p.block_info = pblocks
            Sp.block_info = pblocks
    return amat


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


class _ABFKSPShim:
    """Duck-typed stand-in for the host KSP on the ABF route (the JAX
    driver's _JittedKSPShim): carries .solve / .cfg so -twosolves and the
    result plumbing work unchanged. solve takes and returns numpy vectors;
    `last` keeps the ABF solver's own result dict."""

    def __init__(self, slv, monitor, reason_log, prefix, ir=False,
                 rtol_true=1e-8):
        self._slv = slv
        self._ir = ir
        self._rtol_true = rtol_true
        self.cfg = KSPConfig(type="fgmres", prefix=prefix)
        self.cfg.monitor = monitor
        self.cfg.converged_reason_log = reason_log
        self.pc = None
        self.last = None

    def solve(self, F):
        if self._ir:
            res = self._slv.solve_ir(F, rtol=self._rtol_true)
            its = res["inner_its"]
            reason = ("CONVERGED_RTOL" if res["converged"]
                      else "DIVERGED_ITS")
        else:
            res = self._slv.solve(F)
            its = res["its"]
            reason = res["reason"]
        self.last = res
        if self.cfg.monitor is not None:
            for i, rn in enumerate(res["history"]):
                self.cfg.monitor(i, rn)
        out = KSPResult(res["x"], its, reason, res["rnorm"])
        if self.cfg.converged_reason_log is not None:
            self.cfg.converged_reason_log(
                converged_reason_message(self.cfg.prefix, out))
        return out


def resolve_device(name):
    """torch.device for -device; 'cuda' without a CUDA device raises."""
    if name not in ("cuda", "cpu"):
        raise ValueError(f"-device {name}: expected cuda or cpu")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("-device cuda (the default) but no CUDA device "
                           "is available; pass -device cpu to run the "
                           "plain PyTorch path on the CPU")
    return torch.device(name)


def default_devices(device):
    """The ABF route's devices for -device: every visible CUDA device, or
    the CPU."""
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def _choose_dev_shape(m_el, ndev):
    """Cartesian device grid for `ndev` devices over `m_el` elements (the
    JAX driver's choice): prime factors of ndev assigned largest-first to
    the axis with the largest local element count that divides (balanced
    slabs, z-major tie-break so single-axis splits land on the outermost
    axis -- the cross-host layout of parallel.multihost.host_partition).
    Returns None when ndev does not factor into the mesh (the caller falls
    back to the single-device solver)."""
    nd = len(m_el)
    shape = [1] * nd
    mloc = list(m_el)
    rem = ndev
    factors = []
    f = 2
    while f * f <= rem:
        while rem % f == 0:
            factors.append(f)
            rem //= f
        f += 1
    if rem > 1:
        factors.append(rem)
    for f in sorted(factors, reverse=True):
        cands = [d for d in range(nd) if mloc[d] % f == 0]
        if not cands:
            return None
        d = max(cands, key=lambda d: (mloc[d], d))
        shape[d] *= f
        mloc[d] //= f
    return tuple(shape)


def _check_device_counts(n, world):
    """Check with one collective that every rank of a group of `world`
    processes hands the same device count n."""
    if world == 1:
        return
    got = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    torch.distributed.all_gather(got, torch.tensor([n]))
    counts = [int(c) for c in got]
    if len(set(counts)) != 1:
        raise ValueError("every process of the group must hand the same "
                         f"number of devices; ranks hand {counts}")


def _numpy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def saddle_solve(opts, ndim, lame=False, log=print, nranks=1, devices=None):
    """The reference's SaddleSolve_Q2Q1. Returns a dict with X (natural
    ordering, numpy), result (KSPResult; on the host route its x is the
    device tensor), mesh, levels, ksp, F (numpy), reason, its, rnorm and
    seconds {setup, solve}; the ABF route adds history, solver, res (the
    ABF solver's own result dict), mode ("direct", "ir" or "cart") and
    loop (who ran the Krylov loops: "device" -- one CUDA graph with
    conditional nodes, the default on CUDA, and for a sharded solve whose
    shards all sit on one CUDA device in one process -- or "host";
    abf.ABFSolver, parallel/cart_abf.CartABFSolver).

    devices: the ABF route's devices, one per shard, repeats allowed
    (default_devices(-device) when None); with more than one the solve is
    sharded over them. Inside a torch.distributed group of W processes
    (multihost.initialize) every rank calls this with the same count L of
    its own devices: the solve is sharded over W * L shards, each process
    assembling and holding its own, and every rank returns the same
    result."""
    device = resolve_device(opts.get_string("device", "cuda"))
    mx = opts.get_int("mx", 4)
    my = opts.get_int("my", mx)
    mz = opts.get_int("mz", mx)
    size = [opts.get_real("size_x", 1.0), opts.get_real("size_y", 1.0)]
    if ndim == 3:
        size.append(opts.get_real("size_z", 1.0))
    fs = opts.get_bool("fs", False)
    mg = opts.get_bool("mg", False)
    fs_coarse = opts.get_bool("fs_coarse", False)
    opts.get_bool("set_ksp_dm", False)   # consumed; DM-attachment is implicit
    nlevels = opts.get_int("nlevels", 1)
    refinefactor = opts.get_int("refinefactor", 2)
    diagnostics = opts.get_bool("diagnostics", False)
    view_fields = opts.get_bool("view_fields", False)
    dump_solution = opts.get_bool("dump_solution", False)
    dump_operator = opts.get_bool("dump_operator", False)
    twosolves = opts.get_bool("twosolves", False)
    dump_pc = opts.get_bool("dump_preconditioner", False)
    dump_pc_op = opts.get_bool("dump_preconditioned_operator", False)
    dump_smoother = opts.get_bool("dump_smoother", False)
    dump_mpscaled = opts.get_bool("dump_scaled_mass_matrix", False)
    check_solution = opts.get_bool("check_solution", False)
    nullspace_flag = opts.get_bool("constant_pressure_nullspace", False)

    if fs and mg:
        raise ValueError("both -fs and -mg supplied")
    if nlevels < 1:
        raise ValueError("-nlevels < 1 supplied")
    if nlevels > 1 and fs:
        raise ValueError("-nlevels > 1 specified with -fs")
    if nlevels > 1 and not mg:
        raise ValueError("-nlevels > 1 specified without -mg")
    if nlevels < 2 and mg:
        raise ValueError("-nlevels < 2 specified with -mg")
    if fs_coarse and not mg:
        raise ValueError("-fs_coarse supplied without -mg")

    log_view = opts.get_bool("log_view", False)
    stage_t = {}                  # PetscLogStage equivalent (SURVEY.md sec 5)
    _t0 = time.perf_counter()

    m_el = (mx, my) if ndim == 2 else (mx, my, mz)
    ratio = refinefactor ** (nlevels - 1)
    if nlevels > 1:
        for m in m_el:
            if ratio > m or m % ratio:
                raise ValueError(
                    "Coarsening ratio incompatible with problem size")
    coarse_el = tuple(m // ratio for m in m_el)

    opts.nranks = nranks          # ambient comm size for parallel defaults
    ctx = emodels.ModelContext(opts, ndim, lame=lame, log=log)

    # --- levels, coarse -> fine (exSaddle.c:226-239) ---
    levels = []
    for k in range(nlevels):
        f = refinefactor ** k
        mesh = SaddleMesh(ndim, tuple(m * f for m in coarse_el), tuple(size))
        fes = FESpace(mesh)
        bc_idx, bc_vals = emodels.create_bc_list(ctx, mesh)
        # raw banner-order parity: model evaluation banner fires on the
        # coarsest level's qp evaluation
        emodels.evaluate_coefficients(
            ctx, fes.qp_coords.reshape(-1, ndim)[:1])
        lv = LevelData(mesh=mesh, fes=fes, coeff_qp=None)
        lv.bc_idx, lv.bc_vals = bc_idx, bc_vals
        levels.append(lv)

    _coefficient_pipeline(levels, ctx)
    fine = levels[-1]
    mesh = fine.mesh
    prefix = "saddle_"

    # --- dispatch: the abf.opts tree takes the ABF route unless -tpu 0,
    # a nullspace, virtual ranks or a host-KSP introspection flag ask for
    # the host stack ---
    introspect = (opts.get_bool("ksp_view", False, prefix=prefix)
                  or dump_pc or dump_pc_op or dump_smoother
                  or dump_mpscaled or dump_operator or nullspace_flag
                  or nranks > 1)
    tpu_flag = opts.get_bool("tpu", None)
    ir_flag = opts.get_bool("ir", False)
    rtol_true = opts.get_real("rtol_true", 1e-8)
    use_abf = _abf_options_match(opts) and not introspect and nlevels == 1
    if tpu_flag is not None:
        use_abf = use_abf and bool(tpu_flag)

    # --- assembly per level (exSaddle.c:265-270); the ABF route builds
    # its factored operator itself and never needs element batches. The
    # numpy batches are dropped as soon as each level is on the device ---
    if not use_abf:
        for lv in levels:
            elm = assemble_element_matrices(lv.fes, lv.coeff_qp, lame=lame)
            lv.op, lv.rhs_diri, _, _ = apply_dirichlet_elimination(
                lv.mesh, elm, lv.bc_idx, lv.bc_vals, device)
            del elm

    ksp = None
    slv = None
    amat = None
    if use_abf:
        from exsaddle_tpu_torch.abf import ABFSolver
        max_it = opts.get_int("ksp_max_it", 10000, prefix=prefix)
        cfg_kw = dict(
            nlevels=opts.get_int("fieldsplit_u_pc_mg_levels", 3,
                                 prefix=prefix),
            restart=opts.get_int("ksp_gmres_restart", 30, prefix=prefix),
            rtol=opts.get_real("ksp_rtol", 1e-5, prefix=prefix),
            atol=opts.get_real("ksp_atol", 1e-50, prefix=prefix),
            dtol=opts.get_real("ksp_divtol", 1e4, prefix=prefix),
            max_it=max_it,
            hist_len=max(256, min(max_it, 100000) + 1),
            gcr_rtol=opts.get_real("fieldsplit_u_ksp_rtol", 1e-5,
                                   prefix=prefix),
            gcr_restart=opts.get_int("fieldsplit_u_ksp_gcr_restart", 30,
                                     prefix=prefix),
            gcr_max_it=opts.get_int("fieldsplit_u_ksp_max_it", 200,
                                    prefix=prefix),
            cheb_its=opts.get_int("fieldsplit_u_mg_levels_ksp_max_it", 8,
                                  prefix=prefix))
        devices = (default_devices(device) if devices is None
                   else [torch.device(d) for d in devices])
        # more than one shard: the cartesian device grid (the mpiexec -n
        # N leg of the reference's one executable) when the element grid
        # factors over it. In a torch.distributed group of W processes
        # each hands its own devices and the grid spans W times as many
        from exsaddle_tpu_torch.parallel import multihost
        world, _ = multihost.process_identity()
        _check_device_counts(len(devices), world)
        nshards = world * len(devices)
        cart_shape = (_choose_dev_shape(m_el, nshards)
                      if nshards > 1 else None)
        if world > 1 and cart_shape is None:
            raise ValueError(f"{nshards} shards over {world} processes do "
                             f"not factor into the element grid {m_el}")
        if cart_shape is not None:
            from exsaddle_tpu_torch.parallel.cart import CartPartition
            from exsaddle_tpu_torch.parallel.cart_abf import CartABFSolver
            if ir_flag:
                log("# -ir: distributed solve runs directly in float64 "
                    "(mixed-precision refinement is the single-device "
                    "path); -rtol_true ignored")
                ir_flag = False
            # each process assembles only its own boxes (local_boxes,
            # which raises when W does not divide the outermost grid axis,
            # the host axis) and the setup partials are summed across the
            # group (the JAX driver's HostComm under jax.process_count() > 1)
            comm = multihost.HostComm() if world > 1 else None
            slv = CartABFSolver(CartPartition(mesh, cart_shape), ctx,
                                fine.bc_idx, fine.bc_vals, devices,
                                lame=lame, multihost=comm, **cfg_kw)
            mode = "cart"
        else:
            slv = ABFSolver(mesh, fine.fes, fine.coeff_qp, fine.bc_idx,
                            fine.bc_vals, device=device, lame=lame,
                            ir=ir_flag,
                            dtype=torch.float32 if ir_flag
                            else torch.float64, **cfg_kw)
            mode = "ir" if ir_flag else "direct"
        fine.rhs_diri = slv.setup["rhs_diri"]
        monitor = (make_monitor_short(prefix, log=log)
                   if opts.get_bool("ksp_monitor_short", False,
                                    prefix=prefix) else None)
        reason_log = (log if opts.get_bool("ksp_converged_reason", False,
                                           prefix=prefix) else None)
        ksp = _ABFKSPShim(slv, monitor, reason_log, prefix, ir=ir_flag,
                          rtol_true=rtol_true)

    # --- RHS (exSaddle.c:273-282) ---
    f1, f2 = assemble_rhs(fine.fes, fine.coeff_qp["Fu"], fine.coeff_qp["Fp"])
    F = scatter_vector(mesh, f1, f2)
    F[: mesh.nu][fine.bc_idx] = fine.bc_vals
    F = F + fine.rhs_diri
    # the ABF shim takes numpy; the host KSP takes a device tensor
    F_solve = F if use_abf else torch.as_tensor(F, device=device)

    # --- nullspace (exSaddle.c:288-301) ---
    nullvec = None
    if nullspace_flag:
        nullvec = np.zeros(mesh.ndof)
        nullvec[mesh.nu:] = -1.0 / np.sqrt(mesh.np_)

    stage_t["Setup"] = time.perf_counter() - _t0
    _t0 = time.perf_counter()

    # --- solver tree (host route) ---
    if not use_abf:
        dm_info = {"nranks": nranks,
                   "overlap": opts.get_int("dmdafe_overlap", 0)}
        amat = _make_saddle_matshell(fine, lame, device, dm_info=dm_info)
        pc_forced = None
        pc_default = "ilu"
        if fs:
            pc_default = "fieldsplit"
        if mg:
            if opts.get_string("pc_type", None, prefix=prefix) is None:
                pc_forced = _build_saddle_mg(opts, prefix, levels, lame,
                                             fs_coarse, device, log=log,
                                             dm_info=dm_info)
            # else: options select the top PC (none of the reference
            # tests do)

        ksp = sc.make_ksp(opts, prefix, amat,
                          ksp_defaults=KSPConfig(type="gmres"),
                          pc_default=pc_default, pc_forced=pc_forced,
                          nullspace=nullvec, log=log)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stage_t["SolverSetup"] = time.perf_counter() - _t0
    _t0 = time.perf_counter()
    result = ksp.solve(F_solve)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stage_t["KSPSolve"] = time.perf_counter() - _t0
    X = _numpy(result.x)

    if opts.get_bool("ksp_view", False, prefix=prefix):
        from exsaddle_tpu_torch.ksp_view import view_ksp
        view_ksp(ksp, log=log, nranks=nranks)

    if twosolves:
        _t0 = time.perf_counter()
        _extra_solves(ksp, F_solve, log=log)
        stage_t["Extra Solves"] = time.perf_counter() - _t0

    # --- check solution (exSaddle.c:431-474) ---
    if check_solution:
        Xref = emodels.compute_reference_solution(ctx, mesh)
        if Xref is not None:
            Xref = np.asarray(Xref, dtype=np.float64)
            if nullvec is not None:
                Xref = Xref - np.dot(nullvec, Xref) * nullvec
            err = Xref - X
            abs_err = float(np.linalg.norm(err))
            rel_err = abs_err / float(np.linalg.norm(Xref))
            log("---------------------")
            log("Error in solution:")
            log(f"  abs {abs_err:g}")
            log(f"  rel {rel_err:g}")
            log("---------------------")
            erru = err[: mesh.nu]
            abs_erru = float(np.linalg.norm(erru))
            rel_erru = abs_erru / float(np.linalg.norm(Xref[: mesh.nu]))
            log("---------------------")
            log("Error in velocity solution:")
            log(f"  abs {abs_erru:g}")
            log(f"  rel {rel_erru:g}")
            log("---------------------")
        else:
            log("Warning: -check_solution supplied but no reference "
                "solution available")

    if diagnostics:
        esio.report_solution_diagnostics(mesh, X, log=log)
    if view_fields:
        esio.view_fields(mesh, X, log=log)
        if check_solution:
            Xr = emodels.compute_reference_solution(ctx, mesh)
            if Xr is not None:
                esio.view_fields(mesh, Xr, tag="ref_", log=log)
    if dump_solution:
        esio.dump_solution(X, "solution.npy", log=log)
    if dump_operator:
        for k, lv in enumerate(levels):
            esio.dump_operator(lv.op.to_csr(), f"operator_{k}.npz", log=log)
    if dump_pc:
        # explicit preconditioner M^-1 (DumpPreconditioner,
        # exSaddle_io.c:91-104)
        esio.dump_dense_operator(ksp.pc.apply, mesh.ndof,
                                 "preconditioner.npz", device, log=log)
    if dump_pc_op:
        # explicit M^-1 A (DumpPreconditionedOperator, exSaddle_io.c:106-126)
        esio.dump_dense_operator(lambda v: ksp.pc.apply(amat.apply(v)),
                                 mesh.ndof, "preconditioned_operator_out.npz",
                                 device, log=log)
    if dump_smoother:
        from exsaddle_tpu_torch import precond_mg
        if not isinstance(ksp.pc, precond_mg.PCMG):
            raise ValueError("Smoother dump requires PC type PCMG")
        for k, lvl in enumerate(ksp.pc.levels):
            esio.dump_dense_operator(
                lambda v, s=lvl.smoother: s.solve(v).x,
                levels[k + 1].mesh.ndof, f"smoother_{k + 1}.npz", device,
                log=log)
    if dump_mpscaled:
        esio.dump_operator(amat.Sp.csr(), "mpscaled.npz", log=log)

    if log_view:
        # lightweight -log_view: per-stage wall-clock summary (the
        # PetscLogStagePush/Pop separation of exSaddle.c:594-599)
        total = sum(stage_t.values())
        log("-" * 62)
        log("Stage summary (wall clock):")
        for name, t in stage_t.items():
            frac = 100.0 * t / total if total > 0 else 0.0
            log(f"  {name:<16s} {t:12.4e} s  {frac:5.1f}%")
        log(f"  {'Total':<16s} {total:12.4e} s")
        log("-" * 62)

    if opts.get_bool("options_left", False):
        log(opts.format_table().rstrip("\n"))

    out = {"X": X, "result": result, "mesh": mesh, "levels": levels,
           "ksp": ksp, "F": F, "reason": result.reason, "its": result.its,
           "rnorm": result.rnorm,
           "seconds": {"setup": stage_t["Setup"] + stage_t["SolverSetup"],
                       "solve": stage_t["KSPSolve"]}}
    if use_abf:
        out.update(history=ksp.last["history"], solver=slv, res=ksp.last,
                   mode=mode, loop=getattr(slv, "loop", "host"))
    return out


def _build_saddle_mg(opts, prefix, levels, lame, fs_coarse, device,
                     log=print, dm_info=None):
    """Programmatic monolithic saddle PCMG with per-level re-assembled
    operators (PC_MG_GALERKIN_NONE) and composite interpolation
    (exSaddle.c:333-402)."""
    nlv = len(levels)
    mats = [_make_saddle_matshell(
        lv, lame, device, dm_info=dm_info,
        names=(("Asaddle", "Mpscaled") if k == nlv - 1
               else (None, "Mpscaled_coarse" if k == 0 else None)))
            for k, lv in enumerate(levels)]
    prolongs = []
    for k in range(len(levels) - 1):
        Pu = Prolongation(levels[k].mesh.nn_u, levels[k + 1].mesh.nn_u,
                          dof=levels[k].mesh.ndim)
        Pp = Prolongation(levels[k].mesh.nn_p, levels[k + 1].mesh.nn_p, dof=1)
        prolongs.append(BlockDiagProlongation(Pu, Pp))

    coarse_pc_forced = None
    if fs_coarse:
        coarse_pc_forced = sc.make_fieldsplit(
            opts, prefix + "mg_coarse_", mats[0], log=log)
    return sc.build_mg(opts, prefix, mats, prolongs,
                       coarse_pc_forced=coarse_pc_forced, log=log)


def _extra_solves(ksp, F, log=print):
    """-twosolves (exSaddle.c:569-618): re-solve with monitoring cancelled in
    a fresh stage."""
    num_extra = 1
    saved_monitor = ksp.cfg.monitor
    saved_reason = ksp.cfg.converged_reason_log
    ksp.cfg.monitor = None
    ksp.cfg.converged_reason_log = None
    log("")
    log("-" * 78)
    log(f"  Commencing with {num_extra} additional solves. This will cancel"
        " a KSP monitor set on\n   saddle_, but no nested output. You should"
        " ensure that there is no output between\n   this output and the"
        " output which indicates the extra solves are completed. That\n   "
        "is, you should not use any ksp_view, ksp_converged_reason, or "
        "nested ksp_monitor\n   options if you want the results in this "
        "test to be meaningful.")
    log("-" * 77)
    res = None
    for _ in range(num_extra):
        res = ksp.solve(F)
    if Reason.is_converged(res.reason):
        log("")
        log("-" * 78)
        log(f"  {num_extra} extra solve(s) succeeded with {res.its} "
            f"iterations and residual norm {res.rnorm:1.6e} ")
        log("-" * 77)
    else:
        log("")
        log("-" * 78)
        log("\n ERROR: EXTRA SOLVES(S) DIVERGED!")
        log("-" * 78)
    ksp.cfg.monitor = saved_monitor
    ksp.cfg.converged_reason_log = saved_reason
    return res


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
