"""Smoke test of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py              # every phase below
    python3 chip_smoke.py --profile    # device, build, then one profiled
                                       # mx=32 IR solve under the bench's
                                       # tuned schedule (PERF.md section 5)

Phases, in order; any failure raises and the script exits nonzero:

1. device  -- a CUDA device must be present; prints nvidia-smi's name and
              power limit.
2. build   -- compiles the port's CUDA kernels from exsaddle_tpu_torch/csrc/
              into exsaddle_tpu_torch/_build/ (skipped when built already).
3. K1      -- the A00 kernel against its plain PyTorch version at the
              main path's shapes (mx=32 pseudoice, 3D) and on 2D SolCx at
              mx=my=64, in float32 and float64: agreement, bitwise-equal
              repeated applies, 2 device launches per apply (torch.profiler);
              each kernel's device time per launch (torch.profiler); median
              per-apply times (CUDA
              events over 20 back-to-back calls) of the kernel, the plain
              version and one library call for the same function (SpMV of
              the raw A00 as an int32 CSR tensor, built here only), beside
              the bound (data-sheet peaks) and the kernel's share of it.
              The build phase prints every kernel's registers and spills.
4. anchor  -- the driver in direct float64 mode at mx=6 (3 MG levels) must
              reach CONVERGED_RTOL in <= 20 iterations with the reference's
              initial residual.
5. main    -- the driver on the flagship: model 11, size_x 0.1, mx=32,
              float32 inner solves with float64 iterative refinement to a
              true relative residual of 1e-8, 4 MG levels. The residual is
              recomputed with the port's float64 operator, the refinement
              must take 3 rounds and 34-38 inner iterations, and the A00
              kernel's launch count must grow during the solve.
6. host_anchor -- the host KSP/PC route on CUDA for three reference trees
              (3d_mg_1, abf.opts under -tpu 0, ildl_1): each must reach
              CONVERGED_RTOL in exactly the JAX package's iteration count,
              with first and last monitor values equal to the JAX run's to
              1e-5 relative. Builds the native ILU/ILDL/ordering libraries
              first (g++) and prints the build seconds.
7. host_mg -- the full-size host route: the 3d_mg_1 tree at mx=32 (859,812
              dofs) with a 4-level rediscretised saddle PCMG (dense LU of
              2,312 dofs on the coarse level). Converges; the true residual
              ||F - A x||, recomputed with the float64 SaddleOperator, equals
              the last monitored residual to 1e-6; repeated applies are
              bitwise equal and a repeated solve (-twosolves) gives the same
              iteration count and a bitwise-equal x.
8. compiled -- the fixed-work FGMRES path with no host reads
              (compiled.make_fgmres_cycle_tree) on the mx=32 pseudoice
              parity operator (859,812 dofs), Jacobi PC, F from
              default_rng(2): one FGMRES(30) cycle in float64 and in float32,
              each under torch.cuda.set_sync_debug_mode("error"), each 2 x 32
              K1 launches; the float64 cycle also captured as one CUDA graph
              (capture fails on a host sync) and replayed, bitwise equal;
              the float64 residual equals the host KSP's
              (FGMRES(30), 30 its, convergence test skipped, over the flat
              ParityMatFreeOperator.mult) to 1e-8, the float32 one is within
              1% of it; ms per cycle and per iteration (CUDA events, median
              of 5) beside the host KSP's ms per iteration. At mx=16 in
              float64, GridSaddleOperator, MatFreeSaddleOperator and the flat
              parity mult equal SaddleOperator.mult to 1e-12, bitwise
              repeatable.
9. outputs -- the flagship -saddle_ksp_view argv at mx=6 on CUDA: the JAX
              package's iteration count and tree length, and the tree of a
              -device cpu run line for line (the two esteig line classes to
              1e-5). Every -dump_* flag, -view_fields and -view_coeffs at
              mx=4 in 3D into a temporary directory: every file reloads, the
              dumped solution is X bitwise, the dumped operator maps X to
              F - r, postproc.spectrum runs on the preconditioned operator.
              ex23 at -n 50 with the default PC and ildl, ilupack, jacobi,
              ilu: error below 1e-9.
10. ex42  -- the sinker (model 1) at mx=my=mz=32 (143,748 dofs), FGMRES
              to rtol 1e-7 with an additive fieldsplit: a 4-level Galerkin MG
              u-block (Chebyshev/Jacobi smoothers), a Jacobi p-block.
              Converges in the JAX package's iteration count with p-rows of F - A X below
              1e-8 ||F||; setup and solve seconds, ms per iteration.
11. cart  -- the sharded runtime (parallel/), every shard on this card. At
              mx=16 pseudoice in float64 over a 2x2x2 device grid: the
              element-batched make_cart_mult and the sharded mult_tree (K1
              once per shard, 2 x 8 launches per apply) equal the
              single-device SaddleOperator.mult and mult_tree to 1e-12,
              bitwise repeatable; make_cart_fgmres(k=30) runs under
              torch.cuda.set_sync_debug_mode("error") and its residual equals
              the single-device compiled cycle's to 1e-8. DistABFSolver over 4
              slabs gives the single-device float64 ABF solve's iteration
              count and x to 1e-10. Then the flagship argv (model 11, size_x
              0.1, mx=32, 4 MG levels) through driver.saddle_solve with
              devices=[cuda:0] * 4 (device grid 1x2x2, mode cart) against
              the single-device float64 direct solve of the same argv: the
              same iteration count and reason, the history to 1e-8 and x to
              1e-9 (norm-relative), the true residual recomputed with the float64
              parity operator; K1 launches 2 x 4 per sharded apply; a
              repeated solve is bitwise equal; setup / solve seconds, ms per
              outer iteration, halo exchanges, K1 launches, peak memory.
12. bench -- the port's bench (exsaddle_tpu_torch/bench.py) at mx=32:
              bench_apply (100 float32 saddle applies captured as one CUDA
              graph and replayed, beside the same applies issued eagerly;
              calibration; top device kernels) and bench_solve (float32 +
              float64 refinement to a true 1e-8) under the tuned schedule,
              with the abf.opts schedule and the tuned one with 3 fixed
              V-cycles in place of GCR (u_fixed_vcycles=3) alternated with
              it; prints the bench's JSON line. The graph replay equals the
              eager loop bitwise, the scaled loop is stable, one eager loop
              makes 2 x 100 K1 launches; every schedule converges without
              stalling to a float64 residual <= 1e-8 recomputed with the
              port's float64 operator, in rounds and inner iterations
              inside BENCH_BANDS.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

import json
import os
import re
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET

import numpy as np
import torch

from exsaddle_tpu_torch import abf as tabf
from exsaddle_tpu_torch import bench
from exsaddle_tpu_torch import compiled
from exsaddle_tpu_torch import driver as tdriver
from exsaddle_tpu_torch import models as emodels
from exsaddle_tpu_torch import native
from exsaddle_tpu_torch import postproc
from exsaddle_tpu_torch import treeops
from exsaddle_tpu_torch.assembly import FESpace, assemble_element_matrices
from exsaddle_tpu_torch.bench import self_device_us
from exsaddle_tpu_torch.ex23 import solve_ex23
from exsaddle_tpu_torch.ex42 import solve_stokes_3d_coupled
from exsaddle_tpu_torch.grid_ops import (GridSaddleOperator, gather_u_parity,
                                         split_u_parity)
from exsaddle_tpu_torch.kernels import _build
from exsaddle_tpu_torch.kernels import a00
from exsaddle_tpu_torch.krylov import KSP, KSPConfig
from exsaddle_tpu_torch.matfree import (MatFreeSaddleOperator,
                                        ParityMatFreeOperator, mult_tree,
                                        parity_permutation, tree_aux)
from exsaddle_tpu_torch.mesh import SaddleMesh
from exsaddle_tpu_torch.operator import apply_dirichlet_elimination
from exsaddle_tpu_torch.options import Options
from exsaddle_tpu_torch.precond import PCJacobi

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def log(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def phase_device():
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return card


def phase_build():
    t0 = time.perf_counter()
    path, built, blog = _build.build()
    a00._fn(torch.float32)          # load and bind
    log(f"[build] {'built' if built else 'reused'} {path} in "
        f"{time.perf_counter() - t0:.2f} s")
    # ptxas -v: each entry function, its spills, then its registers
    lines = [ln.strip() for ln in blog.splitlines() if "ptxas info" in ln
             or "spill" in ln]
    check(any("Used" in ln for ln in lines),
          "no ptxas register report in the build log")
    for line in lines:
        log(f"[build] {line}")


def _problem(ndim, m, model, size):
    """(mesh, fes, coefficients, bc indices and values, natural-order bc
    mask) of one structured-grid problem."""
    opts = Options.from_args(["-model", str(model)])
    ctx = emodels.ModelContext(opts, ndim, log=lambda *a, **k: None)
    mesh = SaddleMesh(ndim, m, size)
    fes = FESpace(mesh)
    bc_idx, bc_vals = emodels.create_bc_list(ctx, mesh)
    coeff = tdriver.fine_coefficients(ctx, fes)
    bc_mask = np.zeros(mesh.ndof)
    bc_mask[:mesh.nu][bc_idx] = 1.0
    return mesh, fes, coeff, bc_idx, bc_vals, bc_mask


def _operator(ndim, m, model, size, dtype, device):
    mesh, fes, coeff, _, _, bc_mask = _problem(ndim, m, model, size)
    return ParityMatFreeOperator.build(mesh, fes, coeff, bc_mask,
                                       dtype=dtype, device=device)


def _median_ms(fn, reps=15, inner=20, warmup=3):
    """Per-call ms: CUDA events around `inner` back-to-back calls (so the
    device, not the host's issue, sets the time once a call outlasts its
    issue), median over `reps` such runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    return float(np.median(times))


# H100 SXM data-sheet peaks (dense rates at 700 W): FP32 CUDA cores, FP64
# tensor cores (the float64 products run there), HBM3
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}
PEAK_BYTES = 3.35e12


def k1_bound(op, dtype):
    """(bound in ms, what sets it) of one A00 apply on this operator: the
    products' FLOP at the peak rate of their type against x, scale_visc and
    Bs read once and y written once at the memory rate."""
    nd = len(op.m_el)
    nel, nrow = op.scale_visc.shape
    ncol = 3 ** nd * nd
    flop = 2 * 2 * nel * nrow * ncol
    size = torch.empty((), dtype=dtype).element_size()
    nbytes = size * (2 * op.nu + nel * nrow + nrow * ncol)
    t_ops, t_bytes = flop / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def raw_a00_csr(op):
    """The raw A00 (no Dirichlet masks) as a CSR tensor with int32 indices
    in float64: sum_e G_e^T Bs^T diag(s_e) Bs G_e, coalesced from the
    element matrices. The yardstick of one library call for K1's function;
    the port never calls it."""
    nd = len(op.m_el)
    dev = op.Bs.device
    G = gather_u_parity(split_u_parity(torch.arange(op.nu, device=dev),
                                       op.cls_shapes, nd), op.m_el)
    nel, ncol = G.shape
    Bs = op.Bs.double()
    s = op.scale_visc.double()
    Ke = torch.empty(nel, ncol, ncol, dtype=torch.float64, device=dev)
    for c in range(0, nel, 4096):
        Ke[c:c + 4096] = (Bs.T[None] * s[c:c + 4096, None, :]) @ Bs
    idx = torch.stack([G[:, :, None].expand(nel, ncol, ncol).reshape(-1),
                       G[:, None, :].expand(nel, ncol, ncol).reshape(-1)])
    A = torch.sparse_coo_tensor(idx, Ke.reshape(-1), (op.nu, op.nu))
    del idx, Ke, G
    A = A.coalesce().to_sparse_csr()
    return torch.sparse_csr_tensor(A.crow_indices().to(torch.int32),
                                   A.col_indices().to(torch.int32),
                                   A.values(), A.shape)


def _device_kernels(fn, calls=10):
    """{kernel name: (launches per call, mean device us per launch)} of the
    K1 kernels one call of fn launches, from torch.profiler; empty where
    the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.count / calls, self_device_us(e) / e.count)
            for e in prof.key_averages()
            if "a00" in e.key and self_device_us(e) > 0}


def phase_k1(device):
    """K1 against its plain version and the library's CSR SpMV; returns the
    float32 3D numbers (the main path's working precision and shapes)."""
    out = {}
    cases = [("3D mx=32 pseudoice", 3, (32, 32, 32), 11, (0.1, 1.0, 1.0)),
             ("2D mx=my=64 SolCx", 2, (64, 64), 0, (1.0, 1.0))]
    for name, ndim, m, model, size in cases:
        op64 = _operator(ndim, m, model, size, torch.float64, device)
        t0 = time.perf_counter()
        csr64 = raw_a00_csr(op64)
        log(f"[K1] {name}: raw A00 CSR nnz {csr64.values().numel()}, built "
            f"in {time.perf_counter() - t0:.2f} s")
        for dtype in (torch.float32, torch.float64):
            op = _operator(ndim, m, model, size, dtype, device)
            x = torch.as_tensor(np.random.default_rng(0).standard_normal(
                op.nu), dtype=dtype, device=device)
            y_k = a00.a00_apply(op, x)
            y_p = a00.a00_apply_plain(op, x)
            torch.cuda.synchronize()
            err = float((y_k - y_p).abs().max())
            rel = err / float(y_p.abs().max())
            ok = bool(torch.isfinite(y_k).all()) and rel <= TOL[dtype]
            check(ok, f"K1 {name} {dtype} disagrees with its plain version "
                  f"(relative {rel:.3e})")
            check(torch.equal(a00.a00_apply(op, x), y_k),
                  f"K1 {name} {dtype}: repeated applies differ")
            csr = csr64 if dtype == torch.float64 else torch.sparse_csr_tensor(
                csr64.crow_indices(), csr64.col_indices(),
                csr64.values().to(dtype), csr64.shape)
            lib_rel = float((csr @ x - y_p).abs().max() / y_p.abs().max())
            check(lib_rel <= 1e3 * TOL[dtype],
                  f"K1 {name} {dtype}: CSR yardstick off by {lib_rel:.3e}")
            kern = _device_kernels(lambda: a00.a00_apply(op, x))
            per_apply = sum(n for n, _ in kern.values())
            check(per_apply == a00.KERNELS_PER_APPLY,
                  f"K1 {name} {dtype}: the profiler saw {per_apply} device "
                  f"launches per apply")
            for kname, (n, us) in kern.items():
                log(f"[K1] {name} {str(dtype)[6:]}: device {us:.2f} us per "
                    f"launch, {n:g} per apply: {kname[:110]}")
            ms = _median_ms(lambda: a00.a00_apply(op, x))
            plain_ms = _median_ms(lambda: a00.a00_apply_plain(op, x))
            library_ms = _median_ms(lambda: csr @ x)
            bound_ms, bound_by = k1_bound(op, dtype)
            log(f"[K1] {name} {str(dtype)[6:]}: max_abs_err {err:.3e} "
                f"rel {rel:.3e} (tol {TOL[dtype]:g}), bitwise repeatable, "
                f"{per_apply:g} device launches per apply; kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library (CSR SpMV, "
                f"int32) {library_ms:.4f} ms, bound {1e3 * bound_ms:.1f} us "
                f"({bound_by}), kernel at {100 * bound_ms / ms:.1f}% of it")
            if ndim == 3 and dtype == torch.float32:
                out = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by}
            del op, x, y_k, y_p, csr
        del op64, csr64
        torch.cuda.empty_cache()
    return out


def phase_anchor():
    argv = tdriver.ABF_OPTS + ("-model 11 -size_x 0.1 -mx 6 "
                               "-saddle_ksp_converged_reason").split()
    r = tdriver.saddle_solve(Options.from_args(argv), 3, log=log)
    h0 = r["history"][0]
    log(f"[anchor] mx=6 direct float64: {r['reason']} in {r['its']} its, "
        f"history[0] {h0:.6g}, solve {r['seconds']['solve']:.3f} s")
    check(r["reason"] == "CONVERGED_RTOL", "anchor did not converge")
    check(r["its"] <= 20, f"anchor took {r['its']} > 20 iterations")
    check(abs(h0 - 0.00273569) / 0.00273569 < 1e-4,
          f"anchor initial residual {h0} != 0.00273569")


def phase_main():
    argv = tdriver.ABF_OPTS + (
        "-model 11 -size_x 0.1 -mx 32 -ir -rtol_true 1e-8 "
        "-saddle_fieldsplit_u_pc_mg_levels 4 -saddle_ksp_monitor_short "
        "-saddle_ksp_converged_reason").split()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a00.LAUNCHES.reset()
    r = tdriver.saddle_solve(Options.from_args(argv), 3, log=log)
    launches, applies = a00.LAUNCHES.n, a00.LAUNCHES.applies
    res = r["res"]
    slv = r["solver"]
    log(f"[main] A00 kernels during the driver run: {launches} device "
        f"launches in {applies} applies")
    check(launches > 0, "the main path never launched the A00 kernel")
    check(not res["stalled"], "iterative refinement stalled")
    check(res["converged"], "iterative refinement did not converge")
    check(np.all(np.isfinite(res["x"]))
          and res["x"].shape == (r["mesh"].ndof,),
          "solution not finite or of the wrong shape")
    # independent float64 true residual with the port's own operator
    op64, aux64 = slv.setup["op64"], tree_aux(slv.setup["op64"])
    F64 = slv.vec_to_tree(r["F"], dtype=torch.float64)
    x64 = slv.vec_to_tree(res["x"], dtype=torch.float64)
    rel = float(torch.linalg.norm(F64 - mult_tree(op64, aux64, x64))
                / torch.linalg.norm(F64))
    log(f"[main] true float64 relative residual {rel:.3e}")
    check(rel <= 1e-8, f"true relative residual {rel} > 1e-8")

    F = r["F"]
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = slv.solve_ir(F, rtol=1e-8)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(res["converged"] and not res["stalled"],
              "timed IR solve did not converge")
    t_solve = float(np.median(times))
    its = res["inner_its"]
    check(res["rounds"] == 3 and 34 <= its <= 38,
          f"IR took {res['rounds']} rounds / {its} inner its, expected 3 / "
          f"34-38")
    log(f"[main] mx=32 ndof {r['mesh'].ndof}: setup "
        f"{r['seconds']['setup']:.2f} s, first solve "
        f"{r['seconds']['solve']:.3f} s, solve median of 3 {t_solve:.3f} s "
        f"(spread {min(times):.3f}-{max(times):.3f}), rounds {res['rounds']},"
        f" inner its {its}, {1e3 * t_solve / max(its, 1):.2f} ms/outer it, "
        f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, applies


# (name, argv, iterations, first and last monitor values) of the JAX
# package's host route on these trees (float64 on the CPU)
HOST_ANCHORS = [
    ("3d_mg_1", "-model 2 -sinker_n 1 -mx 8 -mg -nlevels 2 "
     "-saddle_ksp_type fgmres -saddle_mg_levels_ksp_type gmres "
     "-saddle_mg_levels_pc_type jacobi -saddle_mg_levels_ksp_max_it 10",
     12, 0.0179029, 1.57335e-07),
    ("abf.opts -tpu 0", " ".join(tdriver.ABF_OPTS)
     + " -model 11 -size_x 0.1 -mx 4 -tpu 0", 21, 0.00495115, 3.13656e-08),
    ("ildl_1", "-mx 8 -model 6 -eta1 100 -eta0 1 -saddle_pc_type ildl "
     "-saddle_pc_ildl_droptol 1e-3 -saddle_ksp_pc_side right",
     7, 0.0180253, 9.43046e-08),
]

_MON = re.compile(r"^\s*(\d+) KSP Residual norm (\S+) $")


def _monitor_values(lines):
    return [float(m.group(2)) for m in map(_MON.match, lines) if m]


def phase_host_anchor():
    t0 = time.perf_counter()
    built = native.build_all()
    log(f"[host_anchor] native libraries {built or 'reused'} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, argv, its, first, last in HOST_ANCHORS:
        lines = []
        t0 = time.perf_counter()
        r = tdriver.saddle_solve(Options.from_args(
            argv.split() + ["-saddle_ksp_monitor_short"]), 3,
            log=lines.append)
        mon = _monitor_values(lines)
        log(f"[host_anchor] {name}: {r['reason']} in {r['its']} its, "
            f"monitor {mon[0]:g} .. {mon[-1]:g}, "
            f"{time.perf_counter() - t0:.2f} s")
        check(r["reason"] == "CONVERGED_RTOL" and r["its"] == its,
              f"{name}: {r['reason']} in {r['its']} its, expected "
              f"CONVERGED_RTOL in {its}")
        check(len(mon) == its + 1, f"{name}: {len(mon)} monitor lines")
        for got, want in ((mon[0], first), (mon[-1], last)):
            check(abs(got - want) <= 1e-5 * want,
                  f"{name}: monitor value {got:g} != {want:g}")


def phase_host_mg(device):
    argv = ("-model 2 -sinker_n 1 -mx 32 -mg -nlevels 4 "
            "-saddle_ksp_type fgmres -saddle_mg_levels_ksp_type gmres "
            "-saddle_mg_levels_pc_type jacobi -saddle_mg_levels_ksp_max_it 10 "
            "-saddle_ksp_monitor_short -saddle_ksp_converged_reason "
            "-diagnostics").split()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a00.LAUNCHES.reset()
    lines = []

    def tee(msg=""):
        lines.append(msg)
        log(msg)
    r = tdriver.saddle_solve(Options.from_args(argv), 3, log=tee)
    mesh, its = r["mesh"], r["its"]
    log(f"[host_mg] A00 kernel launches during the driver run: "
        f"{a00.LAUNCHES.n} (the host route applies A00 through "
        f"SaddleOperator.mult_u)")
    check(r["reason"] == "CONVERGED_RTOL", f"host_mg: {r['reason']}")
    check(r["X"].shape == (mesh.ndof,) and np.all(np.isfinite(r["X"])),
          "host_mg: solution not finite or of the wrong shape")
    mon = _monitor_values(lines)
    check(len(mon) == its + 1 and mon[-1] <= 1e-5 * mon[0],
          "host_mg: monitor history does not show the converged solve")

    # independent true residual with the float64 SaddleOperator
    op = r["levels"][-1].op
    x = r["result"].x
    F = torch.as_tensor(r["F"], device=device)
    true = float(torch.linalg.vector_norm(F - op.mult(x)))
    rel = abs(true - r["rnorm"]) / r["rnorm"]
    log(f"[host_mg] true residual {true:.9e}, last monitored "
        f"{r['rnorm']:.9e}, relative difference {rel:.3e}")
    check(rel <= 1e-6, f"host_mg: true residual differs by {rel:.3e}")

    # determinism: repeated applies and a repeated solve are bitwise equal
    xr = torch.as_tensor(np.random.default_rng(0).standard_normal(
        mesh.ndof), device=device)
    check(torch.equal(op.mult(xr), op.mult(xr)),
          "host_mg: SaddleOperator.mult not bitwise repeatable")
    P = r["ksp"].pc.levels[-1].P
    check(torch.equal(P.restrict(xr), P.restrict(xr)),
          "host_mg: Prolongation.restrict not bitwise repeatable")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res2 = tdriver._extra_solves(r["ksp"], F, log=log)
    torch.cuda.synchronize()
    t_again = time.perf_counter() - t0
    check(res2.its == its and torch.equal(res2.x, x),
          f"host_mg: repeated solve gave {res2.its} its"
          f"{'' if torch.equal(res2.x, x) else ' and a different x'}")
    t_setup, t_solve = r["seconds"]["setup"], r["seconds"]["solve"]
    log(f"[host_mg] mx=32 ndof {mesh.ndof}, 4 levels: setup {t_setup:.2f} s, "
        f"solve {t_solve:.3f} s, repeated solve {t_again:.3f} s, outer its "
        f"{its}, {1e3 * t_solve / its:.2f} ms/outer it, peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


COMPILED_K = 30


def phase_compiled(device, card):
    """The fixed-work tree FGMRES cycle on K1 at mx=32 (float64, float32)
    against the host KSP, then the natural-order operators at mx=16.
    Returns (K1 launches, applies) of the two sync-checked cycles."""
    k = COMPILED_K
    cycle = compiled.make_fgmres_cycle_tree(k)
    mesh, fes, coeff, _, _, bc_mask = _problem(3, (32, 32, 32), 11,
                                               (0.1, 1.0, 1.0))
    F_np = np.random.default_rng(2).standard_normal(mesh.ndof)
    out, launches, applies = {}, 0, 0
    for dtype in (torch.float64, torch.float32):
        op = ParityMatFreeOperator.build(mesh, fes, coeff, bc_mask,
                                         dtype=dtype, device=device)
        d = op.diagonal()
        inv = 1.0 / torch.where(d == 0.0, torch.ones_like(d), d)
        F = torch.as_tensor(F_np, dtype=dtype, device=device)
        x0 = torch.zeros_like(F)
        aux = tree_aux(op)
        op.node_table                      # K1's table on the device
        torch.cuda.synchronize()
        a00.LAUNCHES.reset()
        torch.cuda.set_sync_debug_mode("error")
        try:
            x, rn = cycle(op, aux, inv, F, x0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        n, a = a00.LAUNCHES.n, a00.LAUNCHES.applies
        launches += n
        applies += a
        check(n == 2 * (k + 2) and a == k + 2,
              f"compiled {dtype}: {n} K1 launches in {a} applies, expected "
              f"{2 * (k + 2)} in {k + 2}")
        rn = float(rn)
        check(np.isfinite(rn) and bool(torch.isfinite(x).all()),
              f"compiled {dtype}: residual {rn} or x not finite")
        ms = _median_ms(lambda: cycle(op, aux, inv, F, x0), reps=5, inner=1,
                         warmup=1)
        out[dtype] = (rn, ms)
        log(f"[compiled] mx=32 ndof {mesh.ndof} {str(dtype)[6:]}: FGMRES({k}) "
            f"cycle, no host sync, {n} K1 launches in {a} applies, "
            f"||F - A x|| {rn:.10e}, {ms:.3f} ms per cycle, {ms / k:.4f} ms per "
            f"iteration ({card})")
        if dtype == torch.float64:
            # the same cycle captured into a CUDA graph: capture fails on any
            # host synchronisation; a replay shows the device's own time
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                cycle(op, aux, inv, F, x0)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                xg, rg = cycle(op, aux, inv, F, x0)
            graph.replay()
            check(torch.equal(xg, x) and float(rg) == rn,
                  "compiled float64: the graph replay differs from the cycle")
            g_ms = _median_ms(graph.replay, reps=5, inner=1, warmup=1)
            log(f"[compiled] the float64 cycle captured as one CUDA graph: "
                f"replay {g_ms:.3f} ms per cycle, {g_ms / k:.4f} ms per "
                f"iteration, bitwise equal to the cycle ({card})")
            del graph, xg, rg
            hist = []
            cfg = KSPConfig(type="fgmres", restart=k, max_it=k,
                            convergence_test="skip",
                            monitor=lambda i, r: hist.append(r))
            ksp = KSP(op.mult, pc=PCJacobi(d, device), cfg=cfg)
            ksp.solve(F)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hist.clear()
            ksp.solve(F)
            torch.cuda.synchronize()
            host_ms = 1e3 * (time.perf_counter() - t0) / k
            rel = abs(hist[-1] - rn) / hist[-1]
            log(f"[compiled] host KSP FGMRES({k}) over the flat parity mult: "
                f"residual {hist[-1]:.10e} (relative difference {rel:.3e}), "
                f"{host_ms:.4f} ms per iteration ({card})")
            check(rel <= 1e-8, f"compiled float64 residual differs from the "
                  f"host KSP's by {rel:.3e}")
        del op, d, inv, F, x0, x, aux
    r64, r32 = out[torch.float64][0], out[torch.float32][0]
    check(abs(r32 - r64) <= 1e-2 * r64,
          f"compiled float32 residual {r32} vs float64 {r64}")
    torch.cuda.empty_cache()

    # natural-order operators against the element-batched SaddleOperator
    mesh, fes, coeff, bc_idx, bc_vals, bc_mask = _problem(
        3, (16, 16, 16), 11, (0.1, 1.0, 1.0))
    elm = assemble_element_matrices(fes, coeff)
    sop, _, _, _ = apply_dirichlet_elimination(mesh, elm, bc_idx, bc_vals,
                                               device)
    del elm
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(mesh.ndof),
                        device=device)
    y = sop.mult(x)
    scale = float(y.abs().max())
    perm, _ = parity_permutation(mesh)
    perm = torch.as_tensor(perm, device=device)
    mf = MatFreeSaddleOperator.build(mesh, fes, coeff, bc_mask,
                                     dtype=torch.float64, device=device)
    pop = ParityMatFreeOperator.from_matfree(mf, mesh)
    for name, fn, ref in (
            ("GridSaddleOperator",
             GridSaddleOperator.from_operator(mesh, sop).mult, y),
            ("MatFreeSaddleOperator", mf.mult, y),
            ("ParityMatFreeOperator.mult", lambda v: pop.mult(v[perm]),
             y[perm])):
        got = fn(x)
        rel = float((got - ref).abs().max()) / scale
        log(f"[compiled] mx=16 {name}: relative {rel:.3e} against "
            f"SaddleOperator.mult")
        check(rel <= 1e-12, f"{name} differs from SaddleOperator.mult by "
              f"{rel:.3e}")
        check(torch.equal(fn(x), got), f"{name}: repeated applies differ")
    return launches, applies, out


# the JAX package's -saddle_ksp_view run of the flagship argv at mx=6
# (float64 on the CPU): iterations and the tree's lines, rerun by
# tests/test_torch_chip_anchors.py
VIEW_ITS, VIEW_TREE_LINES = 21, 289
_ESTEIG = re.compile(r"eigenvalues estimate via gmres|eigenvalue estimates "
                     r"used")
_FLOAT = re.compile(r"[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?")


def _same_esteig(a, b):
    """Two esteig lines: the same words, numbers to 1e-5 relative."""
    if _FLOAT.sub("#", a) != _FLOAT.sub("#", b):
        return False
    return all(abs(float(x) - float(y)) <= 1e-5 * max(abs(float(y)), 1e-300)
               for x, y in zip(_FLOAT.findall(a), _FLOAT.findall(b)))


def _tree(lines):
    return lines[lines.index("KSP Object: (saddle_) 1 MPI processes"):]


DUMP_FILES = ("coeffs_0.vts", "coeffs_1.vts", "uvw.vts", "p.vts",
              "solution.npy", "operator_0.npz", "operator_1.npz",
              "preconditioner.npz", "preconditioned_operator_out.npz",
              "smoother_1.npz", "mpscaled.npz")


def phase_outputs(device, card):
    argv = tdriver.ABF_OPTS + ("-model 11 -size_x 0.1 -mx 6 -saddle_ksp_view "
                               "-saddle_ksp_monitor_short").split()
    trees = {}
    for dev in ("cuda", "cpu"):
        lines = []
        t0 = time.perf_counter()
        r = tdriver.saddle_solve(Options.from_args(argv + ["-device", dev]),
                                 3, log=lines.append)
        trees[dev] = _tree(lines)
        log(f"[outputs] -saddle_ksp_view mx=6 -device {dev}: {r['reason']} "
            f"in {r['its']} its, tree of {len(trees[dev])} lines, "
            f"{time.perf_counter() - t0:.2f} s ({card})")
        if dev == "cuda":
            check(r["its"] == VIEW_ITS and "history" not in r,
                  f"-saddle_ksp_view run: {r['its']} its, expected "
                  f"{VIEW_ITS} on the host route")
    check(len(trees["cuda"]) == len(trees["cpu"]) == VIEW_TREE_LINES,
          f"tree lengths {len(trees['cuda'])} / {len(trees['cpu'])}, "
          f"expected {VIEW_TREE_LINES}")
    for a, b in zip(trees["cuda"], trees["cpu"]):
        ok = _same_esteig(a, b) if _ESTEIG.search(b) else a == b
        check(ok, f"-saddle_ksp_view trees differ:\ncuda: {a}\ncpu:  {b}")

    argv = ("-model 2 -sinker_n 1 -mx 4 -mg -nlevels 2 -saddle_ksp_type "
            "fgmres -saddle_mg_levels_ksp_type gmres "
            "-saddle_mg_levels_pc_type jacobi -saddle_mg_levels_ksp_max_it 3 -view_fields -view_coeffs "
            "-dump_solution -dump_operator -dump_preconditioner "
            "-dump_preconditioned_operator -dump_smoother "
            "-dump_scaled_mass_matrix").split()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            r = tdriver.saddle_solve(Options.from_args(argv), 3,
                                     log=lambda *a: None)
            t_run = time.perf_counter() - t0
            check(r["reason"] == "CONVERGED_RTOL", f"dumps: {r['reason']}")
            files = sorted(os.listdir(tmp))
            check(files == sorted(DUMP_FILES), f"dumps wrote {files}")
            for f in files:
                if f.endswith(".vts"):
                    arrays = [np.array(a.text.split(), float) for a in
                              ET.parse(f).getroot().iter("DataArray")]
                    check(all(np.isfinite(a).all() for a in arrays),
                          f"{f}: not finite")
                else:
                    z = np.load(f)
                    arrs = [z] if f.endswith(".npy") else [z[k] for k in z]
                    check(all(np.isfinite(a).all() for a in arrs),
                          f"{f}: not finite")
            X = np.load("solution.npy")
            check(np.array_equal(X, r["X"]),
                  "solution.npy is not the returned X")
            A = postproc.load_operator("operator_1.npz")
            op = r["levels"][-1].op
            res = r["F"] - op.mult(torch.as_tensor(X, device=device)).cpu(
                ).numpy()
            rel = np.abs(A @ X - (r["F"] - res)).max() / np.abs(r["F"]).max()
            check(rel <= 1e-12, f"dumped operator: A X vs F - r {rel:.3e}")
            t0 = time.perf_counter()
            s = postproc.spectrum(postproc.load_operator(
                "preconditioned_operator_out.npz"))
            check(s["pos"].size + s["neg"].size == X.size,
                  "spectrum: eigenvalue count")
            log(f"[outputs] mx=4 dumps ({len(files)} files, ndof {X.size}): "
                f"{t_run:.2f} s; A X = F - r to {rel:.3e}; spectrum of M^-1 A "
                f"in {time.perf_counter() - t0:.2f} s: {s['pos'].size} "
                f"positive, {s['neg'].size} negative, max|imag| "
                f"{s['max_imag']:.3e} ({card})")
        finally:
            os.chdir(cwd)

    for args in ("-n 50", "-n 50 -pc_type ildl", "-n 50 -pc_type ilupack",
                 "-n 50 -pc_type jacobi", "-n 50 -pc_type ilu"):
        res, err = solve_ex23(Options.from_args(args.split()),
                              log=lambda *a: None)
        log(f"[outputs] ex23 {args}: error {err:.3e} in {res.its} its")
        check(err < 1e-9, f"ex23 {args}: error {err}")


# the JAX package's ex42 run of EX42_ARGV at mx=32 (float64 on the CPU),
# rerun by tests/test_torch_chip_anchors.py
EX42_ITS = 84
EX42_ARGV = ("-model 1 -stokes_ksp_type fgmres -stokes_ksp_rtol 1e-7 "
             "-stokes_fieldsplit_u_ksp_type preonly "
             "-stokes_fieldsplit_u_pc_type mg "
             "-stokes_fieldsplit_u_pc_mg_levels 4 "
             "-stokes_fieldsplit_u_pc_mg_galerkin "
             "-stokes_fieldsplit_u_mg_levels_pc_type jacobi "
             "-stokes_fieldsplit_p_ksp_type preonly "
             "-stokes_fieldsplit_p_pc_type jacobi -stokes_ksp_monitor_blocks")


def phase_ex42(device, card):
    lines = []
    r = solve_stokes_3d_coupled(32, 32, 32, Options.from_args(
        EX42_ARGV.split()), log=lines.append, device=device)
    res, prob = r["result"], r["prob"]
    mon = [ln for ln in lines if "KSP Component" in ln]
    for ln in (mon[0], mon[-1]):
        log(f"[ex42] {ln}")
    X = r["X"].cpu().numpy()
    rp = np.abs((prob.F - prob.A @ X)[3::4]).max() / np.linalg.norm(prob.F)
    t_setup, t_solve = r["seconds"]["setup"], r["seconds"]["solve"]
    log(f"[ex42] sinker mx=32 ndof {prob.ndof}: {res.reason} in {res.its} "
        f"its, max p-row |F - A X| / ||F|| {rp:.3e}; setup {t_setup:.2f} s, "
        f"solve {t_solve:.3f} s, {1e3 * t_solve / res.its:.2f} ms per "
        f"iteration ({card})")
    check(res.reason == "CONVERGED_RTOL" and res.its == EX42_ITS,
          f"ex42: {res.reason} in {res.its} its, expected CONVERGED_RTOL in "
          f"{EX42_ITS}")
    check(len(mon) == res.its + 1, f"ex42: {len(mon)} block monitor lines")
    check(np.all(np.isfinite(X)) and X.shape == (prob.ndof,),
          "ex42: solution not finite or of the wrong shape")
    check(rp < 1e-8, f"ex42: p-rows of F - A X at {rp:.3e} of ||F||")


# the cart phase's sharded layouts: the operator checks, the flagship
CART_OP_GRID, CART_SLABS, CART_DEVICES = (2, 2, 2), 4, 4
CART_ARGV = tdriver.ABF_OPTS + (
    "-model 11 -size_x 0.1 -mx 32 -saddle_fieldsplit_u_pc_mg_levels 4 "
    "-saddle_ksp_monitor_short -saddle_ksp_converged_reason").split()
# the flagship's history, sharded against single-device, per entry
HIST_TOL = 1e-7


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def phase_cart(device, card):
    """The sharded runtime with every shard on this card; returns the K1
    (launches, applies) of the flagship's sharded driver run."""
    from exsaddle_tpu_torch.abf import ABFSolver
    from exsaddle_tpu_torch.assembly import assemble_rhs, scatter_vector
    from exsaddle_tpu_torch.parallel.cart import (CartOperator,
                                                  CartPartition,
                                                  make_cart_fgmres,
                                                  make_cart_mult)
    from exsaddle_tpu_torch.parallel.cart_abf import CartABFSolver
    from exsaddle_tpu_torch.parallel.dist_abf import DistABFSolver

    # --- mx=16 pseudoice, float64: the sharded applies and the cycle ----
    mesh, fes, coeff, bc_idx, bc_vals, bc_mask = _problem(
        3, (16, 16, 16), 11, (0.1, 1.0, 1.0))
    ctx = emodels.ModelContext(Options.from_args(["-model", "11"]), 3,
                               log=lambda *a, **k: None)
    sop, _, _, _ = apply_dirichlet_elimination(
        mesh, assemble_element_matrices(fes, coeff), bc_idx, bc_vals, device)
    ndev = int(np.prod(CART_OP_GRID))
    part = CartPartition(mesh, CART_OP_GRID)
    t0 = time.perf_counter()
    cop = CartOperator.build(part, ctx, bc_idx, part.device_mesh(
        [device] * ndev))
    cslv = CartABFSolver(part, ctx, bc_idx, bc_vals, [device] * ndev,
                         nlevels=3)
    t_build = time.perf_counter() - t0
    smesh, blk = cslv.smesh, cslv.blocks
    x = np.random.default_rng(5).standard_normal(mesh.ndof)
    y1 = sop.mult(torch.as_tensor(x, device=device)).cpu().numpy()
    scale = float(np.abs(y1).max())
    mult = make_cart_mult(cop.smesh)
    xs = cop.smesh.shard(part.shard_vector(x))
    yc = mult(cop, xs)
    rel = float(np.abs(part.unshard_vector(yc) - y1).max()) / scale
    log(f"[cart] mx=16 make_cart_mult over {CART_OP_GRID}: relative {rel:.3e} "
        f"against SaddleOperator.mult (CartOperator and CartABFSolver built "
        f"in {t_build:.2f} s)")
    check(rel <= 1e-12, f"cart: make_cart_mult differs by {rel:.3e}")
    check(all(torch.equal(a, b) for a, b in zip(mult(cop, xs).parts,
                                                yc.parts)),
          "cart: make_cart_mult not bitwise repeatable")

    pop = ParityMatFreeOperator.build(mesh, fes, coeff, bc_mask,
                                      dtype=torch.float64, device=device)
    perm, iperm = parity_permutation(mesh)
    yt1 = mult_tree(pop, tree_aux(pop), torch.as_tensor(
        x[perm], device=device)).cpu().numpy()[iperm]
    xt = cslv.shard_saddle(x)
    torch.cuda.synchronize()
    a00.LAUNCHES.reset()
    yt = blk.saddle_mult(xt)
    n, a = a00.LAUNCHES.n, a00.LAUNCHES.applies
    check(n == 2 * ndev and a == ndev,
          f"cart: {n} K1 launches in {a} applies per sharded mult_tree, "
          f"expected {2 * ndev} in {ndev}")
    rel = float(np.abs(cslv.unshard_saddle(yt) - yt1).max()
                / np.abs(yt1).max())
    log(f"[cart] mx=16 sharded mult_tree over {CART_OP_GRID}: {n} K1 "
        f"launches per apply, relative {rel:.3e} against the single-device "
        f"mult_tree")
    check(rel <= 1e-12, f"cart: sharded mult_tree differs by {rel:.3e}")
    check(all(torch.equal(p, q) for p, q in zip(blk.saddle_mult(xt).parts,
                                                yt.parts)),
          "cart: sharded mult_tree not bitwise repeatable")

    k = COMPILED_K
    f1, f2 = assemble_rhs(fes, coeff["Fu"], coeff["Fp"])
    F = scatter_vector(mesh, f1, f2)
    d = sop.diagonal()
    inv = 1.0 / torch.where(d == 0.0, torch.ones_like(d), d)
    shard = lambda v: cop.smesh.shard(part.shard_vector(v))
    Fs, invs, x0s = shard(F), shard(inv.cpu().numpy()), shard(
        np.zeros(mesh.ndof))
    cycle = make_cart_fgmres(cop.smesh, k)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        xk, rn = cycle(cop, invs, Fs, x0s)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    rn = float(rn)
    x1, r1 = compiled.make_fgmres_cycle(sop.mult, lambda v: inv * v, k)(
        torch.as_tensor(F, device=device), torch.zeros_like(d))
    r1 = float(r1)
    ms = _median_ms(lambda: cycle(cop, invs, Fs, x0s), reps=3, inner=1,
                    warmup=1)
    log(f"[cart] mx=16 make_cart_fgmres({k}) over {CART_OP_GRID}, no host "
        f"sync: ||F - A x|| {rn:.10e} vs single-device {r1:.10e} (relative "
        f"{abs(rn - r1) / r1:.3e}), {ms:.2f} ms per cycle ({card})")
    check(abs(rn - r1) <= 1e-8 * r1, "cart: the sharded cycle's residual "
          "differs from the single-device cycle's")
    del sop, cop, cslv, blk, pop, xs, yc, xt, yt, Fs, invs, x0s, xk, x1
    torch.cuda.empty_cache()

    # --- DistABFSolver over 4 slabs vs the single-device float64 solve --
    single = ABFSolver(mesh, fes, coeff, bc_idx, bc_vals, device=device,
                       nlevels=3)
    Fd = F.copy()
    Fd[: mesh.nu][bc_idx] = bc_vals
    Fd = Fd + single.setup["rhs_diri"]
    r1 = single.solve(Fd)
    t0 = time.perf_counter()
    dslv = DistABFSolver(mesh, fes, coeff, bc_idx, bc_vals,
                         [device] * CART_SLABS, nlevels=3)
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    rd = dslv.solve(Fd)
    t_solve = time.perf_counter() - t0
    rel = _rel(rd["x"], r1["x"])
    log(f"[cart] mx=16 DistABFSolver over {CART_SLABS} slabs: {rd['reason']} "
        f"in {rd['its']} its (single device {r1['its']}), x relative "
        f"{rel:.3e}; setup {t_setup:.2f} s, solve {t_solve:.3f} s ({card})")
    check(rd["its"] == r1["its"] and rd["reason"] == r1["reason"]
          == "CONVERGED_RTOL", "cart: the slab solve's iterations differ")
    check(rel <= 1e-10, f"cart: the slab solve's x differs by {rel:.3e}")
    del single, dslv
    torch.cuda.empty_cache()

    # --- the flagship through the driver, sharded over 4 shards --------
    a00.LAUNCHES.reset()
    r1 = tdriver.saddle_solve(Options.from_args(CART_ARGV), 3,
                              log=lambda *a: None, devices=[device])
    applies1 = a00.LAUNCHES.applies
    check(r1["mode"] == "direct", f"cart: reference ran as {r1['mode']}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a00.LAUNCHES.reset()
    lines = []
    r = tdriver.saddle_solve(Options.from_args(CART_ARGV), 3,
                             log=lines.append,
                             devices=[device] * CART_DEVICES)
    launches, applies = a00.LAUNCHES.n, a00.LAUNCHES.applies
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    slv = r["solver"]
    halos = slv.blocks.halo_exchanges
    its, t_setup, t_solve = r["its"], r["seconds"]["setup"], \
        r["seconds"]["solve"]
    for ln in (lines[-3], lines[-2], lines[-1]):
        log(f"[cart] {ln}")
    check(r["mode"] == "cart" and slv.part.dev_shape == (1, 2, 2),
          f"cart: driver ran as {r['mode']}")
    check(r["reason"] == r1["reason"] == "CONVERGED_RTOL"
          and its == r1["its"],
          f"cart: {r['reason']} in {its} its, the single device "
          f"{r1['reason']} in {r1['its']}")
    h, h1 = np.array(r["history"]), np.array(r1["history"])
    # entry by entry, each against its own size: the sharded sums are in
    # another order, and the worst entry read 2.05e-8 on the H100
    hrel, hworst = _rel(h, h1), float(np.max(np.abs(h - h1) / h1))
    xrel = _rel(r["X"], r1["X"])
    check(hworst <= HIST_TOL, f"cart: history entry differs by {hworst:.3e}")
    check(xrel <= 1e-9, f"cart: x differs by {xrel:.3e}")
    check(launches > 0 and launches == 2 * applies
          and applies % CART_DEVICES == 0,
          f"cart: {launches} K1 launches in {applies} applies")
    # independent float64 true residual with the port's parity operator
    s1 = r1["solver"]
    op64, aux64 = s1.setup["op64"], tree_aux(s1.setup["op64"])
    F64 = s1.vec_to_tree(r["F"], dtype=torch.float64)
    true = float(torch.linalg.norm(F64 - mult_tree(
        op64, aux64, s1.vec_to_tree(r["X"], dtype=torch.float64))))
    log(f"[cart] true float64 residual {true:.6e}, last monitored "
        f"{r['rnorm']:.6e}, ||F|| {float(torch.linalg.norm(F64)):.6e}")
    check(abs(true - r["rnorm"]) <= 1e-4 * r["rnorm"],
          "cart: the true residual differs from the monitored one")
    # one sharded apply: 2 K1 launches per shard; a repeated solve
    n0 = a00.LAUNCHES.n
    slv.blocks.saddle_mult(slv.shard_saddle(r["X"]))
    check(a00.LAUNCHES.n - n0 == 2 * CART_DEVICES,
          "cart: K1 launches per sharded apply")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = slv.solve(r["F"])
    torch.cuda.synchronize()
    t_again = time.perf_counter() - t0
    bitwise = bool(np.array_equal(again["x"], r["X"]))
    check(again["its"] == its and _rel(again["x"], r["X"]) <= 1e-12,
          "cart: a repeated sharded solve differs")
    log(f"[cart] mx=32 ndof {r['mesh'].ndof} over {CART_DEVICES} shards "
        f"{slv.part.dev_shape} on one card: {its} its (single device "
        f"{r1['its']}), history relative {hrel:.3e} (worst entry "
        f"{hworst:.3e}), x relative {xrel:.3e}; "
        f"setup {t_setup:.2f} s (single device "
        f"{r1['seconds']['setup']:.2f} s), solve {t_solve:.3f} s, repeated "
        f"{t_again:.3f} s ({'bitwise equal' if bitwise else 'to 1e-12'}; "
        f"single device {r1['seconds']['solve']:.3f} s), "
        f"{1e3 * t_solve / its:.1f} ms per outer it, {halos} halo "
        f"exchanges, {launches} K1 launches in {applies} applies (single "
        f"device {applies1} applies), peak mem "
        f"{peak:.2f} GiB ({card})")
    return launches, applies


# the bench phase's schedules beside the tuned one, and the (rounds, inner
# its) bands of each around the first card run's counts (tuned 4 / 37,
# abf.opts 3 / 35, fixed3 4 / 72 on an H100; PERF.md section 6): inner its
# +-20%, since float32 perturbations of 1e-7 move them by ~10%
BENCH_OTHERS = {"abfopts": bench.ABFOPTS_KW, "fixed3": {"u_fixed_vcycles": 3}}
BENCH_BANDS = {"solve_": ((3, 5), (30, 44)),
               "solve_abfopts_": ((3, 4), (28, 42)),
               "solve_fixed3_": ((3, 5), (58, 86))}
BENCH_INNER = 100


def phase_bench(device, card):
    """The port's bench at mx=32 (apply and solve legs); prints its JSON
    line and returns the K1 (launches, applies) of the phase."""
    torch.cuda.synchronize()
    a00.LAUNCHES.reset()
    t0 = time.perf_counter()
    extras = bench.bench_apply(32, BENCH_INNER, 5, device)
    t_apply = time.perf_counter() - t0
    extras.update(bench.bench_solve(32, 1e-8, device, others=BENCH_OTHERS))
    launches, applies = a00.LAUNCHES.n, a00.LAUNCHES.applies
    log(json.dumps(bench.result_line(extras, 32, 1e-8, device)))
    kb = extras["kernel_breakdown"]
    roof, cal = kb["roofline"], kb["device_calibration"]
    log(f"[bench] apply mx=32: graph replay {extras['t_apply_us']:.2f} us "
        f"(min/median/max {kb['apply_spread_us']}), eager "
        f"{extras['t_apply_eager_us']:.2f} us ({kb['apply_eager_spread_us']}),"
        f" normloop {kb['apply_normloop_us']:.2f} us; effective CSR "
        f"{extras['effective_csr_gbs']} GB/s, {extras['apply_tflops']} "
        f"TFLOP/s, {roof['fraction_of_floor']} of the data-sheet floor "
        f"{roof['t_floor_us']} us, {roof['fraction_of_shape_ceiling']} of the "
        f"shape ceiling {cal['t_2gemm_shape_us']} us; triad "
        f"{cal['stream_gbs']} GB/s, 4096^3 GEMM {cal['gemm4k_f32_tflops']} "
        f"TFLOP/s; power rho {kb['power_rho']:.6g}; {t_apply:.1f} s ({card})")
    check(extras["apply_timing"] == "graph", "bench: the apply was not "
          "timed as a CUDA graph replay")
    check(kb["graph_bitwise_equal"], "bench: the graph replay differs from "
          "the eager apply loop")
    check(kb["k1_launches_per_loop"] == 2 * BENCH_INNER,
          f"bench: {kb['k1_launches_per_loop']} K1 launches in one eager "
          f"loop of {BENCH_INNER} applies")
    for pre, ((r0, r1), (i0, i1)) in BENCH_BANDS.items():
        rounds, its = extras[pre + "ir_rounds"], extras[pre + "outer_its"]
        rel = extras[pre + "recomputed_rel_resid"]
        log(f"[bench] {pre[:-1]}: {rounds} rounds, {its} inner its, median "
            f"{extras[pre + 'seconds']:.3f} s (min/median/max "
            f"{extras[pre + 'spread_s']}), {extras[pre + 'ms_per_outer_it']}"
            f" ms/outer it, true float64 relative residual {rel:.3e} "
            f"(recomputed), setup {extras['solve_setup_seconds']} s ({card})")
        check(extras[pre + "converged"] and not extras[pre + "stalled"],
              f"bench {pre[:-1]}: did not converge or stalled")
        check(rel <= 1e-8, f"bench {pre[:-1]}: true residual {rel:.3e}")
        check(r0 <= rounds <= r1 and i0 <= its <= i1,
              f"bench {pre[:-1]}: {rounds} rounds / {its} inner its outside "
              f"{r0}-{r1} / {i0}-{i1}")
    return launches, applies


def _ranged(name, fn):
    def wrapped(*a, **k):
        with torch.profiler.record_function(name):
            return fn(*a, **k)
    return wrapped


# ROADMAP section 2's K2-K7, as the port's functions whose device work each
# counts (the innermost enclosing one; K1 by kernel name wherever it runs)
PROFILE_RANGES = (("K2 mult_tree", tabf, "mult_tree"),
                  ("K3 mp_apply", tabf, "mp_apply"),
                  ("K4 stencil_apply", tabf, "stencil_apply"),
                  ("K5 transfers", tabf, "prolong_parity"),
                  ("K5 transfers", tabf, "restrict_parity"),
                  ("K5 transfers", tabf, "prolong_grid"),
                  ("K5 transfers", tabf, "restrict_grid"),
                  ("K6 cheb_smooth", treeops, "cheb_smooth"),
                  ("K7 dots", treeops, "tdot"),
                  ("K7 dots", treeops, "_bdots"))


def phase_profile():
    """One mx=32 IR solve under the bench's tuned schedule with
    torch.profiler, after a warm-up solve: device time by K1-K7 (the rest:
    Krylov vector updates, the coarse matvec, casts), by kernel, the card's
    busy share of the unprofiled solve, kernel launches, then the
    profiler's table."""
    from torch.profiler import ProfilerActivity, profile
    device = torch.device("cuda", 0)
    p = bench._build_problem(32, with_rhs=True)
    slv = tabf.ABFSolver(p["mesh"], p["fes"], p["coeff"], p["bc_idx"],
                         p["bc_vals"], device=device, dtype=torch.float32,
                         nlevels=bench.bench_nlevels(p["mesh"]), ir=True,
                         **bench.bench_solver_kw(env=False))
    F = p["F_raw"] + slv.setup["rhs_diri"]
    slv.solve_ir(F, rtol=1e-8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = slv.solve_ir(F, rtol=1e-8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    saved = [(mod, attr, getattr(mod, attr)) for _, mod, attr in
             PROFILE_RANGES]
    for (name, mod, attr), (_, _, fn) in zip(PROFILE_RANGES, saved):
        setattr(mod, attr, _ranged(name, fn))
    a00.LAUNCHES.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res = slv.solve_ir(F, rtol=1e-8)
            torch.cuda.synchronize()
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    check(res["converged"], "profiled solve did not converge")
    ka = prof.key_averages()
    names = {name for name, _, _ in PROFILE_RANGES}
    # kernel rows only: an operator's row repeats its kernels' time, and a
    # range's device-side row spans the kernels inside it
    dev = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA
           and self_device_us(e) > 0 and e.key not in names]
    total = sum(self_device_us(e) for e in dev) / 1e6
    check(total > 0, "the profiler recorded no device time")
    buckets = {"K1 a00_apply": sum(self_device_us(e) for e in dev
                                   if "a00" in e.key) / 1e6}
    for e in prof.events():
        for k in e.kernels:
            if "a00" in k.name:
                continue
            q = e
            while q is not None and q.name not in names:
                q = q.cpu_parent
            if q is not None:
                buckets[q.name] = buckets.get(q.name, 0.0) + k.duration / 1e6
    buckets["rest"] = total - sum(buckets.values())
    launches = sum(e.count for e in ka if e.key in ("cudaLaunchKernel",
                                                    "cuLaunchKernel",
                                                    "cudaLaunchKernelExC"))
    log(f"[profile] mx=32 IR solve, tuned schedule: unprofiled wall "
        f"{wall:.3f} s, {res['rounds']} rounds / {res['inner_its']} inner "
        f"its, device time {total:.3f} s (busy {100 * total / wall:.1f}% of "
        f"the unprofiled wall), {a00.LAUNCHES.applies} K1 applies, kernel "
        f"launches {launches}")
    for name in sorted(buckets):
        log(f"[profile] {name:18s} {buckets[name]:8.3f} s "
            f"({100 * buckets[name] / total:5.1f}% of device time)")
    for e in sorted(dev, key=self_device_us, reverse=True)[:12]:
        log(f"[profile] {self_device_us(e) / 1e3:10.3f} ms "
            f"{e.count:7d} x  {e.key[:90]}")
    log(ka.table(sort_by="self_cuda_time_total", row_limit=25))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = phase_device()
    phase_build()
    if "--profile" in sys.argv[1:]:
        phase_profile()
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    k1 = phase_k1(device)
    phase_anchor()
    launches, applies = phase_main()
    phase_host_anchor()
    phase_host_mg(device)
    t0 = time.perf_counter()
    c_launches, c_applies, _ = phase_compiled(device, card)
    phase_outputs(device, card)
    phase_ex42(device, card)
    t_cart = time.perf_counter()
    cart_launches, cart_applies = phase_cart(device, card)
    log(f"[smoke] cart phase {time.perf_counter() - t_cart:.1f} s")
    t_bench = time.perf_counter()
    bench_launches, bench_applies = phase_bench(device, card)
    log(f"[smoke] bench phase {time.perf_counter() - t_bench:.1f} s")
    log(f"[smoke] compiled, outputs, ex42, cart and bench phases "
        f"{time.perf_counter() - t0:.1f} s; whole script "
        f"{time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [{
        "name": "a00_apply", "route": "cuda",
        "source": "exsaddle_tpu_torch/csrc/a00_apply.cu",
        "replaces": "exsaddle_tpu/pallas_apply.py:61",
        "launches": launches, "applies": applies,
        "launches_per_apply": launches / applies,
        "compiled_launches": c_launches, "compiled_applies": c_applies,
        "cart_launches": cart_launches, "cart_applies": cart_applies,
        "bench_launches": bench_launches, "bench_applies": bench_applies,
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_us": 1e3 * k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
