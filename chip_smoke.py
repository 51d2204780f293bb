"""Smoke test of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py              # every phase below
    python3 chip_smoke.py --profile    # device, build, then one profiled
                                       # mx=32 IR solve (PERF.md section 5)

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

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from exsaddle_tpu_torch import driver as tdriver
from exsaddle_tpu_torch import models as emodels
from exsaddle_tpu_torch import native
from exsaddle_tpu_torch.assembly import FESpace
from exsaddle_tpu_torch.grid_ops import gather_u_parity, split_u_parity
from exsaddle_tpu_torch.kernels import _build
from exsaddle_tpu_torch.kernels import a00
from exsaddle_tpu_torch.matfree import (ParityMatFreeOperator, mult_tree,
                                        tree_aux)
from exsaddle_tpu_torch.mesh import SaddleMesh
from exsaddle_tpu_torch.options import Options

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


def _operator(ndim, m, model, size, dtype, device):
    opts = Options.from_args(["-model", str(model)])
    ctx = emodels.ModelContext(opts, ndim, log=lambda *a, **k: None)
    mesh = SaddleMesh(ndim, m, size)
    fes = FESpace(mesh)
    bc_idx, _ = emodels.create_bc_list(ctx, mesh)
    coeff = tdriver.fine_coefficients(ctx, fes)
    bc_mask = np.zeros(mesh.ndof)
    bc_mask[:mesh.nu][bc_idx] = 1.0
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
    return {e.key: (e.count / calls, _self_device_us(e) / e.count)
            for e in prof.key_averages()
            if "a00" in e.key and _self_device_us(e) > 0}


def _self_device_us(evt):
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


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


def phase_profile():
    """One mx=32 IR solve of the main path under torch.profiler, after a
    warm-up solve: device time by kernel, the card's busy share of the
    unprofiled solve, kernel launches, then the profiler's table."""
    from torch.profiler import ProfilerActivity, profile
    argv = tdriver.ABF_OPTS + (
        "-model 11 -size_x 0.1 -mx 32 -ir -rtol_true 1e-8 "
        "-saddle_fieldsplit_u_pc_mg_levels 4").split()
    r = tdriver.saddle_solve(Options.from_args(argv), 3, log=lambda *a: None)
    slv, F = r["solver"], r["F"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = slv.solve_ir(F, rtol=1e-8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    a00.LAUNCHES.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = slv.solve_ir(F, rtol=1e-8)
        torch.cuda.synchronize()
    check(res["converged"], "profiled solve did not converge")
    ka = prof.key_averages()
    # device-side rows only: an operator's row repeats its kernels' time
    dev = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA
           and _self_device_us(e) > 0]
    total = sum(_self_device_us(e) for e in dev) / 1e6
    check(total > 0, "the profiler recorded no device time")
    k1 = sum(_self_device_us(e) for e in dev if "a00" in e.key) / 1e6
    launches = sum(e.count for e in ka if e.key in ("cudaLaunchKernel",
                                                    "cuLaunchKernel",
                                                    "cudaLaunchKernelExC"))
    log(f"[profile] mx=32 IR solve: unprofiled wall {wall:.3f} s, "
        f"{res['rounds']} rounds / {res['inner_its']} inner its, device "
        f"time {total:.3f} s (busy {100 * total / wall:.1f}% of the "
        f"unprofiled wall), K1 {k1:.3f} s ({100 * k1 / total:.1f}%) in "
        f"{a00.LAUNCHES.applies} applies, kernel launches {launches}")
    for e in sorted(dev, key=_self_device_us, reverse=True)[:12]:
        log(f"[profile] {_self_device_us(e) / 1e3:10.3f} ms "
            f"{e.count:7d} x  {e.key[:90]}")
    log(ka.table(sort_by="self_cuda_time_total", row_limit=25))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    phase_device()
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
    log(json.dumps({"kernels": [{
        "name": "a00_apply", "route": "cuda",
        "source": "exsaddle_tpu_torch/csrc/a00_apply.cu",
        "replaces": "exsaddle_tpu/pallas_apply.py:61",
        "launches": launches, "applies": applies,
        "launches_per_apply": launches / applies,
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
