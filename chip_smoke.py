"""Smoke test of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

1. device  -- a CUDA device must be present; prints nvidia-smi's name and
              power limit.
2. build   -- compiles the port's CUDA kernels from exsaddle_tpu_torch/csrc/
              into exsaddle_tpu_torch/_build/ (skipped when built already).
3. K1      -- the A00 kernel against its plain PyTorch version at the
              main path's shapes (mx=32 pseudoice, 3D) and on 2D SolCx at
              mx=my=64, in float32 and float64; median per-apply times.
4. anchor  -- the driver in direct float64 mode at mx=6 (3 MG levels) must
              reach CONVERGED_RTOL in <= 20 iterations with the reference's
              initial residual.
5. main    -- the driver on the flagship: model 11, size_x 0.1, mx=32,
              float32 inner solves with float64 iterative refinement to a
              true relative residual of 1e-8, 4 MG levels. The residual is
              recomputed with the port's float64 operator, and the A00
              kernel's launch count must grow during the solve.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from exsaddle_tpu_torch import driver as tdriver
from exsaddle_tpu_torch import models as emodels
from exsaddle_tpu_torch.assembly import FESpace
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
    for line in blog.splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            log(f"[build] {line.strip()}")


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


def _median_ms(fn, reps=30, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def phase_k1(device):
    """K1 against its plain version; returns the float32 3D numbers (the
    main path's working precision and shapes)."""
    out = {}
    cases = [("3D mx=32 pseudoice", 3, (32, 32, 32), 11, (0.1, 1.0, 1.0)),
             ("2D mx=my=64 SolCx", 2, (64, 64), 0, (1.0, 1.0))]
    for name, ndim, m, model, size in cases:
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
            ms = _median_ms(lambda: a00.a00_apply(op, x))
            plain_ms = _median_ms(lambda: a00.a00_apply_plain(op, x))
            log(f"[K1] {name} {str(dtype)[6:]}: max_abs_err {err:.3e} "
                f"rel {rel:.3e} (tol {TOL[dtype]:g}) kernel {ms:.4f} ms "
                f"plain {plain_ms:.4f} ms")
            check(ok, f"K1 {name} {dtype} disagrees with its plain version")
            if ndim == 3 and dtype == torch.float32:
                out = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
            del op, x, y_k, y_p
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
    a00.LAUNCHES.reset()
    r = tdriver.saddle_solve(Options.from_args(argv), 3, log=log)
    launches = a00.LAUNCHES.n
    res = r["res"]
    slv = r["solver"]
    log(f"[main] A00 kernel launches during the driver run: {launches}")
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
    log(f"[main] mx=32 ndof {r['mesh'].ndof}: setup "
        f"{r['seconds']['setup']:.2f} s, first solve "
        f"{r['seconds']['solve']:.3f} s, solve median of 3 {t_solve:.3f} s "
        f"(spread {min(times):.3f}-{max(times):.3f}), rounds {res['rounds']},"
        f" inner its {its}, {1e3 * t_solve / max(its, 1):.2f} ms/outer it, "
        f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    phase_device()
    phase_build()
    k1 = phase_k1(device)
    phase_anchor()
    launches = phase_main()
    log(json.dumps({"kernels": [{
        "name": "a00_apply", "route": "cuda",
        "source": "exsaddle_tpu_torch/csrc/a00_apply.cu",
        "replaces": "exsaddle_tpu/pallas_apply.py:61",
        "launches": launches, "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
