"""K4, the block stencil (exsaddle_tpu_torch/csrc/stencil_apply.cu), on one
CUDA card: its pipeline sweep, and a byte-for-byte check against an
earlier version of its source.

    python3 k4_tune.py                     # the sweep
    python3 k4_tune.py --parent OLD.cu     # the sweep, then the check
    python3 k4_tune.py --parent OLD.cu --no-sweep
    python3 k4_tune.py --no-sweep --cart-walls 5

The sweep times every pipeline shape kernels/stencil.py's CONFIG can take
(nodes per tile, warps per CTA, stages per warp, CTAs per SM) that fits in
shared memory, on the mx=32 flagship's own L-2 (33^3 nodes) and L-3 (17^3)
stencils in float32 and float64: device us per apply, 50 applies captured
as one CUDA graph and replayed, hot (one input) and cold (inputs cycled
through copies that move 3x the 50 MB L2), as chip_smoke.py's phase
mg_kernels times them. It prints one line per shape and, per dtype, the
shape with the least hot L-2 + L-3 time (the V-cycle applies one W back to
back, so the main path runs near the hot times). Then, with the chosen
shapes, seeded 3D stencils at the L-2 grid with nd = 3 and nd = 2: each
one's share of its HBM bound, where nd = 2's per-lane shared-memory stride
(K = 108 values) shares banks and nd = 3's (243) does not.

The check builds OLD.cu (a K4 source with the first version's C ABI,
stencil_accum_f32 / _f64 on the padded form) into a library of its own
and compares outputs byte for byte: the new kernel's padded and
zero-boundary applies against OLD's apply on the flagship's L-2 and L-3
stencils in both precisions, on the mx=32 cart flagship's four L-2 shard
stencils (their ghosted operands) and replicated L-3 stencil, and on a
grid whose node count is no tile multiple; each fused epilogue against
OLD's apply followed by K6 (csrc/cheb_update.cu) or the subtraction. It
exits 1 if any output differs.

--cart-walls N times N device-loop solves of the mx=32 cart flagship (4
shards on this card, chip_smoke.py's CART_ARGV through saddle_solve) with
chip_smoke.py's _cart_solve and prints one JSON line: walls, graph spans,
iterations, K4, K6 and K5 launches per solve. Run from the root of another
checkout (a copy of this file there), it times that checkout's code, so
two commits compare in one call. Needs a CUDA card and nvcc."""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs
from exsaddle_tpu_torch import abf as tabf
from exsaddle_tpu_torch import bench
from exsaddle_tpu_torch import driver as tdriver
from exsaddle_tpu_torch.kernels import _build, cheb, stencil
from exsaddle_tpu_torch.options import Options

F32, F64 = torch.float32, torch.float64
SMEM_MAX = 232448


def log(*a):
    print(*a, flush=True)


def flagship_stencils(device):
    """{"L-2": W, "L-3": W} of the mx=32 flagship (4 levels), float64."""
    p = bench._build_problem(32)
    _, data, _ = tabf.build_abf(p["mesh"], p["fes"], p["coeff"],
                                p["bc_idx"], p["bc_vals"], device=device,
                                dtype=F64, nlevels=4)
    return {"L-2": data["stencils"][1], "L-3": data["stencils"][0]}


def shapes(dtype):
    """Every (tn, warps, stages, ctas) whose CTA fits in shared memory at
    the 3D nd = 3 tile size, without repeats of what fits per SM."""
    out = []
    for tn in (16, 32):
        tile = tn * 243 * (4 if dtype == F32 else 8)
        for warps in (1, 2, 4):
            for stages in (2, 3, 4):
                smem = ((warps * stages * 8 + 127) // 128) * 128 \
                    + warps * stages * tile
                if smem > SMEM_MAX:
                    continue
                for ctas in range(1, SMEM_MAX // smem + 1):
                    out.append((tn, warps, stages, ctas))
    return out


def sweep(device, stencils):
    rng = np.random.default_rng(3)
    best = {}
    for dtype in (F32, F64):
        saved = stencil.CONFIG[dtype]
        cases = []
        for lvl, W64 in stencils.items():
            W = W64.to(dtype).contiguous()
            xp = torch.nn.functional.pad(torch.as_tensor(
                rng.standard_normal(tuple(W.shape[:3]) + (3,)), dtype=dtype,
                device=device), (0, 0, 1, 1, 1, 1, 1, 1))
            nbytes = W.element_size() * (W.numel() + xp.numel()
                                         + W.numel() // 81)
            cases.append((lvl, W, xp, cs._cold_copies((W, xp), nbytes)))
        scores = []
        try:
            for shape in shapes(dtype):
                stencil.CONFIG[dtype] = shape
                times = {}
                for lvl, W, xp, copies in cases:
                    hot = cs._graph_ms([lambda: stencil.stencil_accum(W, xp)]
                                       * cs.MG_REPS)
                    reps = -(-cs.MG_REPS // len(copies))
                    cold = cs._graph_ms(
                        [lambda c=c: stencil.stencil_accum(*c)
                         for c in copies] * reps)
                    times[lvl] = (1e3 * cold, 1e3 * hot)
                score = times["L-2"][1] + times["L-3"][1]
                scores.append((score, shape, times))
                log(f"[k4_tune] {str(dtype)[6:]} tn {shape[0]} warps "
                    f"{shape[1]} stages {shape[2]} ctas {shape[3]}: " + ", ".join(
                        f"{lvl} {c:.2f} / {h:.2f} us" for lvl, (c, h)
                        in times.items()) + " (cold / hot)")
        finally:
            stencil.CONFIG[dtype] = saved
        score, shape, times = min(scores)
        best[dtype] = shape
        log(f"[k4_tune] best {str(dtype)[6:]} by hot L-2 + L-3: tn {shape[0]}"
            f" warps {shape[1]} stages {shape[2]} ctas {shape[3]}: " + ", ".join(
                f"{lvl} {c:.2f} / {h:.2f} us" for lvl, (c, h)
                in times.items()) + f" (cold / hot); CONFIG now "
            f"{stencil.CONFIG[dtype]}")
    return best


def bank_cost(device, card):
    """Cold and hot us per apply of seeded 3D stencils at the 33^3 L-2
    grid, nd = 3 and nd = 2, in both precisions, beside their HBM bound."""
    rng = np.random.default_rng(5)
    grid = (33, 33, 33)
    for nd in (3, 2):
        for dtype in (F32, F64):
            W = torch.as_tensor(rng.standard_normal(grid + (27, nd, nd)),
                                dtype=dtype, device=device)
            xp = stencil._pad(torch.as_tensor(
                rng.standard_normal(grid + (nd,)), dtype=dtype,
                device=device))
            nbytes = W.element_size() * (W.numel() + xp.numel()
                                         + W.numel() // (27 * nd))
            hot = cs._graph_ms([lambda: stencil.stencil_accum(W, xp)]
                               * cs.MG_REPS)
            copies = cs._cold_copies((W, xp), nbytes)
            cold = cs._graph_ms([lambda c=c: stencil.stencil_accum(*c)
                                 for c in copies]
                                * -(-cs.MG_REPS // len(copies)))
            bound = nbytes / cs.PEAK_BYTES * 1e3
            log(f"[k4_tune] 3D nd {nd} {str(dtype)[6:]} at 33^3 (K = "
                f"{27 * nd * nd}): {1e3 * cold:.2f} / {1e3 * hot:.2f} us "
                f"cold / hot, bound {1e3 * bound:.2f} us (bytes: "
                f"{nbytes / 1e6:.1f} MB), {100 * bound / cold:.1f}% / "
                f"{100 * bound / hot:.1f}% of it ({card})")
            del W, xp, copies


def build_old(src, out_dir):
    """ctypes library of an old K4 source (its C ABI: stencil_accum_f32 /
    _f64 (W, xp, y, ndim, nd, nx, ny, nz, stream))."""
    out = os.path.join(out_dir, "libk4_old.so")
    cmd = [_build._nvcc()] + [f for f in _build.NVCC_FLAGS
                              if f not in ("-Xptxas", "-v")] + [
        "-shared", "-o", out, src]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    for name in ("stencil_accum_f32", "stencil_accum_f64"):
        f = getattr(lib, name)
        f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        f.restype = ctypes.c_int
    return lib


def old_accum(lib, W, xp):
    ndim = xp.ndim - 1
    grid = tuple(s - 2 for s in xp.shape[:ndim])
    y = torch.empty(grid + (xp.shape[-1],), dtype=xp.dtype,
                    device=xp.device)
    fn = lib.stencil_accum_f32 if xp.dtype == F32 else lib.stencil_accum_f64
    err = fn(W.data_ptr(), xp.data_ptr(), y.data_ptr(), ndim, xp.shape[-1],
             grid[-1], grid[-2], grid[0] if ndim == 3 else 1,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"old K4 launch failed ({err})")
    return y


def _bits(t):
    return t.view(torch.int32 if t.dtype == F32 else torch.int64)


def same(a, b):
    torch.cuda.synchronize()
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def cart_operands(device):
    """[(name, W, xp)] of the mx=32 cart flagship (4 shards, 1x2x2):
    each shard's L-2 stencil with a seeded ghosted operand (as its
    smoother builds it) and the replicated L-3 stencil, float64."""
    from exsaddle_tpu_torch.parallel.shard_mesh import ghost_extend_axis
    r = tdriver.saddle_solve(Options.from_args(cs.CART_ARGV), 3,
                             log=lambda *a: None,
                             devices=[device] * cs.CART_DEVICES)
    slv = r["solver"]
    dd, smesh, nd = slv.ddata, slv.smesh, slv.blocks.nd
    rng = np.random.default_rng(17)
    xp = dd["inv_diag_l1"].map(lambda t: torch.as_tensor(
        rng.standard_normal(tuple(t.shape)), dtype=t.dtype, device=t.device))
    for k in range(nd):
        xp = ghost_extend_axis(smesh, xp, nd - 1 - k)
    out = [(f"cart L-2 shard {i}", W, x)
           for i, (W, x) in enumerate(zip(dd["W1"].parts, xp.parts))]
    rep = next(iter(dd["repl"].values()))
    W3 = rep["stencils"][-1]
    x3 = torch.as_tensor(rng.standard_normal(tuple(W3.shape[:3]) + (nd,)),
                         dtype=W3.dtype, device=device)
    out.append(("cart replicated L-3", W3,
                torch.nn.functional.pad(x3, (0, 0, 1, 1, 1, 1, 1, 1))))
    return out


def check_against(lib, device, stencils):
    rng = np.random.default_rng(21)
    cases = []
    for lvl, W64 in stencils.items():
        for dtype in (F32, F64):
            W = W64.to(dtype).contiguous()
            x = torch.as_tensor(rng.standard_normal(tuple(W.shape[:3]) + (3,)),
                                dtype=dtype, device=device)
            cases.append((f"flagship {lvl} {str(dtype)[6:]}", W,
                          stencil._pad(x), True))
    Wt = torch.as_tensor(rng.standard_normal((5, 7, 9, 27, 3, 3)),
                         device=device)
    xt = torch.as_tensor(rng.standard_normal((5, 7, 9, 3)), device=device)
    for dtype in (F32, F64):
        cases.append((f"tail 5x7x9 (315 nodes) {str(dtype)[6:]}",
                      Wt.to(dtype), stencil._pad(xt.to(dtype)), True))
    for name, W, xp in cart_operands(device):
        for dtype in (F32, F64):
            # the ghost planes hold the neighbours' values: no zero-boundary
            # form of these operands
            cases.append((f"{name} {str(dtype)[6:]}", W.to(dtype),
                          xp.to(dtype), name.startswith("cart replicated")))
    bad = []
    for name, W, xp, zero_ghosts in cases:
        x = stencil._interior(xp).contiguous()
        y = old_accum(lib, W, xp)
        b, d, q = (torch.as_tensor(rng.standard_normal(tuple(x.shape)),
                                   dtype=x.dtype, device=device)
                   for _ in range(3))
        scale, omega = 0.37, 1.61
        want = {"apply": y, "residual": b - y,
                "cheb_first": cheb.cheb_first(b, y, d, x, scale),
                "cheb_step": cheb.cheb_step(b, y, d, x, q, scale, omega)}
        forms = [(True, xp)] + ([(False, x)] if zero_ghosts else [])
        got = {}
        for padded, v in forms:
            tag = "padded" if padded else "zero-boundary"
            got[f"apply {tag}"] = (stencil.stencil_accum(W, v) if padded
                                   else stencil.stencil_apply(W, v))
            got[f"residual {tag}"] = stencil.stencil_residual(
                W, v, b, padded=padded)
            got[f"cheb_first {tag}"] = stencil.stencil_cheb_first(
                W, v, b, d, scale, padded=padded)
            got[f"cheb_step {tag}"] = stencil.stencil_cheb_step(
                W, v, b, d, q, scale, omega, padded=padded)
        diff = [k for k, v in got.items() if not same(v, want[k.split()[0]])]
        bad += [(name, k) for k in diff]
        log(f"[k4_tune] {name} {tuple(W.shape[:-3])}: "
            + ("every output byte for byte the old apply (+ K6 / the "
               "subtraction): " + ", ".join(got) if not diff else
               f"DIFFERS in {diff}"))
    return bad


def cart_walls(device, n, card):
    r = tdriver.saddle_solve(Options.from_args(cs.CART_ARGV), 3,
                             log=lambda *a: None,
                             devices=[device] * cs.CART_DEVICES)
    slv = r["solver"]
    recs = [cs._cart_solve(slv, r["F"]) for _ in range(n)]
    log(json.dumps({"cart_walls": [q["wall"] for q in recs],
                    "spans": [q["span"] for q in recs],
                    "its": [q["res"]["its"] for q in recs],
                    "loop": r["loop"],
                    "K4": recs[0]["counts"]["stencil_accum"],
                    "K6": recs[0]["counts"]["cheb_update"],
                    "K5": sum(recs[0]["counts"][k] for k in cs.K5_KERNELS),
                    "card": card}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="an old K4 source to check against")
    ap.add_argument("--no-sweep", action="store_true")
    ap.add_argument("--cart-walls", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_tune: no CUDA device available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = cs.phase_device()
    cs.phase_build()
    if args.cart_walls:
        cart_walls(device, args.cart_walls, card)
        if args.no_sweep and not args.parent:
            return 0
    t0 = time.perf_counter()
    stencils = flagship_stencils(device)
    log(f"[k4_tune] flagship setup {time.perf_counter() - t0:.1f} s ({card})")
    if not args.no_sweep:
        sweep(device, stencils)
        bank_cost(device, card)
    if args.parent:
        with tempfile.TemporaryDirectory() as tmp:
            lib = build_old(args.parent, tmp)
            bad = check_against(lib, device, stencils)
        log(f"[k4_tune] against {args.parent}: "
            + (f"{len(bad)} outputs differ: {bad}" if bad
               else f"every output byte for byte ({card})"))
        if bad:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
