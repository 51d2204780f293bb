"""K1 (exsaddle_tpu_torch/csrc/a00_apply.cu) on one CUDA card beside an
earlier build of its source, and the fine level's fused forms against the
launches they replace; or, with --routing k3, K3 (csrc/mp_apply.cu) beside
an earlier build of its source.

    python3 k1_tune.py --parent OLD.cu [--variant ALT.cu ...]
    python3 k1_tune.py --routing k3 --parent OLD_MP.cu

OLD.cu is a K1 source with the C ABI a00_apply_f32 / _f64 (x,
scale_visc, Bs, ell, ye, y, nd, mx, my, mz, stream), a00_fused_f32 / _f64
(x, keep, scale_visc, Bs, ell, ye, y, ks, ms, b, d, p_km1, scale, omega,
epi, nd, mx, my, mz, stream) and a00_error_string: the dense element
products, before the factored kernel (this version's entries take Bs's
host factors after Bs; parent_fn drops them, so the parent's kernels
run behind K1's entries). Each ALT.cu is a variant of this version's
source (its C ABI, fused forms included; it may include csrc/'s
headers). Each is built into a library of its own.

1. Against the parent: on the mx=32 flagship's fine level (pseudoice,
   3D), a 2D SolCx mesh (64 x 64) and a ragged 3D mesh (5 x 7 x 3
   elements), in float32 and float64, this build's apply byte for byte
   the parent's in 2D (both the dense kernel) and within chip_smoke.TOL
   of it in 3D (the factored kernel), relative to max |y|; its keep form
   byte for byte its own apply of x * ks.
2. Times at the flagship's fine level, both precisions: the parent's
   plain apply, this build's (the factored kernel) and its keep form,
   alternated (parent, this, keep, keep, this, parent), each cold and hot
   (graphs of 50 calls replayed; cold: the vectors cycled through copies
   that move 3x the L2), with each one's element kernel (torch.profiler
   over a replay), beside the bound by bytes of each. With variants:
   each variant's keep, mask and Chebyshev-step forms byte for byte this
   build's, and its keep form timed alternated with this build's (this,
   variants, variants reversed, this).
3. The flagship's device-loop IR solve under the bench's tuned schedule
   (mx=32, float32 inner solves, 4 levels), over one setup, in two
   routings: this PR's (the factored element products) and the parent's
   (the parent's K1 kernels behind K1's entries, fused forms included:
   the dense products). The two sum in other orders, so
   they are an order witness: rounds, inner its and x compared, both
   converged, each routing's K1 launches (and factored applies) per
   solve; their walls alternated (parent, PR, PR, parent, twice; median
   of 3 solves per turn); each routing's rounds, inner its and true
   residuals over 11 more right-hand sides (F_raw perturbed by 1e-6
   relative noise), since float32 counts are chaotic.

--routing k3: OLD_MP.cu is a K3 source with the factored C ABI
k3_mp_apply_f32 / _f64 (x, pscale, Np, b, d, pkm1, scale, omega, out,
epi, ndim, mx, my, mz, stream; it may include csrc/'s headers), built into
a library of its own and installed behind K3's entries (mp_apply and
mp_cheb_step, reading op's Np and pscale where this version reads the
setup's stencil W). First both builds' plain and step forms at the
flagship's p size (33^3 nodes, float32, the single-device p-block's) and
the plain form on a cart shard's box (32 x 16 x 16 elements, float64,
the cart path's), on uniform random Np and pscale and their stencil:
within 1e-5 / 1e-13 of each other over the apply of absolute values,
times alternated (parent, this, this, parent; cold and hot as in 2).
Then step 3 with K3's swap table: the two builds sum in other orders, so
the two solves are the order witness: their rounds, inner iterations and
x are compared, each routing's K3, K5 and K6 launches per solve printed,
and both must converge; last, each routing's rounds, inner iterations
and true residuals over 11 more right-hand sides (F_raw perturbed by
1e-6 relative noise), since float32 counts are chaotic.

The last line is one JSON object with every number. It exits 1 if any
check fails. Needs a CUDA card and nvcc."""

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
from exsaddle_tpu_torch.kernels import _build, a00, mp
from exsaddle_tpu_torch.matfree import tree_aux

F32, F64 = torch.float32, torch.float64
CASES = [("3D mx=32 pseudoice", 3, (32, 32, 32), 11, (0.1, 1.0, 1.0)),
         ("2D mx=my=64 SolCx", 2, (64, 64), 0, (1.0, 1.0)),
         ("3D ragged 5x7x3", 3, (5, 7, 3), 11, (0.1, 1.0, 1.0))]


def log(*a):
    print(*a, flush=True)


def build_parent(src, out_dir):
    """The parent's K1 as its own ctypes library."""
    out = os.path.join(out_dir, "libk1_parent.so")
    cmd = [_build._nvcc()] + _build.NVCC_FLAGS + [
        "-I", _build.CSRC, "-shared", "-o", out, src]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    log(f"[k1_tune] built {src} in {time.perf_counter() - t0:.1f} s")
    lib = ctypes.CDLL(out)
    for sfx in ("_f32", "_f64"):
        f = getattr(lib, "a00_apply" + sfx)
        f.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        f.restype = ctypes.c_int
        f = getattr(lib, "a00_fused" + sfx)
        f.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_double] * 2 + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
    lib.a00_error_string.argtypes = [ctypes.c_int]
    lib.a00_error_string.restype = ctypes.c_char_p
    return lib


def parent_fn(lib):
    """a00._fn's stand-in that launches the parent's kernels: the
    factors' pointer after Bs (argument 3 of the plain entry, 4 of the
    fused one) is dropped, and since the parent has no factored kernel
    its applies are taken back out of LAUNCHES.factored."""
    def fn(dtype, fused=False):
        f = getattr(lib, ("a00_fused" if fused else "a00_apply")
                    + ("_f32" if dtype == F32 else "_f64"))
        at = 4 if fused else 3

        def call(*args):
            a00.LAUNCHES.factored -= args[at] is not None
            return f(*args[:at], *args[at + 1:])
        return lib, call
    return fn


def variant_fn(lib):
    """a00._fn's stand-in that launches a variant library's kernels."""
    return lambda dtype, fused=False: (lib, getattr(
        lib, ("a00_fused" if fused else "a00_apply")
        + ("_f32" if dtype == F32 else "_f64")))


def build_variant(src, out_dir, i):
    """A variant of this version's K1 source as its own library."""
    out = os.path.join(out_dir, f"libk1_variant{i}.so")
    cmd = [_build._nvcc()] + _build.NVCC_FLAGS + [
        "-I", _build.CSRC, "-shared", "-o", out, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(out)
    main = _build.load()
    for sfx in ("_f32", "_f64"):
        for kind in ("a00_apply", "a00_fused"):
            ref = getattr(main, kind + sfx)
            f = getattr(lib, kind + sfx)
            f.argtypes, f.restype = ref.argtypes, ref.restype
    lib.a00_error_string.argtypes = [ctypes.c_int]
    lib.a00_error_string.restype = ctypes.c_char_p
    return lib


class installed:
    """K1's entries launch another library's kernels inside the block (fn:
    parent_fn's or variant_fn's stand-in for a00._fn)."""

    def __init__(self, fn):
        self.fn = fn

    def __enter__(self):
        a00._fn(F32)                       # bind this build's first
        self.saved = a00._fn
        a00._fn = self.fn

    def __exit__(self, *exc):
        a00._fn = self.saved


def variants(vlibs, device, card):
    """Each variant's keep, mask and step forms against this build's,
    byte for byte; its keep form's times alternated with this build's."""
    bad, out = [], {}
    name, ndim, m, model, size = CASES[0]
    for dtype in (F32, F64):
        op = cs._operator(ndim, m, model, size, dtype, device)
        aux = tree_aux(op)
        rng = np.random.default_rng(7)
        x, b, q = (torch.as_tensor(rng.standard_normal(op.nu), dtype=dtype,
                                   device=device) for _ in range(3))
        d = torch.as_tensor(rng.uniform(0.5, 1.5, op.nu), dtype=dtype,
                            device=device)
        forms = {"keep": lambda v: a00.a00_apply(op, v, keep=aux[0]),
                 "masked": lambda v: a00.a00_masked(op, aux, v),
                 "step": lambda v: a00.a00_cheb_step(op, aux, b, v, q, d,
                                                     0.37, 1.61)}
        ref = {k: f(x) for k, f in forms.items()}
        builds = [("this", None)] + [(f"variant {i}", variant_fn(lib))
                                     for i, lib in enumerate(vlibs)]
        for bname, fn in builds[1:]:
            with installed(fn):
                same = {k: cs._same_bits(f(x), ref[k])
                        for k, f in forms.items()}
            if not all(same.values()):
                bad.append((bname, str(dtype), same))
            log(f"[k1_tune] {bname} {str(dtype)[6:]}: keep / mask / step "
                f"forms {same} byte for byte this build's")
        rec = {n: [] for n, _ in builds}
        for bname, fn in builds + builds[::-1]:
            if fn is None:
                rec[bname].append(cs._hot_cold(forms["keep"], (x,)))
            else:
                with installed(fn):
                    rec[bname].append(cs._hot_cold(forms["keep"], (x,)))
        for bname, t in rec.items():
            log(f"[k1_tune] {name} {str(dtype)[6:]} keep form, {bname}: "
                "cold " + ", ".join(f"{1e3 * c:.2f}" for _, c in t)
                + " us, hot " + ", ".join(f"{1e3 * h:.2f}" for h, _ in t)
                + f" us ({card})")
        out[str(dtype)[6:]] = {k: [[1e3 * c, 1e3 * h] for h, c in t]
                               for k, t in rec.items()}
        del op, aux, x, b, q, d, ref
        torch.cuda.empty_cache()
    return out, bad


def against_parent(pfn, device):
    bad = []
    for name, ndim, m, model, size in CASES:
        for dtype in (F32, F64):
            op = cs._operator(ndim, m, model, size, dtype, device)
            ks = tree_aux(op)[0]
            x = torch.as_tensor(np.random.default_rng(3).standard_normal(
                op.nu), dtype=dtype, device=device)
            x[::7] = -0.0
            with installed(pfn):
                yp = a00.a00_apply(op, x)
            y = a00.a00_apply(op, x)
            same = cs._same_bits(y, yp)
            rel = float((y - yp).abs().max() / yp.abs().max())
            keep = cs._same_bits(a00.a00_apply(op, x, keep=ks),
                                 a00.a00_apply(op, x * ks))
            if not ((same if ndim == 2 else rel <= cs.TOL[dtype]) and keep):
                bad.append((name, str(dtype), same, keep, rel))
            log(f"[k1_tune] {name} {str(dtype)[6:]}: "
                + (f"{'byte for byte' if same else 'DIFFERS from'} the "
                   f"parent's apply (both dense); " if ndim == 2 else
                   f"factored, within {rel:.3e} of the parent's apply (tol "
                   f"{cs.TOL[dtype]:g}); ")
                + f"keep form {'byte for byte' if keep else 'DIFFERS from'}"
                f" its apply of x * ks")
    return bad


def times(pfn, device, card):
    """Cold / hot us of the parent's plain apply, this one and the keep
    form at the flagship's fine level, alternated, with each one's
    element kernel."""
    out = {}
    name, ndim, m, model, size = CASES[0]
    order = ("parent", "this", "keep", "keep", "this", "parent")
    for dtype in (F32, F64):
        op = cs._operator(ndim, m, model, size, dtype, device)
        ks = tree_aux(op)[0]
        rng = np.random.default_rng(5)
        args = (torch.as_tensor(rng.standard_normal(op.nu), dtype=dtype,
                                device=device),)
        def parent(x):
            with installed(pfn):
                return a00.a00_apply(op, x)
        fns = {"parent": parent,
               "this": lambda x: a00.a00_apply(op, x),
               "keep": lambda x: a00.a00_apply(op, x, keep=ks)}
        rec = {k: [] for k in fns}
        elem = {k: [] for k in fns}
        for k in order:
            (hot, khot), (cold, kcold) = cs._hot_cold(fns[k], args,
                                                      kernels=True)
            rec[k].append([1e3 * cold, 1e3 * hot])
            elem[k].append([cs._element_us(kcold), cs._element_us(khot)])
        for k, t in rec.items():
            form = "a00_apply_keep" if k == "keep" else "a00_apply"
            _, _, bytes_ms, nbytes = cs._fused_bound(op, dtype, form)
            log(f"[k1_tune] {name} {str(dtype)[6:]} {k}: cold "
                + ", ".join(f"{c:.2f}" for c, _ in t) + " us, hot "
                + ", ".join(f"{h:.2f}" for _, h in t)
                + " us; its element kernel cold "
                + ", ".join(f"{c:.2f}" for c, _ in elem[k]) + " us, hot "
                + ", ".join(f"{h:.2f}" for _, h in elem[k])
                + f" us; bound by bytes {1e3 * bytes_ms:.2f} us "
                f"({nbytes / 1e6:.1f} MB) ({card})")
        out[str(dtype)[6:]] = {"apply": rec, "element": elem}
        del op, ks, args
        torch.cuda.empty_cache()
    return out


def build_parent_k3(src, out_dir):
    """The parent's K3 as its own ctypes library."""
    out = os.path.join(out_dir, "libk3_parent.so")
    cmd = [_build._nvcc()] + _build.NVCC_FLAGS + [
        "-I", _build.CSRC, "-shared", "-o", out, src]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    log(f"[k1_tune] built {src} in {time.perf_counter() - t0:.1f} s")
    lib = ctypes.CDLL(out)
    for sfx in ("_f32", "_f64"):
        f = getattr(lib, "k3_mp_apply" + sfx)
        f.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_double] * 2 + [
            ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
    return lib


def parent_k3(lib):
    """The parent's K3 behind K3's entries (mp_apply, mp_cheb_step; W
    unread), counted by form as this build's launches are."""
    def launch(form, op, pscale, pg, b=None, d=None, q=None, scale=0.0,
               omega=0.0):
        nd = len(op.m_el)
        fn = getattr(lib, "k3_mp_apply" + ("_f32" if pg.dtype == F32
                                           else "_f64"))
        out = torch.empty_like(pg)
        ptr = lambda t: ctypes.c_void_p(  # noqa: E731
            0 if t is None else t.data_ptr())
        err = fn(ptr(pg), ptr(pscale), ptr(op.Np), ptr(b), ptr(d), ptr(q),
                 float(scale), float(omega), ptr(out),
                 0 if form == "mp_apply" else 1, nd, op.m_el[0], op.m_el[1],
                 op.m_el[2] if nd == 3 else 1,
                 ctypes.c_void_p(torch.cuda.current_stream(
                     pg.device).cuda_stream))
        if err:
            raise RuntimeError(f"parent K3 launch failed ({err})")
        mp.LAUNCHES.n += 1
        mp.LAUNCHES.by[form] += 1
        return out

    return {"mp_apply": lambda op, ps, W, pg: launch("mp_apply", op, ps, pg),
            "mp_cheb_step": lambda op, ps, W, b, pk, pm, d, sc, om: launch(
                "mp_cheb_step", op, ps, pk, b, d, pm, sc, om)}


def k3_times(entries, device, card):
    """The parent's K3 and this build's at the flagship's p size (float32,
    plain and step) and on a cart shard's box (float64, plain): within the
    kernels' tolerance of each other, times alternated."""
    from types import SimpleNamespace
    out, bad = {}, []
    cases = [("p size", (32, 32, 32), F32, ("mp_apply", "mp_cheb_step")),
             ("cart shard", (32, 16, 16), F64, ("mp_apply",))]
    for case, m_el, dtype, forms in cases:
        rng = np.random.default_rng(41)
        t = lambda a: torch.as_tensor(a, dtype=dtype,  # noqa: E731
                                      device=device)
        nn = tuple(m + 1 for m in m_el)
        grid = tuple(reversed(nn))
        op = SimpleNamespace(m_el=m_el, nn_p=nn,
                             Np=t(rng.uniform(-0.2, 1.0, (27, 8))))
        ps = t(-rng.uniform(0.1, 2.0, (int(np.prod(m_el)), 27)))
        _, _, W = cs._mp_csr(op, ps)
        x, b, q = (t(rng.standard_normal(grid)) for _ in range(3))
        d = t(rng.uniform(0.5, 1.5, grid))
        sc, om = 0.7312345678901234, 1.6180339887498949
        aop = SimpleNamespace(m_el=m_el, nn_p=nn, Np=op.Np.abs())
        mag = float(mp.mp_apply_plain(aop, ps.abs(), x.abs()).max())
        builds = {"parent": entries, "this": {"mp_apply": mp.mp_apply,
                                              "mp_cheb_step": mp.mp_cheb_step}}
        for form in forms:
            if form == "mp_apply":
                args = (x,)
                fns = {k: (lambda v, e=e: e["mp_apply"](op, ps, W, v))
                       for k, e in builds.items()}
            else:
                args = (x, b, q, d)
                fns = {k: (lambda v, bb, qq, dd, e=e: e["mp_cheb_step"](
                    op, ps, W, bb, v, qq, dd, sc, om))
                       for k, e in builds.items()}
            ys = {k: f(*args) for k, f in fns.items()}
            torch.cuda.synchronize()
            err = float((ys["this"] - ys["parent"]).abs().max()) / mag
            if not err <= cs.K4_TOL[dtype] * (1 if form == "mp_apply"
                                              else 1e3):
                bad.append((case, form, err))
            rec = {k: [] for k in fns}
            for k in ("parent", "this", "this", "parent"):
                hot, cold = cs._hot_cold(fns[k], args)
                rec[k].append([1e3 * cold, 1e3 * hot])
            for k, tt in rec.items():
                log(f"[k1_tune] K3 {form} {case} {grid} {str(dtype)[6:]}, "
                    f"{k}: cold " + ", ".join(f"{c:.2f}" for c, _ in tt)
                    + " us, hot " + ", ".join(f"{h:.2f}" for _, h in tt)
                    + f" us; the two builds {err:.3e} apart over the apply "
                    f"of absolute values ({card})")
            out[f"{form} {case} {str(dtype)[6:]}"] = {"us": rec,
                                                       "rel_diff": err}
        del op, ps, W, x, b, q, d
        torch.cuda.empty_cache()
    return out, bad


def walls(swaps, device, card, turns=2, per_turn=3, spread=11):
    """The tuned device-loop IR solve in the PR's routing and the
    parent's (swaps installed while the parent's solver is built and
    timed), over one setup: counts side by side, walls alternated. The
    two sum in other orders, so they are an order witness: compared, and
    both converged. With spread, both routings' rounds, inner its and
    true residuals over `spread` more right-hand sides, F_raw perturbed
    by 1e-6 relative noise: how far one right-hand side's counts stand
    for the schedule."""
    t0 = time.perf_counter()
    p = bench._build_problem(32, with_rhs=True)
    base = tabf.ABFSolver(p["mesh"], p["fes"], p["coeff"], p["bc_idx"],
                          p["bc_vals"], device=device, dtype=F32, nlevels=4,
                          ir=True, loop="plain",
                          **bench.bench_solver_kw(env=False))
    cfg, data, setup = base.cfg, base.data, base.setup
    log(f"[k1_tune] mx=32 float32 4-level setup (tuned schedule) "
        f"{time.perf_counter() - t0:.2f} s")
    F = p["F_raw"] + setup["rhs_diri"]
    kw = dict(device=device, dtype=F32, ir=True)
    slv = {"PR": tabf.ABFSolver.from_parts(cfg, data, setup, **kw)}
    saved = [(mod, n, getattr(mod, n)) for mod, n, _ in swaps]

    def install():
        for mod, n, fn in swaps:
            setattr(mod, n, fn)

    def restore():
        for mod, n, fn in saved:
            setattr(mod, n, fn)

    install()
    try:
        slv["parent"] = tabf.ABFSolver.from_parts(cfg, data, setup, **kw)
        first = {"parent": cs._ir_solve(slv["parent"], F)}
    finally:
        restore()
    first["PR"] = cs._ir_solve(slv["PR"], F)
    a, b = first["PR"], first["parent"]
    devloop = slv["PR"].loop == slv["parent"].loop == "device"
    witness = {"counts_equal": (a["res"]["rounds"], a["res"]["inner_its"])
               == (b["res"]["rounds"], b["res"]["inner_its"]),
               "x_bitwise": bool(np.array_equal(a["res"]["x"],
                                                b["res"]["x"])),
               "x_rel": float(np.linalg.norm(a["res"]["x"] - b["res"]["x"])
                              / np.linalg.norm(b["res"]["x"]))}
    ok = devloop and all(q["res"]["converged"] and not q["res"]["stalled"]
                         for q in first.values())
    log(f"[k1_tune] order witness: rounds / inner its "
        + ("equal" if witness["counts_equal"] else "DIFFER")
        + f", x bitwise {witness['x_bitwise']}, x differs by "
        f"{witness['x_rel']:.3e} norm-relative"
        + ("" if ok else "; a solve did not converge") + f" ({card})")
    fine = ("restrict_parity_residual", "restrict_parity_residual_cheb_first")
    counts = {k: {"rounds": q["res"]["rounds"],
                  "inner_its": q["res"]["inner_its"],
                  "k1_launches": q["launches"], "k1_applies": q["applies"],
                  "k1_factored": q["factored"],
                  "k1_by": q["a00_by"], "k3_by": q["k3"],
                  "k6_launches": q["mg"][1], "k6_by": q["k6_by"],
                  "k4_launches": q["mg"][0],
                  "k5_fine_restrictions": {f: q["k5"][f] for f in fine}}
              for k, q in first.items()}
    for k, q in first.items():
        c = counts[k]
        log(f"[k1_tune] device-loop IR solve, {k} routing: "
            f"{c['rounds']} rounds / {c['inner_its']} inner its, K1 "
            f"{c['k1_launches']} launches in {c['k1_applies']} applies "
            f"({c['k1_factored']} factored; by form {c['k1_by']}), K3 by "
            f"form {c['k3_by']}, K6 "
            f"{c['k6_launches']} launches (by form {c['k6_by']}), K4 "
            f"{c['k4_launches']}, fine restrictions "
            f"{c['k5_fine_restrictions']}, true float64 relative residual "
            f"{q['res']['rnorm'] / q['res']['rnorm0']:.3e}, "
            f"{q['graph_launches']} graph launch")
    rec = {"parent": [], "PR": []}
    for _ in range(turns):
        for k in ("parent", "PR", "PR", "parent"):
            if k == "parent":
                install()
            try:
                w = []
                for _ in range(per_turn):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    slv[k].solve_ir(F, rtol=1e-8)
                    torch.cuda.synchronize()
                    w.append(time.perf_counter() - t)
            finally:
                restore()
            rec[k].append(float(np.median(w)))
    for k, w in rec.items():
        log(f"[k1_tune] device-loop IR solve wall, {k} routing: "
            + ", ".join(f"{x:.4f}" for x in w) + f" s ({card})")
    rng = np.random.default_rng(5)
    Fs = [p["F_raw"] * (1 + 1e-6 * rng.standard_normal(p["F_raw"].shape))
          + setup["rhs_diri"] for _ in range(spread)]
    spreads = {}
    for k in ("parent", "PR") if spread else ():
        if k == "parent":
            install()
        try:
            spreads[k] = [(int(r["rounds"]), int(r["inner_its"]),
                           float(r["rnorm"] / r["rnorm0"]),
                           bool(r["converged"]))
                          for r in (slv[k].solve_ir(Fk, rtol=1e-8)
                                    for Fk in Fs)]
        finally:
            restore()
        ok = ok and all(c for *_, c in spreads[k])
        log(f"[k1_tune] {k} routing over {spread} perturbed right-hand "
            f"sides: rounds / inner its "
            + ", ".join(f"{r}/{i}" for r, i, _, _ in spreads[k])
            + "; true residuals "
            + ", ".join(f"{e:.2e}" for _, _, e, _ in spreads[k])
            + f" ({card})")
    return {"walls_s": rec, "counts": counts, "order_witness": witness,
            "spread": spreads, "ok": ok}, ok


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--routing", choices=("k1", "k3"), default="k1",
                    help="whose fused routing the tuned solve sets against "
                    "the parent's (k3: that solve alone)")
    ap.add_argument("--parent", required=True,
                    help="an earlier source of the routing's kernel "
                    "(a00_apply.cu for k1, mp_apply.cu for k3)")
    ap.add_argument("--variant", action="append", default=[],
                    help="a variant of this version's a00_apply.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_tune: no CUDA device available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = cs.phase_device()
    cs.phase_build()
    if args.routing == "k3":
        with tempfile.TemporaryDirectory() as tmp:
            entries = parent_k3(build_parent_k3(args.parent, tmp))
            times_k3, bad = k3_times(entries, device, card)
            out, ok = walls([(mp, n, fn) for n, fn in entries.items()],
                            device, card)
        log(json.dumps({"card": card, "routing": "k3", "parent": args.parent,
                        "k3_us": times_k3, "solve": out}))
        return 0 if ok and not bad else 1
    out = {"card": card, "parent": args.parent}
    with tempfile.TemporaryDirectory() as tmp:
        pfn = parent_fn(build_parent(args.parent, tmp))
        bad = against_parent(pfn, device)
        out["k1_us"] = times(pfn, device, card)
        if args.variant:
            vlibs = [build_variant(v, tmp, i)
                     for i, v in enumerate(args.variant)]
            out["variants"], more = variants(vlibs, device, card)
            bad += more
        out["solve"], ok = walls([(a00, "_fn", pfn)], device, card)
        if not ok:
            bad.append("device-loop solve")
    log(f"[k1_tune] against {args.parent}: "
        + (f"{len(bad)} checks failed: {bad}" if bad
           else f"every check passed ({card})"))
    log(json.dumps(out))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
