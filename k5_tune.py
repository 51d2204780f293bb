"""K5 (exsaddle_tpu_torch/csrc/transfer.cu) on one CUDA card, beside other
builds of its source.

    python3 k5_tune.py --parent OLD.cu [--variant ALT.cu ...]
    python3 k5_tune.py --grid --parent OLD.cu [--variant ALT.cu ...]

OLD.cu and each ALT.cu are K5 sources with this version's C ABI for the
kernels they have: k5_prolong_parity_f32 / _f64 (xc, xadd, out, shapes,
ndim, nd, stream), k5_restrict_parity_f32 / _f64 (b, y, out, ...),
k5_prolong_grid_f32 / _f64 (xc, xadd, out, nc, ndim, nd, stream),
k5_restrict_grid_f32 / _f64 (x, out, nc, ndim, nd, stream) and, where the
source has them, k5_restrict_parity_weighted_residual_f32 / _f64 (b, y, w,
out, ...) and k5_restrict_grid_cheb_first_f32 / _f64 (x, d, scale, out,
p1, nc, ndim, nd, stream). A source without a fused form runs it as its
unfused kernel with the operations the V-cycle ran around it: w * (b - y)
before the restriction, K6's cheb_first (this checkout's) after it. Each
source is built into a library of its own and installed in place of this
checkout's behind the port's entries (kernels/transfer.py), so every call
below goes through them.

Parity mode (the default), the fine-level pair: on the mx=32 flagship's
fine <-> L-2 parity layout, a cart shard's box of its 1x2x2 grid (32 x 16
x 16 elements), a small 2D and a small odd 3D mesh and a ragged 3D mesh
whose rows no block of rows divides (7 x 5 x 9 elements), in float32 and
float64, every parity form (prolong_parity, its add form, restrict_parity,
its residual and weighted residual forms) of every build byte for byte
this build's, on seeded inputs with signed zeros in b - y; then at the
flagship's and the cart shard's shapes each form's device us per call of
every build.

Grid mode (--grid), the deep levels' pair: on the flagship's L-2 <-> L-3
and L-3 <-> coarse grids, small grids of every (ndim, nd) and ragged grids
whose rows no block of rows divides (fine 9 x 13 x 17, and a 2D 13 x 399
whose rows are longer than a block), in float32 and float64, every grid
form (prolong_grid, its add form, restrict_grid, restrict_grid_cheb_first)
of every build byte for byte this build's, on seeded inputs with signed
zeros (a block of -0 in the fine grid); then each form's device us per call
of every build at the flagship's two shapes; an empty kernel timed the
same way at one block and at each grid-pair launch's shape (the floor of a
kernel node in a graph); then the flagship's V-cycle (mx=32, float32, 4
levels, the bench's tuned schedule: the ABF solver's mg_pc body captured as
one graph per build, graphs.Captured) byte for byte across builds and its
replays alternated; last, over the same setup, an IR solve per build on
the device loop (one graph with conditional nodes: it must instantiate),
bitwise this build's plain driver and host loop, its wall alternated.

The times: 50 calls captured as one CUDA graph and replayed, cold (inputs
cycled through copies that move 3x the 50 MB L2) and hot (one input), as
chip_smoke.py's phase mg_kernels times them; the builds in turn, OLD first
and last (OLD, this, ALT..., ALT..., this, OLD), beside the bound (bytes:
each input read once, each output written once). The last line is one JSON
object with every time. It exits 1 if any output differs or a device-loop
solve fails. Needs a CUDA card and nvcc."""

import argparse
import contextlib
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
from exsaddle_tpu_torch import bench, graphs
from exsaddle_tpu_torch.kernels import _build, cheb, transfer
from exsaddle_tpu_torch.matfree import _parity_classes
from exsaddle_tpu_torch.parallel.cart_abf import _local_cls_shapes

F32, F64 = torch.float32, torch.float64
_V, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# the C symbols (less _f32 / _f64) and their argument types
SYMBOLS = {"prolong_parity": [_V] * 4 + [_I] * 2 + [_V],
           "restrict_parity": [_V] * 4 + [_I] * 2 + [_V],
           "restrict_parity_weighted_residual": [_V] * 5 + [_I] * 2 + [_V],
           "prolong_grid": [_V] * 4 + [_I] * 2 + [_V],
           "restrict_grid": [_V] * 3 + [_I] * 2 + [_V],
           "restrict_grid_cheb_first": [_V] * 2 + [_D] + [_V] * 3
           + [_I] * 2 + [_V]}
# the first-step scale of the fused restriction's checks and times
SCALE = 0.7312345678901234
EMPTY_CU = r"""
#include <cuda_runtime.h>
__global__ void k5_tune_empty_kernel() {}
extern "C" int k5_tune_empty(int gx, int gy, int bx, int by, void* stream) {
  k5_tune_empty_kernel<<<dim3(gx, gy), dim3(bx, by), 0,
                         static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
"""


def log(*a):
    print(*a, flush=True)


def _classes(m_el):
    return tuple(tuple(s) for s in
                 _parity_classes(tuple(2 * m + 1 for m in m_el))[1])


# parity mode: (m_el, class shapes, timed)
CASES = {"fine <-> L-2": ((32, 32, 32), _classes((32, 32, 32)), True),
         "cart shard": ((32, 16, 16), _local_cls_shapes((32, 16, 16), 3),
                        True),
         "2d": ((5, 4), _classes((5, 4)), False),
         "3d_odd": ((3, 4, 2), _classes((3, 4, 2)), False),
         "ragged": ((7, 5, 9), _classes((7, 5, 9)), False)}
# grid mode: (coarse grid, dofs per node, timed)
GRID_CASES = {"L-2 <-> L-3": ((17, 17, 17), 3, True),
              "L-3 <-> coarse": ((9, 9, 9), 3, True),
              "2d_nd2": ((4, 7), 2, False), "2d_nd3": ((5, 3), 3, False),
              "3d_nd2": ((3, 4, 5), 2, False),
              "ragged": ((5, 7, 9), 3, False),
              "ragged_nd2": ((5, 7, 9), 2, False),
              "ragged_2d": ((7, 200), 3, False)}


class Build:
    """A library built from a K5 source (None: this checkout's), installed
    behind the port's entries by installed()."""

    def __init__(self, name, lib=None):
        self.name, self.lib = name, lib
        if lib is None:
            return
        for kind, argtypes in SYMBOLS.items():
            for sfx in ("_f32", "_f64"):
                if self.has(kind):
                    f = getattr(lib, f"k5_{kind}{sfx}")
                    f.argtypes, f.restype = argtypes, ctypes.c_int

    def has(self, kind):
        return self.lib is None or hasattr(self.lib, f"k5_{kind}_f32")

    @contextlib.contextmanager
    def installed(self):
        """The port's K5 entries launch this build's kernels (the forms it
        lacks: its unfused kernel and the V-cycle's ops around it)."""
        if self.lib is None:
            yield
            return
        names = ("_fn", "restrict_parity_weighted_residual",
                 "restrict_grid_cheb_first")
        saved = {k: getattr(transfer, k) for k in names}
        main = _build.load()
        sfx = {F32: "_f32", F64: "_f64"}
        transfer._fn = lambda kind, dtype: (
            main, getattr(self.lib, f"k5_{kind}{sfx[dtype]}"))
        if not self.has("restrict_parity_weighted_residual"):
            transfer.restrict_parity_weighted_residual = (
                lambda b, y, w, cls, m_el:
                transfer.restrict_parity(w * (b - y), cls, m_el))
        if not self.has("restrict_grid_cheb_first"):
            def fused(rf, coarse, d, scale):
                b = transfer.restrict_grid(rf, coarse)
                return b, cheb.cheb_first(b, None, d, torch.zeros_like(b),
                                          scale)
            transfer.restrict_grid_cheb_first = fused
        try:
            yield
        finally:
            for k, v in saved.items():
                setattr(transfer, k, v)


def parity_forms(cls, m_el):
    """{form: fn(*args)} over (xc, x) for the prolongations and (b, y, w)
    for the restrictions, through the port's entries."""
    return {
        "prolong_parity": lambda xc, x: transfer.prolong_parity(
            xc, cls, m_el),
        "prolong_parity_add": lambda xc, x: transfer.prolong_parity(
            xc, cls, m_el, add=x),
        "restrict_parity": lambda b, y, w: transfer.restrict_parity(
            b, cls, m_el),
        "restrict_parity_residual":
            lambda b, y, w: transfer.restrict_parity_residual(
                b, y, cls, m_el),
        "restrict_parity_weighted_residual":
            lambda b, y, w: transfer.restrict_parity_weighted_residual(
                b, y, w, cls, m_el)}


def grid_forms(coarse):
    """{form: (fn(*args), names of its args)} of the grid pair between
    coarse and its fine grid, through the port's entries; args from
    grid_inputs."""
    fine = tuple(2 * c - 1 for c in coarse)
    return {
        "prolong_grid": (lambda xc: transfer.prolong_grid(xc, fine),
                         ("xc",)),
        "prolong_grid_add": (
            lambda xc, x: transfer.prolong_grid(xc, fine, add=x),
            ("xc", "x")),
        "restrict_grid": (lambda xf: transfer.restrict_grid(xf, coarse),
                          ("xf",)),
        "restrict_grid_cheb_first": (
            lambda xf, d: transfer.restrict_grid_cheb_first(xf, coarse, d,
                                                            SCALE),
            ("xf", "d"))}


def build_libs(sources, out_dir):
    """{source: ctypes library}, one nvcc per source, all started together;
    prints ptxas's registers and spills of each K5 kernel."""
    jobs = {}
    for i, src in enumerate(sources):
        out = os.path.join(out_dir, f"libk5_{i}.so")
        cmd = [_build._nvcc()] + _build.NVCC_FLAGS + ["-shared", "-o", out,
                                                      src]
        jobs[src] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    for src, (out, proc) in jobs.items():
        text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{text}")
        lines = text.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and ("parity" in line
                                                       or "grid" in line):
                usage = next((q for q in lines[i + 1:i + 4]
                              if "registers" in q), "")
                log(f"[k5_tune] {os.path.basename(src)}: "
                    f"{line.split()[-3][:90]} {usage.strip()}")
        libs[src] = ctypes.CDLL(out)
    return libs


def parity_inputs(cls, m_el, dtype, device, seed=21):
    """(xc, x) and (b, y, w) of one parity layout: standard normals, signed
    zeros in b - y (+0 and -0), ownership weights 1/2^k."""
    nd = len(m_el)
    cshape, n, _ = transfer.parity_layout(cls, m_el, nd)
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)
    xc = t(rng.standard_normal(cshape + (nd,)))
    x, b, y = (t(rng.standard_normal(n)) for _ in range(3))
    b[::7] = y[::7]
    b[::11], y[::11] = 0.0, 0.0
    b[::13], y[::13] = -0.0, 0.0
    w = t(0.5 ** rng.integers(0, 4, n))
    return (xc, x), (b, y, w), n, int(np.prod(cshape)) * nd


def grid_inputs(coarse, nd, dtype, device, seed=22):
    """{xc, x, xf, d} of one grid pair: standard normals, a block of -0
    and scattered zeros in the fine grid xf (so some restricted values are
    -0), -0 in xc, a positive inverse diagonal d of the coarse grid."""
    fine = tuple(2 * c - 1 for c in coarse)
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)
    xc = t(rng.standard_normal(coarse + (nd,)))
    x, xf = (t(rng.standard_normal(fine + (nd,))) for _ in range(2))
    xf[: (fine[0] + 1) // 2] = -0.0
    xf.view(-1)[::7] = 0.0
    xc.view(-1)[::3] = -0.0
    d = t(0.5 + rng.random(coarse + (nd,)))
    return {"xc": xc, "x": x, "xf": xf, "d": d}


def _same(a, b):
    a, b = cs._outputs(a), cs._outputs(b)
    return len(a) == len(b) and all(cs._same_bits(p, q)
                                    for p, q in zip(a, b))


def check(builds, device, grid):
    """Every build's outputs against this build's (builds[0]), byte for
    byte."""
    bad = []
    for case, spec in (GRID_CASES if grid else CASES).items():
        for dtype in (F32, F64):
            if grid:
                coarse, nd, _ = spec
                args = grid_inputs(coarse, nd, dtype, device)
                calls = {f: (lambda fn=fn, a=a: fn(*[args[k] for k in a]))
                         for f, (fn, a) in grid_forms(coarse).items()}
                what = f"{coarse} nodes x {nd}"
            else:
                m_el, cls, _ = spec
                pro, res, _, _ = parity_inputs(cls, m_el, dtype, device)
                calls = {f: (lambda fn=fn, f=f: fn(
                    *(pro if f.startswith("prolong") else res)))
                    for f, fn in parity_forms(cls, m_el).items()}
                what = str(m_el)
            outs = {}
            for bld in builds:
                with bld.installed():
                    outs[bld.name] = {f: c() for f, c in calls.items()}
            torch.cuda.synchronize()
            want = outs[builds[0].name]
            for bld in builds[1:]:
                diff = [f for f in calls
                        if not _same(outs[bld.name][f], want[f])]
                bad += [(case, str(dtype)[6:], bld.name, f) for f in diff]
                log(f"[k5_tune] {case} {what} {str(dtype)[6:]}: {bld.name} "
                    + ("byte for byte this build, every form" if not diff
                       else f"DIFFERS in {diff}"))
    return bad


def _order(builds):
    """The builds in turn, OLD first and last: OLD, this, ALT...,
    ALT... reversed, this, OLD."""
    return builds[1:2] + builds[:1] + builds[2:] + builds[2:][::-1] \
        + builds[:1] + builds[1:2]


def _time_form(rec, order, call, args, nbytes):
    """Cold and hot us per call of call(*args) under each build of order,
    into rec."""
    copies = cs._cold_copies(args, nbytes)
    reps = -(-cs.MG_REPS // len(copies))
    for bld in order:
        with bld.installed():
            hot = cs._graph_ms([lambda: call(*args)] * cs.MG_REPS)
            cold = cs._graph_ms([lambda c=c: call(*c) for c in copies]
                                * reps)
        rec["cold_us"].setdefault(bld.name, []).append(1e3 * cold)
        rec["hot_us"].setdefault(bld.name, []).append(1e3 * hot)


def _log_times(rec, head, nbytes, card):
    log(f"[k5_tune] {head}: " + "; ".join(
        f"{name} " + ", ".join(
            f"{c:.2f} / {h:.2f}" for c, h in zip(rec["cold_us"][name],
                                                 rec["hot_us"][name]))
        for name in rec["cold_us"])
        + f" us cold / hot; bound {rec['bound_us']:.3f} us "
        f"({nbytes / 1e6:.3f} MB) ({card})")


def times(builds, device, card):
    """Parity mode: cold and hot us per call of every parity form of every
    build, in turn."""
    out = []
    for case, (m_el, cls, timed) in CASES.items():
        if not timed:
            continue
        for dtype in (F32, F64):
            size = torch.empty((), dtype=dtype).element_size()
            pro, res, n, nc = parity_inputs(cls, m_el, dtype, device)
            nval = {"prolong_parity": n + nc, "prolong_parity_add": 2 * n + nc,
                    "restrict_parity": n + nc,
                    "restrict_parity_residual": 2 * n + nc,
                    "restrict_parity_weighted_residual": 3 * n + nc}
            for form, fn in parity_forms(cls, m_el).items():
                args = pro if form.startswith("prolong") else res
                nbytes = size * nval[form]
                rec = {"case": case, "dtype": str(dtype)[6:], "form": form,
                       "bound_us": 1e6 * nbytes / cs.PEAK_BYTES,
                       "cold_us": {}, "hot_us": {}}
                _time_form(rec, _order(builds), fn, args, nbytes)
                _log_times(rec, f"{case} {str(dtype)[6:]} {form}", nbytes,
                           card)
                out.append(rec)
    return out


def row_launch(length, ny, nz):
    """transfer.cu's row_launch: (grid x, grid y, block x, block y)."""
    tx = min(length, 320)
    rows = min(320 // tx, ny)
    return (-(-ny // rows), nz, tx, rows)


def grid_times(builds, device, card, empty):
    """Grid mode: cold and hot us per call of every grid form of every
    build at the flagship's two shapes, in turn; the empty kernel at one
    block and at each form's launch shape, timed the same way."""
    out, floor = [], {}

    def empty_us(shape):
        def call():
            err = empty(*shape, _V(torch.cuda.current_stream().cuda_stream))
            if err:
                raise RuntimeError(f"empty kernel launch failed ({err})")
        return 1e3 * cs._graph_ms([call] * cs.MG_REPS)

    floor["1 x 32 threads"] = empty_us((1, 1, 32, 1))
    for case, (coarse, nd, timed) in GRID_CASES.items():
        if not timed:
            continue
        fine = tuple(2 * c - 1 for c in coarse)
        ncv, nfv = int(np.prod(coarse)) * nd, int(np.prod(fine)) * nd
        shapes = {"prolong": row_launch(fine[-1] * nd, fine[-2], fine[0]),
                  "restrict": row_launch(coarse[-1] * nd, coarse[-2],
                                         coarse[0])}
        for kind, shape in shapes.items():
            floor[f"{case} {kind} {shape[0]}x{shape[1]} blocks of "
                  f"{shape[2]}x{shape[3]}"] = empty_us(shape)
        for dtype in (F32, F64):
            size = torch.empty((), dtype=dtype).element_size()
            inp = grid_inputs(coarse, nd, dtype, device)
            nval = {"prolong_grid": ncv + nfv, "prolong_grid_add": ncv
                    + 2 * nfv, "restrict_grid": nfv + ncv,
                    "restrict_grid_cheb_first": nfv + 3 * ncv}
            for form, (fn, names) in grid_forms(coarse).items():
                args = tuple(inp[k] for k in names)
                nbytes = size * nval[form]
                rec = {"case": case, "dtype": str(dtype)[6:], "form": form,
                       "bound_us": 1e6 * nbytes / cs.PEAK_BYTES,
                       "cold_us": {}, "hot_us": {}}
                _time_form(rec, _order(builds), fn, args, nbytes)
                _log_times(rec, f"{case} {str(dtype)[6:]} {form}", nbytes,
                           card)
                out.append(rec)
    for what, us in floor.items():
        log(f"[k5_tune] empty kernel, {what}: {us:.2f} us per launch in a "
            f"graph of {cs.MG_REPS} ({card})")
    return out, floor


def vcycle(builds, device, card, rounds=4, replays=100):
    """The flagship's V-cycle (mx=32, float32, 4 levels, the tuned
    schedule) captured once per build: outputs byte for byte across
    builds; device us per replay (CUDA events around `replays` replays,
    median over `rounds` turns of _order). Then an IR solve per build over
    the same setup on the device loop, against this build's plain driver
    and host loop bit for bit, walls alternated (median of 3 per turn).
    Returns (record, failures)."""
    t0 = time.perf_counter()
    p = bench._build_problem(32, with_rhs=True)
    base = tabf.ABFSolver(p["mesh"], p["fes"], p["coeff"], p["bc_idx"],
                          p["bc_vals"], device=device, dtype=F32, nlevels=4,
                          ir=True, loop="plain",
                          **bench.bench_solver_kw(env=False))
    cfg, data, setup = base.cfg, base.data, base.setup
    log(f"[k5_tune] mx=32 float32 4-level setup (tuned schedule) "
        f"{time.perf_counter() - t0:.2f} s")
    mg_pc = tabf._plain_bodies(cfg, data)["mg_pc"]
    r = torch.as_tensor(np.random.default_rng(31).standard_normal(
        data["op"].nu), dtype=F32, device=device)
    bad, rec = [], {"vcycle_us": {}, "solve_s": {}, "device_loop": {}}
    caps = {}
    for bld in builds:
        with bld.installed():
            caps[bld.name] = graphs.Captured(mg_pc, r)
    outs = {name: g(r) for name, g in caps.items()}
    torch.cuda.synchronize()
    for bld in builds[1:]:
        same = cs._same_bits(outs[bld.name], outs[builds[0].name])
        if not same:
            bad.append(("vcycle", bld.name))
        log(f"[k5_tune] V-cycle: {bld.name} "
            + ("byte for byte this build" if same else "DIFFERS"))
    for _ in range(rounds):
        for bld in _order(builds):
            g = caps[bld.name].graph
            g.replay()
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(replays):
                g.replay()
            e1.record()
            e1.synchronize()
            rec["vcycle_us"].setdefault(bld.name, []).append(
                1e3 * e0.elapsed_time(e1) / replays)
    for name, us in rec["vcycle_us"].items():
        log(f"[k5_tune] V-cycle replay, {name}: median "
            f"{np.median(us):.2f} us ({', '.join(f'{u:.2f}' for u in us)}) "
            f"({card})")
    del caps, outs
    # the device loop per build: it must instantiate and give the bits of
    # this build's plain driver and host loop
    F = p["F_raw"] + setup["rhs_diri"]
    kw = dict(device=device, dtype=F32, ir=True)
    ref = {}
    for loop in ("plain", "host"):
        ref[loop] = tabf.ABFSolver.from_parts(cfg, data, setup, loop=loop,
                                              **kw).solve_ir(F, rtol=1e-8)
    solvers = {}
    for bld in builds:
        with bld.installed():
            try:
                slv = tabf.ABFSolver.from_parts(cfg, data, setup, **kw)
                res = slv.solve_ir(F, rtol=1e-8)
            except RuntimeError as e:
                bad.append(("device loop", bld.name))
                rec["device_loop"][bld.name] = f"failed: {e}"
                log(f"[k5_tune] device loop, {bld.name}: FAILED: {e}")
                continue
        same = all(cs._same_ir(res, ref[k]) for k in ref)
        if not same:
            bad.append(("device loop", bld.name))
        rec["device_loop"][bld.name] = (
            f"{res['rounds']} rounds / {res['inner_its']} inner its, "
            + ("bitwise" if same else "NOT bitwise")
            + " the plain driver and the host loop")
        log(f"[k5_tune] device loop, {bld.name}: "
            f"{rec['device_loop'][bld.name]}")
        solvers[bld.name] = slv
    for bld in _order(builds):
        slv = solvers.get(bld.name)
        if slv is None:
            continue
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            slv.solve_ir(F, rtol=1e-8)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        rec["solve_s"].setdefault(bld.name, []).append(
            float(np.median(walls)))
    for name, s in rec["solve_s"].items():
        log(f"[k5_tune] device-loop IR solve wall, {name}: "
            + ", ".join(f"{x:.4f}" for x in s) + f" s ({card})")
    return rec, bad


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="an earlier K5 source")
    ap.add_argument("--variant", action="append", default=[],
                    help="another K5 source")
    ap.add_argument("--grid", action="store_true",
                    help="the grid pair, its floor and the V-cycle, not "
                         "the parity pair")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k5_tune: no CUDA device available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = cs.phase_device()
    cs.phase_build()
    out = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        sources = [args.parent] + args.variant
        names = ["parent"] + [f"variant {i}" for i in range(len(args.variant))]
        empty_src = os.path.join(tmp, "empty.cu")
        with open(empty_src, "w") as fh:
            fh.write(EMPTY_CU)
        libs = build_libs(sources + [empty_src], tmp)
        builds = [Build("this")] + [Build(n, libs[s])
                                    for n, s in zip(names, sources)]
        out["builds"] = dict(zip(names, sources))
        bad = check(builds, device, args.grid)
        if args.grid:
            empty = libs[empty_src].k5_tune_empty
            empty.argtypes, empty.restype = [_I] * 4 + [_V], ctypes.c_int
            out["k5_tune"], out["empty_us"] = grid_times(builds, device,
                                                         card, empty)
            out["vcycle"], more = vcycle(builds, device, card)
            bad += more
        else:
            out["k5_tune"] = times(builds, device, card)
    log(f"[k5_tune] against {', '.join(sources)}: "
        + (f"{len(bad)} outputs differ or failed: {bad}" if bad
           else f"every output byte for byte ({card})"))
    log(json.dumps(out))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
