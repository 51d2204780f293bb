"""K5's fine-level parity pair (exsaddle_tpu_torch/csrc/transfer.cu) on one
CUDA card, beside other builds of its source.

    python3 k5_tune.py --parent OLD.cu
    python3 k5_tune.py --parent OLD.cu --variant ALT.cu [--variant ...]

OLD.cu is an earlier K5 source with the first version's C ABI
(k5_prolong_parity_f32 / _f64 (xc, xadd, out, shapes, ndim, nd, stream),
k5_restrict_parity_f32 / _f64 (b, y, out, ...)); each ALT.cu a K5 source
with this version's ABI (the same, and k5_restrict_parity_weighted_residual
_f32 / _f64 (b, y, w, out, ...)). Each is built into a library of its own.

The check: on the mx=32 flagship's fine <-> L-2 parity layout, a cart
shard's box of its 1x2x2 grid (32 x 16 x 16 elements), a small 2D and a
small odd 3D mesh and a ragged 3D mesh whose rows no block of rows divides
(7 x 5 x 9 elements), in float32 and float64, every parity form of this
build (prolong_parity, its add form, restrict_parity, its residual and
weighted residual forms) byte for byte OLD's (OLD's restrict_parity of
b - y and of w * (b - y) for the fused restrictions) and each ALT's, on
seeded inputs with signed zeros in b - y. It exits 1 if any output
differs.

The times: at the flagship's and the cart shard's shapes, each form of
every build, device us per call, 50 calls captured as one CUDA graph and
replayed, cold (inputs cycled through copies that move 3x the 50 MB L2)
and hot (one input), as chip_smoke.py's phase mg_kernels times them; the
builds in turn, OLD first and last (OLD, this, ALT..., ALT..., this, OLD),
beside the bound (bytes: each input read once, the output written once).
The last line is one JSON object with every time. Needs a CUDA card and
nvcc."""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

import chip_smoke as cs
from exsaddle_tpu_torch.kernels import _build, transfer
from exsaddle_tpu_torch.matfree import _parity_classes
from exsaddle_tpu_torch.parallel.cart_abf import _local_cls_shapes

F32, F64 = torch.float32, torch.float64
_V = ctypes.c_void_p
FORMS = ("prolong_parity", "prolong_parity_add", "restrict_parity",
         "restrict_parity_residual", "restrict_parity_weighted_residual")


def log(*a):
    print(*a, flush=True)


def _classes(m_el):
    return tuple(tuple(s) for s in
                 _parity_classes(tuple(2 * m + 1 for m in m_el))[1])


# (m_el, class shapes, timed)
CASES = {"fine <-> L-2": ((32, 32, 32), _classes((32, 32, 32)), True),
         "cart shard": ((32, 16, 16), _local_cls_shapes((32, 16, 16), 3),
                        True),
         "2d": ((5, 4), _classes((5, 4)), False),
         "3d_odd": ((3, 4, 2), _classes((3, 4, 2)), False),
         "ragged": ((7, 5, 9), _classes((7, 5, 9)), False)}


class Build:
    """The parity entries of one library built from a K5 source: each call
    launches on the current stream into a new output, as the port's
    wrapper does (no checks: the inputs are the port's)."""

    def __init__(self, name, lib, weighted):
        self.name, self.lib, self.weighted = name, lib, weighted
        for kind in ("prolong_parity", "restrict_parity"):
            for sfx in ("_f32", "_f64"):
                f = getattr(lib, f"k5_{kind}{sfx}")
                f.argtypes = [_V] * 4 + [ctypes.c_int] * 2 + [_V]
                f.restype = ctypes.c_int
                if weighted and kind == "restrict_parity":
                    f = getattr(lib, f"k5_{kind}_weighted_residual{sfx}")
                    f.argtypes = [_V] * 5 + [ctypes.c_int] * 2 + [_V]
                    f.restype = ctypes.c_int

    def _call(self, fn, x, shape, ptrs, cls, m_el):
        nd = len(m_el)
        _, _, table = transfer.parity_layout(cls, m_el, nd)
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
        f = getattr(self.lib, fn + ("_f32" if x.dtype == F32 else "_f64"))
        err = f(*[_V(0) if p is None else _V(p.data_ptr()) for p in ptrs],
                _V(out.data_ptr()), (ctypes.c_int * len(table))(*table),
                nd, nd, _V(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"{self.name} {fn} launch failed ({err})")
        return out

    def forms(self, cls, m_el):
        """{form: fn(*args)} over (xc, x) for the prolongations and
        (b, y, w) for the restrictions."""
        nd = len(m_el)
        cshape, n, _ = transfer.parity_layout(cls, m_el, nd)
        cs_ = cshape + (nd,)

        def pro(xc, x=None):
            return self._call("k5_prolong_parity", xc, (n,), [xc, x], cls,
                              m_el)

        def res(b, y=None, w=None):
            if w is None:
                return self._call("k5_restrict_parity", b, cs_, [b, y], cls,
                                  m_el)
            if self.weighted:
                return self._call("k5_restrict_parity_weighted_residual", b,
                                  cs_, [b, y, w], cls, m_el)
            return self._call("k5_restrict_parity", b, cs_,
                              [w * (b - y), None], cls, m_el)
        return {"prolong_parity": lambda xc, x: pro(xc),
                "prolong_parity_add": pro,
                "restrict_parity": lambda b, y, w: res(b),
                "restrict_parity_residual": lambda b, y, w: res(b, y),
                "restrict_parity_weighted_residual": res}


class Current(Build):
    """This checkout's build, through the port's entries."""

    def __init__(self):
        self.name, self.weighted = "this", True

    def forms(self, cls, m_el):
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


def build_libs(sources, out_dir):
    """{source: ctypes library}, one nvcc per source, all started together;
    prints ptxas's registers and spills of each parity kernel."""
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
            if "Compiling entry function" in line and "parity" in line:
                usage = next((q for q in lines[i + 1:i + 4]
                              if "registers" in q), "")
                log(f"[k5_tune] {src}: {line.split()[-1][:90]} "
                    f"{usage.strip()}")
        libs[src] = ctypes.CDLL(out)
    return libs


def inputs(cls, m_el, dtype, device, seed=21):
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


def _args(form, pro, res):
    return pro if form.startswith("prolong") else res


def check(builds, device):
    """Every build's outputs against this build's, byte for byte."""
    bad = []
    for case, (m_el, cls, _) in CASES.items():
        for dtype in (F32, F64):
            pro, res, _, _ = inputs(cls, m_el, dtype, device)
            want = {f: fn(*_args(f, pro, res))
                    for f, fn in builds[0].forms(cls, m_el).items()}
            for bld in builds[1:]:
                got = {f: fn(*_args(f, pro, res))
                       for f, fn in bld.forms(cls, m_el).items()}
                diff = [f for f in FORMS
                        if not cs._same_bits(got[f], want[f])]
                bad += [(case, str(dtype)[6:], bld.name, f) for f in diff]
                log(f"[k5_tune] {case} {m_el} {str(dtype)[6:]}: {bld.name} "
                    + ("byte for byte this build, every form" if not diff
                       else f"DIFFERS in {diff}"))
    return bad


def times(builds, device, card):
    """Cold and hot us per call of every form of every build, the builds
    in turn (each timed twice, first and last order reversed)."""
    order = builds[1:2] + builds[:1] + builds[2:] + builds[2:][::-1] \
        + builds[:1] + builds[1:2]
    out = []
    for case, (m_el, cls, timed) in CASES.items():
        if not timed:
            continue
        for dtype in (F32, F64):
            size = torch.empty((), dtype=dtype).element_size()
            pro, res, n, nc = inputs(cls, m_el, dtype, device)
            nval = {"prolong_parity": n + nc, "prolong_parity_add": 2 * n + nc,
                    "restrict_parity": n + nc,
                    "restrict_parity_residual": 2 * n + nc,
                    "restrict_parity_weighted_residual": 3 * n + nc}
            for form in FORMS:
                args = _args(form, pro, res)
                nbytes = size * nval[form]
                copies = cs._cold_copies(args, nbytes)
                reps = -(-cs.MG_REPS // len(copies))
                bound = nbytes / cs.PEAK_BYTES * 1e3
                rec = {"case": case, "dtype": str(dtype)[6:], "form": form,
                       "bound_us": 1e3 * bound, "cold_us": {}, "hot_us": {}}
                for bld in order:
                    fn = bld.forms(cls, m_el)[form]
                    hot = cs._graph_ms([lambda: fn(*args)] * cs.MG_REPS)
                    cold = cs._graph_ms([lambda c=c: fn(*c) for c in copies]
                                        * reps)
                    rec["cold_us"].setdefault(bld.name, []).append(1e3 * cold)
                    rec["hot_us"].setdefault(bld.name, []).append(1e3 * hot)
                del copies
                log(f"[k5_tune] {case} {str(dtype)[6:]} {form}: "
                    + "; ".join(
                        f"{name} " + ", ".join(
                            f"{c:.2f} / {h:.2f}" for c, h in zip(
                                rec["cold_us"][name], rec["hot_us"][name]))
                        for name in rec["cold_us"])
                    + f" us cold / hot; bound {rec['bound_us']:.2f} us "
                    f"({nbytes / 1e6:.2f} MB) ({card})")
                out.append(rec)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="an earlier K5 source (the first version's ABI)")
    ap.add_argument("--variant", action="append", default=[],
                    help="a K5 source with this version's ABI")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k5_tune: no CUDA device available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = cs.phase_device()
    cs.phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_libs([args.parent] + args.variant, tmp)
        builds = [Current(), Build("parent", libs[args.parent], False)] + [
            Build(f"variant {i}", libs[src], True)
            for i, src in enumerate(args.variant)]
        bad = check(builds, device)
        recs = times(builds, device, card)
    log(f"[k5_tune] against {args.parent}"
        + "".join(f", {s}" for s in args.variant) + ": "
        + (f"{len(bad)} outputs differ: {bad}" if bad
           else f"every output byte for byte ({card})"))
    log(json.dumps({"k5_tune": recs, "builds": {
        b.name: s for b, s in zip(builds[1:], [args.parent]
                                   + args.variant)}, "card": card}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
