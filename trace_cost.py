"""The tracer's cost on one CUDA card: a benchmark cell's solver solved
untraced and traced (exsaddle_tpu_torch.trace.Trace) over one set-up, the
same loads, alternated.

    python3 trace_cost.py --workload pseudoice_mx32.rhs_stream \
        --seed 3141592653 [--loads 12]

The cell's configuration, traffic and loads are the benchmark's
(benchmark/harness.py). One ABFSolver is built as the benchmark builds it
(untraced), a second over its set-up with a trace (ABFSolver.from_parts);
after a warm-up solve of each, each load is solved by both, the order
alternated per load (untraced first on even loads). Each solve is timed on
the host clock around the call (which returns the solution on the host).
Printed: the two walls per solve (mean, median, per load), their
difference in ms and in %, the marks per solve, the calibration's error
and its drift over the pass, %globaltimer's step, and the bits of every
pair (x, counts and histories must agree). The last line is one JSON
object with every number; it exits 1 if a pair differs."""

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--loads", type=int, default=12)
    args = ap.parse_args(argv)
    from benchmark import harness
    from benchmark import loads as bloads
    from exsaddle_tpu_torch.abf import ABFSolver
    from exsaddle_tpu_torch.trace import Trace
    device = torch.device("cuda", 0)
    _, _, _, config, traffic = harness.cell_files(harness.ROOT, args.workload)
    traffic = dict(traffic, loads=args.loads)
    precision = traffic["precision"]
    harness.load_kernels(device)
    problem = harness.reference_problem(config)
    loads = bloads.make_loads(traffic, args.seed, problem,
                              harness.saddle(problem, device))
    harness.free(device)
    sysprob = harness.system_problem(config)
    slv, build_s = harness.build_solver(config, sysprob, device, precision)
    loads = [F + np.asarray(slv.setup["rhs_diri"]) for F in loads]
    tr = Trace(device)
    t0 = time.perf_counter()
    tslv = ABFSolver.from_parts(slv.cfg, slv.data, slv.setup, device=device,
                                dtype=slv.dtype, ir=precision == "mixed",
                                trace=tr)
    traced_build_s = time.perf_counter() - t0
    rtol = float(config["guarantee"]["requested_rtol"])

    def solve(s, F):
        t = time.perf_counter()
        r = s.solve_ir(F, rtol=rtol) if precision == "mixed" else s.solve(F)
        return time.perf_counter() - t, r

    solve(slv, loads[0])
    solve(tslv, loads[0])
    first = tr.solve + 1
    walls = {"untraced": [], "traced": []}
    same = True
    for k, F in enumerate(loads):
        order = (("untraced", slv), ("traced", tslv))
        got = {}
        for name, s in (order if k % 2 == 0 else order[::-1]):
            w, got[name] = solve(s, F)
            walls[name].append(w)
        a, b = got["untraced"], got["traced"]
        same &= (np.array_equal(a["x"], b["x"]) and a["counts"] == b["counts"]
                 and a["history"] == b["history"])
    col = tr.collect()
    mine = [s for s in col["spans"] if s.device and s.solve is not None
            and s.solve >= first]
    cals = col["calibration"]
    out = {"workload": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name(device), "loads": len(loads),
           "build_s": build_s, "traced_build_s": traced_build_s,
           "walls": walls, "bitwise": bool(same),
           "marks_per_solve": 2 * len(mine) / len(loads),
           "drops": col["drops"], "calibration": cals,
           "drift_ns": cals[1]["offset_ns"] - cals[0]["offset_ns"],
           "timer_step": col["timer_step"]}
    for name, ws in walls.items():
        out[name + "_mean_s"] = statistics.fmean(ws)
        out[name + "_median_s"] = statistics.median(ws)
    d = [b - a for a, b in zip(walls["untraced"], walls["traced"])]
    out["added_ms_mean"] = 1e3 * statistics.fmean(d)
    out["added_ms_median"] = 1e3 * statistics.median(d)
    out["added_pct"] = 100 * statistics.fmean(d) / out["untraced_mean_s"]
    print(f"untraced {out['untraced_mean_s']:.5f} s, traced "
          f"{out['traced_mean_s']:.5f} s per solve (means over "
          f"{len(loads)} loads): +{out['added_ms_mean']:.3f} ms "
          f"({out['added_pct']:.3f}%), median of pairs "
          f"+{out['added_ms_median']:.3f} ms; {out['marks_per_solve']:.1f} "
          f"marks per solve, {col['drops']} dropped; calibration error "
          f"{[c['error_ns'] for c in cals]} ns, drift {out['drift_ns']} ns; "
          f"%globaltimer step {col['timer_step']}; bitwise {same}",
          file=sys.stderr)
    print(json.dumps(out))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
