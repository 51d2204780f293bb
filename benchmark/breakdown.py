"""The traced run's breakdown: one solve of the cell's own first load on the
host-loop path (ABFSolver loop="host": the device loop's bodies captured
as graphs without conditional nodes, bitwise the device loop's solve on
CUDA), under torch.profiler. CUPTI does not see inside the device loop's
conditional graph bodies, so that path's kernels cannot be listed; this
one's can. Returns the device operations that took most time and the
longest idle gaps of the device, each named by what the host was doing."""

import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver", "cpu_op")
TOP = 10
PATH = "[loop=host] "


def _events(path):
    with open(path) as fh:
        data = json.load(fh)
    ev = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in ev if e.get("ph") == "X" and "dur" in e]


def summarise(events):
    """({"device_ops", "idle_gaps"}, device busy seconds, traced span
    seconds) of chrome-trace events (times in us)."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("cat") in HOST_CATS]
    if not dev:
        return None, 0.0, 0.0
    by_name = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in dev)
    merged = [list(spans[0])]
    for a, b in spans[1:]:
        if a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    gaps = sorted(((merged[i][1], merged[i + 1][0])
                   for i in range(len(merged) - 1)),
                  key=lambda g: g[0] - g[1])[:TOP]
    named = []
    for a, b in gaps:
        best, best_key = "nothing traced", None
        for e in host:
            lo = max(a, float(e["ts"]))
            hi = min(b, float(e["ts"]) + float(e["dur"]))
            if hi > lo:
                key = (hi - lo, -float(e["dur"]))
                if best_key is None or key > best_key:
                    best, best_key = e["name"], key
        named.append([PATH + "host in " + best[:120], 1e-6 * (b - a)])
    out = {"device_ops": [[PATH + n[:150], 1e-6 * us] for n, us in ops],
           "idle_gaps": named}
    return out, 1e-6 * busy, 1e-6 * (merged[-1][1] - merged[0][0])


def breakdown(run):
    """The breakdown of one profiled host-loop solve of run.loads[0], or
    None where the profiler saw no device operation."""
    from torch.profiler import ProfilerActivity, profile
    from exsaddle_tpu_torch.abf import ABFSolver
    from benchmark import harness
    slv = run.solver
    precision = run.traffic["precision"]
    host = ABFSolver.from_parts(slv.cfg, slv.data, slv.setup,
                                device=run.device, dtype=slv.dtype,
                                ir=precision == "mixed", loop="host")
    entry = harness.Entry(host, run.config, precision)
    F = run.loads[0]
    entry(F)                                              # warm-up
    harness.sync(run.device)
    acts = [ProfilerActivity.CPU]
    if run.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            _, its, _ = entry(F)
            harness.sync(run.device)
        wall = time.perf_counter() - t0
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        out, busy, span = summarise(_events(path))
    run.log(f"breakdown: one host-loop solve of load 0, {its} FGMRES its, "
            f"{wall:.3f} s profiled wall, device busy {busy:.4f} s over a "
            f"traced span of {span:.4f} s")
    del host, entry
    return out
