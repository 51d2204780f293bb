"""The traced run's breakdown: one solve of the cell's own first load on the
host-loop path (ABFSolver loop="host": the device loop's bodies captured
as graphs without conditional nodes, bitwise the device loop's solve on
CUDA), under torch.profiler. CUPTI does not see inside the device loop's
conditional graph bodies, so that path's kernels cannot be listed; this
one's can. Returns the device operations that took most time and the
longest idle gaps of the device, each named by what the host was doing.

A sharded solver (a configuration that states "shards") is profiled
itself, with no single-device twin: one solve of its first load on its
host loop (the run's own solver where its loop is the host's, else its
placed data with the host loop, CartABFSolver.with_loop), in which CUPTI
sees every card's kernels. Its device operations and idle gaps are named
with their card, and cards_profile keeps each card's busy time within the
solve for the traced line and metrics/cards_idle_pct."""

import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver", "cpu_op")
TOP = 10
PATH = "[loop=host] "
CART = "[cart {}] "
SOLVE = "benchmark.solve"


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
    merged = _merge(dev)
    busy = sum(b - a for a, b in merged)
    gaps = sorted(((merged[i][1], merged[i + 1][0])
                   for i in range(len(merged) - 1)),
                  key=lambda g: g[0] - g[1])[:TOP]
    named = [[PATH + "host in " + _host_in(a, b, host)[:120], 1e-6 * (b - a)]
             for a, b in gaps]
    out = {"device_ops": [[PATH + n[:150], 1e-6 * us] for n, us in ops],
           "idle_gaps": named}
    return out, 1e-6 * busy, 1e-6 * (merged[-1][1] - merged[0][0])


def _merge(events, lo=None, hi=None):
    """The union of the events' [ts, ts + dur] as sorted disjoint [a, b],
    clipped to [lo, hi] where given."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events)
    if lo is not None:
        spans = [(max(a, lo), min(b, hi)) for a, b in spans
                 if min(b, hi) > max(a, lo)]
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _host_in(a, b, host):
    """The name of the host event that overlaps [a, b] most (the shorter
    one on a tie), or "nothing traced"."""
    best, best_key = "nothing traced", None
    for e in host:
        lo = max(a, float(e["ts"]))
        hi = min(b, float(e["ts"]) + float(e["dur"]))
        if hi > lo:
            key = (hi - lo, -float(e["dur"]))
            if best_key is None or key > best_key:
                best, best_key = e["name"], key
    return best


def card_of(e):
    """The CUDA ordinal of a device event (its "device" argument, else the
    trace's pid, which is the ordinal for device events)."""
    return int((e.get("args") or {}).get("device", e.get("pid")))


def cards_summary(events, cards):
    """What one profiled solve of a sharded solver reads: the solve's wall
    (the SOLVE annotation), each card's busy seconds within it (its kernels
    and copies merged), the device operations and idle gaps named with
    their card; None where no device operation or no SOLVE annotation was
    traced. cards: the CUDA ordinals the solver holds data on (a card with
    no operation in the solve is idle for all of it)."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("cat") in HOST_CATS]
    # the host's annotation (its device-side twin spans only the kernels)
    solve = [e for e in events if e.get("name") == SOLVE
             and e.get("cat") != "gpu_user_annotation"]
    if not dev or not solve:
        return None
    a0 = float(solve[0]["ts"])
    a1 = a0 + float(solve[0]["dur"])
    by_name, busy, gaps = {}, {}, []
    for k in cards:
        mine = [e for e in dev if card_of(e) == k]
        for e in mine:
            key = (k, e["name"])
            by_name[key] = by_name.get(key, 0.0) + float(e["dur"])
        merged = _merge(mine, a0, a1)
        busy[k] = 1e-6 * sum(b - a for a, b in merged)
        edges = [a0] + [x for ab in merged for x in ab] + [a1]
        gaps += [(k, edges[i], edges[i + 1])
                 for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(gaps, key=lambda g: g[1] - g[2])[:TOP]
    tag = lambda k: CART.format(f"cuda:{k}")
    return {"device_ops": [[tag(k) + n[:150], 1e-6 * us]
                           for (k, n), us in ops],
            "idle_gaps": [[tag(k) + "host in " + _host_in(a, b, host)[:120],
                           1e-6 * (b - a)] for k, a, b in gaps],
            "wall_s": 1e-6 * (a1 - a0), "busy_by_card": busy,
            "busy_s": sum(busy.values()) / len(busy)}


def cards_profile(run):
    """One profiled solve of run.loads[0] by the run's sharded solver on
    its host loop (cards_summary), made once per run and kept on it; None
    off CUDA and where nothing was traced."""
    out = getattr(run, "cards_prof", False)
    if out is not False:
        return out
    run.cards_prof = None
    if run.device.type != "cuda":
        return None
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile
    from benchmark import harness
    slv = run.solver
    host = slv if slv.loop == "host" else slv.with_loop("host")
    entry = harness.Entry(host, run.config, run.traffic["precision"])
    F = run.loads[0]
    if host is not slv:
        entry(F)                                          # warm-up
    harness.sync_all(run.cards)
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(SOLVE):
                _, its, _ = entry(F)
                harness.sync_all(run.cards)
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        out = cards_summary(_events(path), [d.index for d in run.cards])
    del host, entry
    if out is None:
        run.log("cards profile: no device operation traced")
        return None
    run.cards_prof = out
    run.log(f"cards profile: one host-loop solve of load 0, {its} FGMRES "
            f"its, {out['wall_s']:.4f} s profiled (the window's solve of "
            f"load 0: {run.walls[0]:.4f} s); busy within it: " + ", ".join(
                f"cuda:{k} {b:.4f} s ({100 * b / out['wall_s']:.2f}%)"
                for k, b in out["busy_by_card"].items()))
    return out


def breakdown(run):
    """The breakdown: of run's sharded solver (cards_profile), else of one
    profiled host-loop solve of run.loads[0] by a single-device twin."""
    from benchmark import harness
    if harness.shards_of(run.config):
        prof = cards_profile(run)
        return None if prof is None else {k: prof[k] for k in
                                          ("device_ops", "idle_gaps")}
    return _single(run)


def _single(run):
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
