"""The traced pass: the program's own spans and counters on the device-loop
path, read by the tracer's per-layer metrics (metrics/host_io_ms.py,
graph_gap_ms, saddle_apply_ms, gram_schmidt_ms, vcycle_ms, coarse_solve_ms,
kernel_nodes_per_solve).

After the window, a second ABFSolver over the run's set-up (its data
shared, ABFSolver.from_parts; loop "device", which the CPU runs as the
plain driver) is built with a trace
(exsaddle_tpu_torch.trace.Trace) and captures its own graph; it solves one
warm-up load, then the run's first N_SOLVES loads through harness.Entry as
the window does; the trace is collected and the solver freed. Each value
is a mean per solve over those solves. The pass logs a table of every
span and the two sum rules a reader checks: host I/O + the device solve
span = the solve call (within the clock's calibration error, where the
device span lies inside the call), and the piece spans + the graph's gaps
= the device solve span.

On the CPU the readings are None (a CPU run is never written under a
device metric), and so they are where the program has no tracer."""

N_SOLVES = 8
NAMED = ("saddle_apply", "gram_schmidt", "vcycle", "coarse_solve")
SPAN_METRICS = ("host_io_ms", "graph_gap_ms") + tuple(
    n + "_ms" for n in NAMED)


def reading(run, name):
    """The traced pass's value `name` for `run` (the pass made once per run
    and kept on it), or None."""
    out = getattr(run, "traced_pass", False)
    if out is False:
        out = run.traced_pass = (measure(run) if run.device.type == "cuda"
                                 else None)
    return None if out is None else out.get(name)


class _Kept:
    """A solver whose result dicts are kept: harness.Entry keeps only x,
    the iterations and the residual, and the counts are in the dict."""

    def __init__(self, slv):
        self.slv, self.results = slv, []

    def solve_ir(self, *args, **kw):
        self.results.append(self.slv.solve_ir(*args, **kw))
        return self.results[-1]

    def solve(self, *args, **kw):
        self.results.append(self.slv.solve(*args, **kw))
        return self.results[-1]


def measure(run, n=N_SOLVES):
    """The traced pass over run's solver and loads, on any device: the
    readings (summarise), or None where the program has no tracer."""
    try:
        from exsaddle_tpu_torch.trace import Trace
    except ImportError:
        run.log("traced pass: the program has no tracer "
                "(exsaddle_tpu_torch.trace): nothing read")
        return None
    from exsaddle_tpu_torch.abf import ABFSolver
    from benchmark import harness
    slv = run.solver
    precision = run.traffic["precision"]
    tr = Trace(run.device)
    tslv = ABFSolver.from_parts(slv.cfg, slv.data, slv.setup,
                                device=run.device, dtype=slv.dtype,
                                ir=precision == "mixed", loop="device",
                                trace=tr)
    kept = _Kept(tslv)
    entry = harness.Entry(kept, run.config, precision)
    entry(run.loads[0])                                   # warm-up
    first = tr.solve + 1
    loads = run.loads[:n]
    for F in loads:
        entry(F)
    col = tr.collect()
    nodes = [tslv.kernel_nodes(r["counts"]) for r in kept.results[1:]]
    setup = [s for s in col["spans"] if s.solve is None and not s.device]
    run.log("traced pass set-up: " + ", ".join(
        f"{s.name} {1e-9 * (s.end - s.start):.3f} s" for s in setup))
    del kept, entry, tslv
    harness.free(run.device)
    return summarise(col, range(first, first + len(loads)), nodes, run.log)


def _union(intervals, lo, hi):
    """The length of the union of intervals, clipped to [lo, hi]."""
    total, end = 0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def summarise(col, ids, nodes, log):
    """The readings of a collected trace (Trace.collect) over the solves
    `ids` (solve_call ids, and the device's count of solves), with nodes
    (ABFSolver.kernel_nodes of each, or None): the metrics in ms per solve,
    kernel_nodes_per_solve, and what the sum rules and the clock read."""
    spans, ids = col["spans"], list(ids)
    n = len(ids)
    calls = {s.solve: s for s in spans
             if not s.device and s.name == "solve_call"}
    solves = {s.solve: i for i, s in enumerate(spans)
              if s.device and s.name == "solve"}
    cals = col["calibration"]
    err = max((c["error_ns"] for c in cals), default=0.0)
    out = {"solves": n, "marks_per_solve": None, "drops": col["drops"],
           "calibration_error_ns": err,
           "drift_ns": (cals[1]["offset_ns"] - cals[0]["offset_ns"]
                        if cals else None),
           "timer_step": col["timer_step"]}
    counted = [nd["total"] for nd in nodes if nd is not None]
    out["kernel_nodes_per_solve"] = (sum(counted) / len(counted)
                                     if counted and len(counted) == n
                                     else None)
    complete = all(k in calls and k in solves
                   and spans[solves[k]].end is not None for k in ids)
    if col["drops"] or not complete:
        log(f"traced pass: {col['drops']} marks dropped, solves complete "
            f"{complete}: the span metrics read None")
        return out
    wanted = set(ids)
    mine = [s for s in spans if s.solve in wanted and s.end is not None]
    out["marks_per_solve"] = 2 * sum(s.device for s in mine) / n
    io, gap, rule1, rule2 = [], [], [], []
    for k in ids:
        call, i = calls[k], solves[k]
        dev = spans[i]
        dev_ns = dev.end - dev.start
        call_ns = call.end - call.start
        io.append(max(0, dev.start - call.start)
                  + max(0, call.end - dev.end))
        rule1.append((io[-1] + dev_ns - call_ns, call_ns))
        pieces = [(s.start, s.end) for s in spans if s.parent == i]
        covered = _union(pieces, dev.start, dev.end)
        gap.append(dev_ns - covered)
        rule2.append(sum(b - a for a, b in pieces) + gap[-1] - dev_ns)
    out["host_io_ms"] = 1e-6 * sum(io) / n
    out["graph_gap_ms"] = 1e-6 * sum(gap) / n
    for name in NAMED:
        out[name + "_ms"] = 1e-6 * sum(s.end - s.start for s in mine
                                       if s.device and s.name == name) / n
    out["rule1_worst_ns"] = max(abs(r) for r, _ in rule1)
    out["rule1_allowed_ns"] = min(err + 0.01 * c for _, c in rule1)
    out["rule2_worst_ns"] = max(abs(r) for r in rule2)
    solve_ms = 1e-6 * sum(spans[solves[k]].end - spans[solves[k]].start
                          for k in ids) / n
    call_ms = 1e-6 * sum(calls[k].end - calls[k].start for k in ids) / n
    out["solve_ms"], out["solve_call_ms"] = solve_ms, call_ms
    _log_table(mine, n, log)
    log(f"traced pass, {n} solves: solve_call {call_ms:.4f} ms = host_io "
        f"{out['host_io_ms']:.4f} + device solve {solve_ms:.4f} ms, off by "
        f"{1e-3 * out['rule1_worst_ns']:.3f} us at worst (allowed: the "
        f"calibration's error {1e-3 * err:.3f} us + 1% of the call); device "
        f"solve = pieces + graph_gap {out['graph_gap_ms']:.4f} ms, off by "
        f"{1e-3 * out['rule2_worst_ns']:.3f} us at worst")
    log(f"traced pass clock: calibration {[c['offset_ns'] for c in cals]} "
        f"ns (drift {out['drift_ns']} ns, error {err:.0f} ns), "
        f"%globaltimer step {col['timer_step']}; {out['marks_per_solve']:.1f}"
        f" marks per solve, {col['drops']} dropped; kernel nodes per solve "
        f"{out['kernel_nodes_per_solve']}")
    return out


def _log_table(spans, n, log):
    rows = {}
    for s in spans:
        key = ("device" if s.device else "host", s.name)
        c, t = rows.get(key, (0, 0))
        rows[key] = (c + 1, t + s.end - s.start)
    log(f"traced pass spans, per solve over {n} solves: where | count | ms "
        f"| us per call | name")
    for (where, name), (c, t) in sorted(rows.items(),
                                         key=lambda kv: -kv[1][1]):
        log(f"  {where} | {c / n:.2f} | {1e-6 * t / n:.4f} | "
            f"{1e-3 * t / c:.3f} | {name}")
