"""One run of one benchmark cell: the system's set-up, a closed-loop window
of solves over the traffic's loads, the per-layer readings of a traced run,
and the reference's judgement of every solution the window returned.

A configuration that states "shards": n is run as the port's driver runs
more than one shard: the sharded solver (parallel/cart_abf.CartABFSolver)
over the cartesian grid that driver picks, shard i on card i % chips of
the cell, float64 throughout.

Everything a cell needs is found by name: its configuration file (the
"file" of its entry in BENCHMARK.json), its traffic file
(traffic/<traffic>.json) and, in a traced run, one reader per per-layer
metric (metrics/<name>.py, whose `read(run)` returns a number or None).
A new configuration, traffic mix or metric is a new file and entry.
"""

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import time
import types

import numpy as np
import torch

from benchmark import loads as bloads
from benchmark import yardstick
from benchmark.reference import fem

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


# --------------------------------------------------------------------------
# Files
# --------------------------------------------------------------------------

def read_json(path):
    with open(path) as fh:
        return json.load(fh)


def cell_files(root, workload):
    """(BENCHMARK.json, the cell's entry, its configuration entry, the
    configuration file, the traffic file) of the cell named `workload`."""
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(cells: {', '.join(cells)})")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = read_json(os.path.join(root, entry["file"]))
    traffic = read_json(os.path.join(HERE, "traffic",
                                     cell["traffic"] + ".json"))
    return bench, cell, entry, config, traffic


def metric_reader(name):
    """The `read` function of metrics/<name>.py."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# --------------------------------------------------------------------------
# The configuration: the reference's problem and the system's
# --------------------------------------------------------------------------

def mesh_shape(config):
    """(element counts, box size) of a configuration's flags."""
    f = config["flags"]
    nd = int(config["ndim"])
    axes = "xyz"[:nd]
    mx = int(f["mx"])
    m_el = tuple(int(f.get("m" + a, mx)) for a in axes)
    size = tuple(float(f.get("size_" + a, 1.0)) for a in axes)
    return m_el, size


def reference_problem(config):
    """The configuration worked out by the reference: mesh, FE space, the
    solver's coefficients at the quadrature points (projected through the
    Q1 nodes), Dirichlet rows and values."""
    m_el, size = mesh_shape(config)
    model = importlib.import_module(
        "benchmark.reference.models." + config["model_file"])
    mesh = fem.Mesh(m_el, size)
    fes = fem.FESpace(mesh)
    nd = mesh.ndim
    eta, Fu, Fp = model.coefficients(config["flags"],
                                     fes.qp_coords.reshape(-1, nd))
    cq = np.concatenate([eta[:, None], Fu, Fp[:, None]], axis=1)
    cq = fem.projected(fes, cq.reshape(mesh.nel, fes.nqp, -1))
    bc_idx, bc_vals = model.dirichlet(config["flags"], mesh)
    return {"mesh": mesh, "fes": fes, "eta": cq[..., 0],
            "Fu": cq[..., 1:1 + nd], "Fp": cq[..., 1 + nd],
            "bc_idx": bc_idx, "bc_vals": bc_vals}


def flag_args(flags):
    """The configuration's flags as the system's command-line options."""
    return [a for k, v in flags.items() for a in ("-" + k, str(v))]


def system_problem(config):
    """The system's own set-up of the configuration, from its flags, as its
    driver builds it (mesh, FE space, coefficients, Dirichlet rows, and the
    model context the sharded build works its coefficients out from)."""
    from exsaddle_tpu_torch import driver, models
    from exsaddle_tpu_torch.assembly import FESpace
    from exsaddle_tpu_torch.mesh import SaddleMesh
    from exsaddle_tpu_torch.options import Options
    m_el, size = mesh_shape(config)
    ctx = models.ModelContext(Options.from_args(flag_args(config["flags"])),
                              int(config["ndim"]), log=lambda *a, **k: None)
    mesh = SaddleMesh(int(config["ndim"]), m_el, size)
    fes = FESpace(mesh)
    bc_idx, bc_vals = models.create_bc_list(ctx, mesh)
    return {"mesh": mesh, "fes": fes,
            "coeff": driver.fine_coefficients(ctx, fes),
            "bc_idx": bc_idx, "bc_vals": bc_vals, "ctx": ctx}


def load_kernels(device):
    """Load the system's kernel library from the checkout's build cache
    (built there on a checkout's first run)."""
    if device.type == "cuda":
        from exsaddle_tpu_torch.kernels import _build
        _build.load()


def shards_of(config):
    """The shard count a sharded configuration states, or None."""
    n = config.get("shards")
    return None if n is None else int(n)


def check_sharded(config, traffic):
    """Refuse a sharded configuration under traffic that is not float64:
    the sharded path solves in float64 only (the port's driver turns -ir
    off for it)."""
    if shards_of(config) and traffic["precision"] != "float64":
        raise ValueError(
            f"a sharded configuration ({shards_of(config)} shards) runs "
            f"float64 traffic only, not {traffic['precision']!r}: the "
            "sharded path has no mixed-precision refinement")


def shard_devices(device, n, chips):
    """The device of each of n shards: card i % chips on CUDA, every shard
    on `device` elsewhere."""
    if device.type != "cuda":
        return [device] * n
    return [torch.device("cuda", i % int(chips)) for i in range(n)]


def solver_cards(slv, device):
    """The distinct devices a solver holds its data on."""
    smesh = getattr(slv, "smesh", None)
    return list(smesh.distinct) if smesh is not None else [device]


def build_solver(config, sysprob, device, precision, chips=1):
    """The system under test: one ABFSolver of the configuration's solver
    tree, (solver, seconds to build it, the device synchronised at both
    ends). precision "mixed": float32 inner solves in float64 iterative
    refinement; "float64" / "float32" (the control): the direct solve in
    that type, its FGMRES to the tolerance the configuration requests.
    A sharded configuration builds the sharded solver (build_sharded), but
    for the float32 control, which has no sharded form: that stays the
    single-card ABFSolver."""
    if shards_of(config) and precision != "float32":
        return build_sharded(config, sysprob, device, chips)
    from exsaddle_tpu_torch.abf import ABFSolver
    kw = dict(config["solver"])
    if precision != "mixed":
        kw["rtol"] = float(config["guarantee"]["requested_rtol"])
    if precision == "float32":
        kw["max_it"] = int(config["control_max_it"])
    dtype = torch.float64 if precision == "float64" else torch.float32
    sync(device)
    t0 = time.perf_counter()
    slv = ABFSolver(sysprob["mesh"], sysprob["fes"], sysprob["coeff"],
                    sysprob["bc_idx"], sysprob["bc_vals"], device=device,
                    dtype=dtype, nlevels=int(config["mg_levels"]),
                    ir=precision == "mixed", **kw)
    sync(device)
    return slv, time.perf_counter() - t0


def build_sharded(config, sysprob, device, chips):
    """The sharded system under test, built as driver.saddle_solve builds
    it for more than one shard: CartABFSolver over CartPartition(mesh,
    driver._choose_dev_shape(m_el, shards)), from the configuration's
    model context, Dirichlet rows and values, mg_levels levels and solver
    knobs, its FGMRES to the requested tolerance, in float64; shard i on
    card i % chips (shard_devices). (solver, seconds to build it, every
    card synchronised at both ends)."""
    from exsaddle_tpu_torch import driver
    from exsaddle_tpu_torch.parallel.cart import CartPartition
    from exsaddle_tpu_torch.parallel.cart_abf import CartABFSolver
    n = shards_of(config)
    mesh = sysprob["mesh"]
    shape = driver._choose_dev_shape(mesh.m_el, n)
    if shape is None:
        raise ValueError(f"{n} shards do not factor into the element grid "
                         f"{mesh.m_el}")
    devices = shard_devices(device, n, chips)
    kw = dict(config["solver"],
              rtol=float(config["guarantee"]["requested_rtol"]))
    sync_all(dict.fromkeys(devices))
    t0 = time.perf_counter()
    slv = CartABFSolver(CartPartition(mesh, shape), sysprob["ctx"],
                        sysprob["bc_idx"], sysprob["bc_vals"], devices,
                        nlevels=int(config["mg_levels"]), **kw)
    sync_all(dict.fromkeys(devices))
    return slv, time.perf_counter() - t0


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sync_all(devices):
    for d in devices:
        sync(d)


class Entry:
    """The entry a window drives: solve_ir to the requested tolerance
    (mixed) or the direct solve; returns (x in natural order, float64; its
    FGMRES iterations; the residual the solver reports for itself,
    relative for solve_ir and absolute for solve)."""

    def __init__(self, slv, config, precision):
        self.slv = slv
        self.mixed = precision == "mixed"
        self.rtol = float(config["guarantee"]["requested_rtol"])

    def __call__(self, F):
        if self.mixed:
            res = self.slv.solve_ir(F, rtol=self.rtol)
            return (np.asarray(res["x"], np.float64), int(res["inner_its"]),
                    res["rnorm"] / res["rnorm0"])
        res = self.slv.solve(F)
        return np.asarray(res["x"], np.float64), int(res["its"]), res["rnorm"]


class GraphSpans:
    """CUDA events around each launch of the solver's device-loop graph
    (graphs.ControlGraph.launch, shadowed on the instance while attached):
    the device span of every solve, without the host's work in the call.
    Absent where the solver has no such graph."""

    def __init__(self, slv):
        self.graph = getattr(getattr(slv, "_dev", None), "graph", None)
        self.events = []
        if self.graph is None:
            return
        launch = self.graph.launch

        def timed():
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            launch()
            e1.record()
            self.events.append((e0, e1))
        self.graph.launch = timed

    def detach(self):
        if self.graph is not None:
            del self.graph.launch

    def seconds(self):
        """Device seconds of each recorded launch, or None."""
        if self.graph is None:
            return None
        return [1e-3 * e0.elapsed_time(e1) for e0, e1 in self.events]


class Stages:
    """with stages(name): logs the block's host seconds."""

    def __init__(self, log):
        self.log = log

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.perf_counter()
        yield
        self.log(f"{name}: {time.perf_counter() - t0:.3f} s")


def window(entry, loads, seconds):
    """The closed loop with one client: solve k + 1 starts when solve k
    has returned its solution to the host; loads in order, cycled; no
    solve starts after `seconds`. Returns (window seconds, walls, its, xs,
    the residuals the solver reports, error)."""
    walls, its, xs, own = [], [], [], []
    error = None
    t_start = time.perf_counter()
    t_end = t_start
    while t_end - t_start < seconds:
        F = loads[len(xs) % len(loads)]
        t0 = time.perf_counter()
        try:
            x, n, r = entry(F)
        except Exception as e:           # the run reports it, not correct
            error = f"solve {len(xs)}: {type(e).__name__}: {e}"
            t_end = time.perf_counter()
            break
        t_end = time.perf_counter()
        walls.append(t_end - t0)
        its.append(n)
        xs.append(x)
        own.append(r)
    return t_end - t_start, walls, its, xs, own, error


def saddle(problem, device):
    """The reference operator of a reference problem, on `device`."""
    return fem.Saddle(problem["fes"], problem["eta"], problem["bc_idx"],
                      device)


def free(device):
    """Return what is no longer referenced to the device."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def judge(config, problem, loads_ref, xs, attempted, device, chunk=32):
    """The reference's judgement of every solution the window returned:
    its float64 relative residual in the configuration's own system.
    Returns (residuals, checks): checks name each number compared, its
    value and its limit."""
    limit = float(config["guarantee"]["rel_residual"])
    S = saddle(problem, device)
    res = []
    for c in range(0, len(xs), chunk):
        idx = range(c, min(c + chunk, len(xs)))
        X = torch.as_tensor(np.stack([xs[i] for i in idx], axis=1),
                            device=device)
        F = torch.as_tensor(np.stack(
            [loads_ref[i % len(loads_ref)] for i in idx], axis=1),
            device=device)
        res += [float(r) for r in S.rel_residuals(F, X).cpu()]
        del X, F
    del S
    worst = max(res, key=lambda r: r if r == r else np.inf) if res else None
    checks = {
        "resid_max": {"value": worst, "limit": limit},
        "unanswered": {"value": attempted - len(xs), "limit": 0},
    }
    return res, checks


def run_cell(workload, seed, seconds, trace, device, t_process,
             root=ROOT, config=None, traffic=None, wrap=None, log=None,
             chips=1):
    """One run of the cell `workload`; returns the result line's object.

    t_process: the process's start on the host clock (perf_counter);
    config / traffic: given, they replace the cell's files (the tests'
    small sizes); wrap(entry) -> entry: the tests' faults, planted under
    the timed path. log(str): progress lines (standard error). chips: the
    cards a sharded configuration's shards are placed on (shard_devices)."""
    log = log or (lambda s: None)
    bench, cell, _, config_f, traffic_f = cell_files(root, workload)
    config = config or config_f
    traffic = traffic or traffic_f
    check_sharded(config, traffic)
    sharded = bool(shards_of(config))
    stages = Stages(log)
    with stages("kernel library"):
        load_kernels(device)
    # the loads first, so that the reference's device memory is freed
    # before the system is built and the peak is the system's
    with stages(f"reference problem and {traffic['loads']} loads"):
        problem = reference_problem(config)
        loads_ref = bloads.make_loads(traffic, seed, problem,
                                      saddle(problem, device))
        free(device)
    with stages("system problem (mesh, FE space, coefficients)"):
        sysprob = system_problem(config)
    slv, build_s = build_solver(config, sysprob, device,
                                traffic["precision"], chips)
    cards = solver_cards(slv, device)
    log(f"solver built in {build_s:.3f} s ({traffic['precision']}, "
        f"{sysprob['mesh'].ndof} dofs)")
    if sharded:
        log(f"sharded: {shards_of(config)} shards, grid "
            f"{slv.part.dev_shape}, {slv.part.mloc} elements each, on "
            f"{', '.join(str(d) for d in slv.smesh.devices)}; the "
            f"{slv.loop} loop")
    rhs_diri = np.asarray(slv.setup["rhs_diri"])
    loads_sys = [F + rhs_diri for F in loads_ref]
    entry = Entry(slv, config, traffic["precision"])
    if wrap is not None:
        entry = wrap(entry)
    with stages("warm-up solve"):
        entry(loads_sys[0])
        sync_all(cards)
    spans = GraphSpans(slv)
    setup_s = time.perf_counter() - t_process
    log(f"set-up {setup_s:.3f} s; window of {seconds} s")

    window_s, walls, its, xs, own, error = window(entry, loads_sys, seconds)
    attempted = len(xs) + (error is not None)
    spans.detach()
    span_s = spans.seconds()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    log(f"window {window_s:.3f} s: {len(xs)} solves, {sum(its)} FGMRES its"
        + (f"; {error}" if error else ""))
    n_its = max(sum(its), 1)
    if span_s:
        log(f"graph spans {sum(span_s):.4f} s, "
            f"{100 * sum(span_s) / window_s:.3f}% of the window; "
            f"{1e3 * sum(span_s) / n_its:.4f} ms per FGMRES it on the device")
    if len(walls) >= 4:
        q = len(walls) // 4
        log(f"walls: first quarter {np.mean(walls[:q]):.5f} s, last quarter "
            f"{np.mean(walls[-q:]):.5f} s, min {min(walls):.5f} s, max "
            f"{max(walls):.5f} s; ms per FGMRES it "
            f"{1e3 * window_s / n_its:.4f}")

    # what the per-layer readers read
    run = types.SimpleNamespace(cell=cell, config=config, traffic=traffic,
                                solver=slv, device=device, seed=seed,
                                setup_s=setup_s, build_s=build_s,
                                window_s=window_s, walls=walls, its=its,
                                graph_spans=span_s, loads=loads_sys, log=log,
                                cards=cards)
    out = {"correct": False, "attempted": attempted, "failed": 0,
           "metrics": {}, "device": device_info(device, peak)}
    if sharded:
        by_card = [torch.cuda.max_memory_allocated(d) if d.type == "cuda"
                   else 0 for d in cards]
        out["device"].update(count=len(cards),
                             memory_peak_bytes=int(max(by_card)),
                             memory_peak_bytes_by_card=[int(b)
                                                        for b in by_card])
        log("peak memory by card: " + ", ".join(
            f"{d} {b} B" for d, b in zip(cards, by_card)))
    if walls:
        e2e = {"solve_s": window_s / len(walls),
               "solve_s_p90": yardstick.p90(walls), "setup_s": setup_s}
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]
                 + bench["per_layer"]}
        if trace:
            busy = sum(span_s) if span_s else sum(walls)
            traced_s = window_s
            if sharded:
                from benchmark import breakdown
                prof = breakdown.cards_profile(run)
                if prof is not None:
                    busy, traced_s = prof["busy_s"], prof["wall_s"]
            out["device"].update(busy_s=busy, window_s=traced_s)
            for m in bench["per_layer"]:
                if "workloads" in m and workload not in m["workloads"]:
                    continue
                value = metric_reader(m["name"])(run)
                if value is not None:
                    out["metrics"][m["name"]] = {"value": float(value),
                                                 "unit": units[m["name"]]}
            from benchmark import breakdown
            with stages("breakdown"):
                bd = breakdown.breakdown(run)
            if bd is not None:
                out["breakdown"] = bd
        else:
            for m in bench["end_to_end"]:
                if "workloads" in m and workload not in m["workloads"]:
                    continue
                out["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                             "unit": units[m["name"]]}
    del run, entry, slv, spans, sysprob
    free(device)

    with stages(f"reference check of {len(xs)} solutions"):
        resid, checks = judge(config, problem, loads_ref, xs, attempted,
                              device)
    if traffic["precision"] != "mixed":
        own = [r / float(np.linalg.norm(loads_sys[i % len(loads_sys)]))
               for i, r in enumerate(own)]
    if resid:
        gap = max(abs(a - b) for a, b in zip(resid, own))
        log(f"reference residuals {min(resid):.6e} .. {max(resid):.6e} "
            f"(median {float(np.median(resid)):.6e}); the solver's own "
            f"within {gap:.3e} of them; its per solve {min(its)}..{max(its)}")
    limit = checks["resid_max"]["limit"]
    failed = sum(1 for r in resid if not r <= limit) + (attempted - len(xs))
    out["failed"] = failed
    out["correct"] = bool(attempted > 0 and failed == 0 and error is None)
    if error:
        checks["error"] = error
    out["checks"] = checks
    return out


def altered(x, seed):
    """x with one entry altered where it is produced: x[k] + 1e-3 max|x|,
    k drawn from the seed."""
    y = np.array(x, dtype=np.float64)
    k = int(bloads.rng_of(seed).integers(len(y)))
    y[k] += 1e-3 * float(np.abs(y).max())
    return y


def readings(config, traffic, seeds, control_seeds, device, log, chips=1):
    """The readings a cell's limit rests on (controls.py): one set-up, then
    the largest reference residual of the timed entry over each of `seeds`'
    loads (each solved once), and on each of `control_seeds` the control's
    (the system's float32 direct solve, capped at control_max_it FGMRES
    iterations), the altered answer's and the unchanged state's (x = 0).
    For a sharded configuration the timed entry is the sharded solver's
    (placed on `chips` cards) and the control the single-card float32
    direct solve, since the sharded path has no float32 form.
    Returns {"limit", "program", "control", "altered", "unchanged"}, each
    reading keyed by seed."""
    stages = Stages(log)
    precision = traffic["precision"]
    check_sharded(config, traffic)
    with stages("system problem"):
        sysprob = system_problem(config)
        problem = reference_problem(config)
        ref = saddle(problem, device)
    slv, build_s = build_solver(config, sysprob, device, precision, chips)
    ctl, ctl_s = build_solver(config, sysprob, device, "float32")
    log(f"solvers built in {build_s:.3f} s ({precision}) and {ctl_s:.3f} s "
        f"(float32 control)")
    if shards_of(config):
        log(f"the program: {shards_of(config)} shards on "
            f"{', '.join(str(d) for d in slv.smesh.devices)}; the control: "
            f"the single-card float32 direct solve on {device} (the sharded "
            "path has no float32 form)")
    entry = Entry(slv, config, precision)
    control = Entry(ctl, config, "float32")
    rhs_diri = np.asarray(slv.setup["rhs_diri"])
    rhs_ctl = np.asarray(ctl.setup["rhs_diri"])
    out = {"limit": float(config["guarantee"]["rel_residual"]),
           "program": {}, "control": {}, "altered": {}, "unchanged": {}}

    def worst(loads_ref, xs):
        res, _ = judge(config, problem, loads_ref, xs, len(xs), device)
        return max(res), min(res)

    for seed in seeds:
        loads_ref = bloads.make_loads(traffic, seed, problem, ref)
        xs, its = [], []
        for F in loads_ref:
            x, n, _ = entry(F + rhs_diri)
            xs.append(x)
            its.append(n)
        out["program"][seed], lo = worst(loads_ref, xs)
        out.setdefault("its_mean", {})[seed] = float(np.mean(its))
        log(f"seed {seed}: program {out['program'][seed]:.6e} (least "
            f"{lo:.6e}), its {min(its)}..{max(its)} (mean "
            f"{np.mean(its):.4f})")
        if seed in control_seeds:
            out["altered"][seed], lo_a = worst(
                loads_ref, [altered(x, seed) for x in xs])
            out["unchanged"][seed] = worst(
                loads_ref, [np.zeros_like(x) for x in xs])[0]
            log(f"seed {seed}: altered {out['altered'][seed]:.6e} (least "
                f"{lo_a:.6e})")
    for seed in control_seeds:
        loads_ref = bloads.make_loads(traffic, seed, problem, ref)
        xs = [control(F + rhs_ctl)[0] for F in loads_ref]
        hi, lo = worst(loads_ref, xs)
        out["control"][seed] = hi
        log(f"seed {seed}: control {hi:.6e} (least {lo:.6e})")
    return out


def device_info(device, peak):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak)}
