"""Run one cell of the port's benchmark once, on the card it is started on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (BENCHMARK.json's "workloads") names a configuration and a
traffic mix; set-up builds the system under test (exsaddle_tpu_torch's
ABFSolver, or for a sharded configuration its CartABFSolver with one
shard per card of the cell's chips) and the seed's loads, the window
solves them in a closed loop for `--seconds`, and the reference then
judges every solution. The last line of standard output is the result
(JSON); the last lines of standard error are the numbers compared, each
beside its limit. --trace 1 reports the per-layer metrics in place of the
end-to-end ones.

Exits non-zero with no result where no CUDA card is present (or fewer
than the cell asks for) and where JAX or the JAX package was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the harness is the package `benchmark` under the checkout's root; its
# own directory leaves the path, so that no file of it shadows a module
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") not in (HERE, ROOT)]


def log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    import torch
    from benchmark import guard, harness
    _, cell, _, _, _ = harness.cell_files(ROOT, args.workload)
    if not torch.cuda.is_available():
        log("no CUDA card: nothing measured")
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        log(f"{torch.cuda.device_count()} CUDA cards, the cell needs "
            f"{cell['chips']}: nothing measured")
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), torch.device("cuda", 0),
                           T_PROCESS, log=log, chips=int(cell["chips"]))
    hits = guard.banned_loaded()
    if hits:
        log(f"refused: the run loaded {', '.join(hits)}")
        return 3
    for name, c in out["checks"].items():
        if isinstance(c, dict):
            print(f"check {name} {c['value']!r} limit {c['limit']!r}",
                  file=sys.stderr)
        else:
            print(f"check {name}: {c}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
