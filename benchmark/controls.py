"""The readings that the limit of a cell's `correct` rests on, at the cell's
own size, on the card (benchmark runs do not run this):

    python3 benchmark/controls.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--out FILE]

One set-up of the cell, then
- the program's reading on each of --seeds: every load of the seed solved
  once through the cell's timed entry, the largest reference residual;
- the control's reading on each of --control-seeds: the same loads solved
  by the system's own float32 path (the direct float32 solve, FGMRES to the
  guarantee, capped at the configuration's control_max_it iterations),
  the nearest precision below the float64 the guarantee states; for a
  sharded configuration, whose path has no float32 form, the single-card
  float32 solve of the same configuration;
- the faults' readings on those of --seeds that are also control seeds:
  the timed entry's solutions, each with one entry altered where it is
  produced (x[k] + 1e-3 max|x|, k drawn from the seed), and solves that
  return their state unchanged (x = 0).
Prints one JSON object, and writes it to --out.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") not in (HERE, ROOT)]


def log(msg):
    print(f"[controls] {msg}", file=sys.stderr, flush=True)


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, required=True)
    ap.add_argument("--control-seeds", type=seeds, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    from benchmark import harness, yardstick
    if not torch.cuda.is_available():
        log("no CUDA card")
        return 2
    _, cell, _, config, traffic = harness.cell_files(ROOT, args.workload)
    if torch.cuda.device_count() < int(cell["chips"]):
        log(f"{torch.cuda.device_count()} CUDA cards, the cell needs "
            f"{cell['chips']}")
        return 2
    out = harness.readings(config, traffic, args.seeds, args.control_seeds,
                           torch.device("cuda", 0), log,
                           chips=int(cell["chips"]))
    out.update(workload=args.workload, card=yardstick.card(),
               seconds=time.perf_counter() - T_PROCESS)
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
