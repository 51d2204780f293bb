"""coarse_solve_ms: the V-cycles' coarse solves per solve, in ms: the
device spans `coarse_solve` (abf._mg_pc's dense coarse inverse, a cuBLAS
gemv). Device marks from the traced pass (benchmark/traced.py), mean per
solve. Moves solve_s."""

from benchmark import traced


def read(run):
    return traced.reading(run, "coarse_solve_ms")
