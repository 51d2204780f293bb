"""vcycle_ms: the multigrid V-cycles per solve, in ms: the device spans
`vcycle` (abf._mg_pc: K1 smoothing, K5 transfers, K4 levels, the coarse
solve included). Device marks from the traced pass (benchmark/traced.py),
mean per solve. Moves solve_s."""

from benchmark import traced


def read(run):
    return traced.reading(run, "vcycle_ms")
