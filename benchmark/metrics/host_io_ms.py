"""host_io_ms: the host's work per solve around the device loop, in ms:
the part of each `solve_call` host span (abf.ABFSolver.solve_ir / solve)
that its device `solve` span (the graph's first to last node) does not
cover: the permutation, the float64 cast and the pinned staging, the
copy's enqueue and the launch, the wait's tail, the read-out and the
un-permutation. Host clock, the device's marks mapped onto it; the traced
pass (benchmark/traced.py), mean per solve. Moves solve_s."""

from benchmark import traced


def read(run):
    return traced.reading(run, "host_io_ms")
