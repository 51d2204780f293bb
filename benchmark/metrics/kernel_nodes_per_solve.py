"""kernel_nodes_per_solve: the kernel nodes the device loop's graph runs
per solve, trace marks left out: abf.ABFSolver.kernel_nodes(counts), each
captured piece's kernel nodes times the executions the device counted,
over the traced pass's solves (benchmark/traced.py), mean per solve. The
same loads give the same count. Moves solve_s."""

from benchmark import traced


def read(run):
    return traced.reading(run, "kernel_nodes_per_solve")
