"""device_idle_pct: 100 (1 - the solves' device spans / the window), the
spans from CUDA events recorded around each launch of the solver's
device-loop graph. The host's work in a call (permuting the load, staging
it, reading the solution back) and the harness's between calls count as
idle; gaps inside the graph count as busy, since CUPTI does not see into
its conditional bodies. None where the solver has no such graph. Moves
solve_s."""


def read(run):
    if not run.graph_spans:
        return None
    return 100.0 * (1.0 - sum(run.graph_spans) / run.window_s)
