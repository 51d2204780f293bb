"""build_s: seconds of the ABFSolver constructor (abf.build_abf's host
set-up, the Galerkin hierarchy, the device cast and the graph capture),
host clock, the device synchronised at both ends. Moves setup_s."""


def read(run):
    return run.build_s
