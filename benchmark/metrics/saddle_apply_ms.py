"""saddle_apply_ms: FGMRES's operator per solve, in ms: the device spans
`saddle_apply` (treeops.DeviceFGMRES's mult in cycle_start and
arnoldi_post: the full saddle apply, K1 with the A01/A10 couplings).
Device marks from the traced pass (benchmark/traced.py), mean per solve.
Moves solve_s."""

from benchmark import traced


def read(run):
    return traced.reading(run, "saddle_apply_ms")
