"""ms_per_fgmres_it: the window's solve time over its FGMRES iterations,
in ms: the device loop's cost per iteration, whatever the count. Moves
solve_s."""


def read(run):
    its = sum(run.its)
    if its == 0:
        return None
    return 1e3 * run.window_s / its
