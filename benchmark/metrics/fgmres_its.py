"""fgmres_its: FGMRES iterations per solve over the window, summed from the
counts the solver returns (solve_ir's inner_its over every refinement
round, solve's its) and divided by the window's solves. Moves solve_s."""


def read(run):
    if not run.its:
        return None
    return sum(run.its) / len(run.its)
