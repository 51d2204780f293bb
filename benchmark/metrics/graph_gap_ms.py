"""graph_gap_ms: the device loop's own cost per solve, in ms: the device
`solve` span less the union of its piece spans (each captured run of
Pieces marked first and last in its child graph), i.e. the conditional
nodes and child-graph boundaries between the pieces. Device marks
(%globaltimer) from the traced pass (benchmark/traced.py), mean per solve.
Moves solve_s."""

from benchmark import traced


def read(run):
    return traced.reading(run, "graph_gap_ms")
