"""cards_idle_pct: the share of a sharded solve's wall in which a card runs
nothing, averaged over the cards the solver holds: one profiled solve of
load 0 by the run's own sharded solver on its host loop
(breakdown.cards_profile), each card's kernels and copies merged into
busy intervals within the solve's wall. Whether the cards wait on the host
that drives them. None off CUDA and for a solver that is not sharded.
Moves solve_s."""

from benchmark import breakdown, harness


def read(run):
    if not harness.shards_of(run.config):
        return None
    prof = breakdown.cards_profile(run)
    if prof is None:
        return None
    wall = prof["wall_s"]
    idle = [1.0 - b / wall for b in prof["busy_by_card"].values()]
    return 100.0 * sum(idle) / len(idle)
