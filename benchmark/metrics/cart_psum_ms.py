"""cart_psum_ms: the device time per solve of the sharded solve's
cross-card reductions (shard_mesh.CardMesh psum and the L-2 gather, peer
kernels), each card's `psum` spans, their waits included, mean over the
cards: the cards' traced pass (benchmark/cart_traced.py). Moves solve_s."""

from benchmark import cart_traced


def read(run):
    return cart_traced.reading(run, "cart_psum_ms")
