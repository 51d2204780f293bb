"""cart_halo_ms: the device time per solve of the sharded solve's
cross-card halo exchanges (shard_mesh.CardMesh exchange / exchange_add,
peer kernels), each card's `halo` spans, their waits included, mean over
the cards: the cards' traced pass (benchmark/cart_traced.py). Moves
solve_s."""

from benchmark import cart_traced


def read(run):
    return cart_traced.reading(run, "cart_halo_ms")
