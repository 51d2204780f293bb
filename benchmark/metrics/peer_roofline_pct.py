"""peer_roofline_pct: the bytes a card's collectives must read from its
peers per solve (benchmark/peer_count.py: partials, slabs and planes, each
read once) over the time of its `psum` and `halo` spans per solve, as a
share of one card's NVLink bandwidth in one direction (450 GB/s, H100
SXM), mean over the cards: the cards' traced pass
(benchmark/cart_traced.py). Moves solve_s."""

from benchmark import cart_traced


def read(run):
    return cart_traced.reading(run, "peer_roofline_pct")
