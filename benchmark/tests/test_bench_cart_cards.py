"""The readers of the four-card cell (metrics/cart_psum_ms.py,
cart_halo_ms.py, peer_roofline_pct.py over benchmark/cart_traced.py and
benchmark/peer_count.py): their arithmetic on made-up traces, and None
where nothing can be read (the CPU, a solver without cross-card
collectives)."""

import types

import pytest

from benchmark import cart_traced, harness, peer_count
from exsaddle_tpu_torch.trace import Span

MS = 1_000_000      # ns


def _col(spans, drops=0):
    return {"spans": spans, "drops": drops}


def _dev(name, start, end, solve):
    return Span(name, start, end, None, solve, True)


ASKED = {"halo_u": 2, "halo_p": 3, "halo_r": 5, "ghosts": 7,
         "l2_gathers": 11, "psum_values": 13}


def _collectives(cards):
    """A solve's counts on each card: what it asked its mesh for (ASKED),
    and what the program's collectives did, which the yardstick ignores."""
    return dict({key: [v] * cards for key, v in ASKED.items()},
                psums=[3] * cards, halo_exchanges=[5] * cards,
                graph_launches=cards)


def test_count_reads_each_partial_from_every_other_card():
    """8^3 elements on a 1 x 2 x 2 grid of cards, boxes of 8 x 4 x 4
    elements: Q2 nodes 17 x 9 x 9, Q1 / L-2 nodes 9 x 5 x 5. Card (0, 0, 0)
    has a face neighbour along y and z and one diagonal: planes of 17 x 9
    nodes each way (K1), 9 x 5 (pressure, restricted residual, ghosts),
    the diagonal's line of 9 L-2 nodes for a ghost extension; a gather
    reads three slabs, a psum three partials. 8 bytes a value; the share
    is of 450 GB/s."""
    grid, m_el = (1, 2, 2), (8, 8, 8)
    assert peer_count.box_elements(m_el, grid) == (8, 4, 4)
    assert peer_count.boxes(grid) == [(0, 0, 0), (0, 1, 0), (0, 0, 1),
                                      (0, 1, 1)]
    want = (2 * 2 * 17 * 9 * 3 + 3 * 2 * 9 * 5 + 5 * 2 * 9 * 5 * 3
            + 7 * (2 * 9 * 5 + 9) * 3 + 11 * 3 * 9 * 5 * 5 * 3 + 3 * 13)
    for box in peer_count.boxes(grid):
        assert peer_count.values_per_card(m_el, grid, box, ASKED) == want
    assert peer_count.bytes_per_card(m_el, grid, (0, 0, 0), ASKED) == \
        8 * want
    # a middle card of a 1 x 1 x 4 grid reads a plane from each side
    one = dict(dict.fromkeys(ASKED, 0), halo_u=1)
    assert peer_count.values_per_card((8, 8, 8), (1, 1, 4), (0, 0, 1),
                                      one) == 2 * 17 * 17 * 3
    with pytest.raises(ValueError):
        peer_count.box_elements((8, 8, 6), (1, 1, 4))
    assert peer_count.share(450e9, 1.0) == pytest.approx(100.0)


def test_summarise_means_per_solve_then_over_cards():
    """Two cards, two solves after the warm-up (device solve ids 2 and 3):
    the warm-up's spans (id 1) and an open span count for nothing; psum
    and halo times are per solve, then averaged over the cards; the
    roofline share is each card's bytes over its psum + halo time."""
    c0 = [_dev("psum", 0, 2 * MS, 2), _dev("psum", 0, 2 * MS, 3),
          _dev("halo", 0, 4 * MS, 2), _dev("halo", 0, 4 * MS, 3),
          _dev("psum", 0, 50 * MS, 1), _dev("halo", 0, None, 3),
          _dev("vcycle", 0, 9 * MS, 2)]
    c1 = [_dev("psum", 0, 4 * MS, 2), _dev("psum", 0, 4 * MS, 3),
          _dev("halo", 0, 8 * MS, 2), _dev("halo", 0, 8 * MS, 3)]
    results = [{"collectives": _collectives(2)}] * 2
    grid, m_el = (1, 1, 2), (4, 4, 4)
    out = cart_traced.summarise([_col(c0), _col(c1)], results, 2,
                                lambda s: None, m_el, grid)
    assert out["cart_psum_ms"] == pytest.approx(3.0)
    assert out["cart_halo_ms"] == pytest.approx(6.0)
    nbytes = peer_count.bytes_per_card(m_el, grid, (0, 0, 0), ASKED)
    assert nbytes == peer_count.bytes_per_card(m_el, grid, (0, 0, 1), ASKED)
    want = (peer_count.share(nbytes, 6e-3)
            + peer_count.share(nbytes, 12e-3)) / 2
    assert out["peer_roofline_pct"] == pytest.approx(want)


def test_summarise_reads_nothing_without_collectives_or_with_drops():
    one = [_dev("vcycle", 0, MS, 2)]
    res = [{}]
    grid, m_el = (1, 1, 2), (4, 4, 4)
    assert cart_traced.summarise([_col(one)], res, 1, lambda s: None, m_el,
                                 grid) is None
    spans = [_dev("psum", 0, MS, 2)]
    assert cart_traced.summarise([_col(spans, drops=3)], res, 1,
                                 lambda s: None, m_el, grid) is None
    # spans but no counts (a program that does not count): no share
    out = cart_traced.summarise([_col(spans)], res, 1, lambda s: None, m_el,
                                grid)
    assert out["cart_psum_ms"] == pytest.approx(1.0)
    assert "peer_roofline_pct" not in out


@pytest.mark.parametrize("name", ["cart_psum_ms", "cart_halo_ms",
                                  "peer_roofline_pct"])
def test_readers_read_nothing_on_the_cpu(name):
    import torch
    run = types.SimpleNamespace(device=torch.device("cpu"), solver=None,
                                log=lambda s: None)
    assert harness.metric_reader(name)(run) is None
