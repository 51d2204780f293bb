"""The yardstick of the cross-card collectives: the bytes a card must read
from its peers per solve, and the link's peak. Kept apart from the
program, so that a change to the program cannot change how it is
measured. Nothing here imports the program.

The bytes come from the configuration's shapes -- the element grid
(mx, my, mz) cut into the grid of cards -- times what the solve asked its
mesh to exchange (the solve's counts of K1 halos, pressure halos, halos
of the restricted residual, ghost extensions of an L-2 slab and L-2
gathers, and the values its dots reduce), however the program's
collectives carry it out. Per card, each value read once:

- a K1 halo (halo_u): each face neighbour's plane of the Q2 node grid,
  3 values a node; a neighbour's plane carries its own neighbours' share
  of the edges it holds, so nothing comes from a diagonal neighbour;
- a pressure halo (halo_p): each face neighbour's plane of the Q1 node
  grid, 1 value a node;
- a halo of the restricted residual (halo_r): each face neighbour's plane
  of the L-2 slab (the element-corner grid of the card's box), 3 values
  a node;
- a ghost extension of an L-2 slab: what a padded stencil reads beyond
  the box -- each face neighbour's plane, each edge neighbour's line and
  each corner neighbour's node next to the box, 3 values a node;
- an L-2 gather: every other card's slab;
- a dot's partial: its values from every other card.

8 bytes a value (the sharded solve is float64). Flags, acknowledgements
and anything else an implementation moves are not counted, so a kernel
that moves less cannot read above its share of the peak."""

import itertools

import numpy as np

# NVIDIA H100 SXM data sheet: NVLink 4, 900 GB/s per card in both
# directions together, 450 GB/s in one
NVLINK_BYTES_PER_S = 450e9
ITEMSIZE = 8


def box_elements(m_el, grid):
    """Elements per card along each axis (x first): the element grid
    split evenly over the grid of cards."""
    if any(m % g for m, g in zip(m_el, grid)):
        raise ValueError(f"{tuple(grid)} cards do not split the element "
                         f"grid {tuple(m_el)} evenly")
    return tuple(m // g for m, g in zip(m_el, grid))


def neighbours(box, grid):
    """Offsets (per axis in {-1, 0, 1}, not all 0) of the cards around
    `box` in the grid of cards."""
    out = []
    for o in itertools.product((-1, 0, 1), repeat=len(grid)):
        if any(o) and all(0 <= b + c < g for b, c, g in zip(box, o, grid)):
            out.append(o)
    return out


def values_per_card(m_el, grid, box, asked):
    """Values the card at `box` must read from its peers in one solve
    that asked for `asked`: {"halo_u", "halo_p", "halo_r", "ghosts",
    "l2_gathers", "psum_values": count}."""
    mloc = box_elements(m_el, grid)
    nd = len(mloc)
    q2 = [2 * m + 1 for m in mloc]
    q1 = [m + 1 for m in mloc]
    cards = int(np.prod(grid))
    near = neighbours(box, grid)
    faces = [o for o in near if sum(map(abs, o)) == 1]

    def plane(nodes, o, comps):
        return comps * int(np.prod([n for n, c in zip(nodes, o) if not c]))

    return (asked["halo_u"] * sum(plane(q2, o, nd) for o in faces)
            + asked["halo_p"] * sum(plane(q1, o, 1) for o in faces)
            + asked["halo_r"] * sum(plane(q1, o, nd) for o in faces)
            + asked["ghosts"] * sum(plane(q1, o, nd) for o in near)
            + asked["l2_gathers"] * (cards - 1) * nd * int(np.prod(q1))
            + (cards - 1) * asked["psum_values"])


def bytes_per_card(m_el, grid, box, asked):
    """values_per_card in bytes."""
    return ITEMSIZE * values_per_card(m_el, grid, box, asked)


def boxes(grid):
    """Every card's box in the program's stack order (x fastest)."""
    return [tuple(reversed(b)) for b in
            itertools.product(*(range(g) for g in reversed(grid)))]


def share(nbytes, seconds):
    """nbytes over seconds as a share of one card's NVLink bandwidth in one
    direction, in %."""
    return 100.0 * nbytes / seconds / NVLINK_BYTES_PER_S
