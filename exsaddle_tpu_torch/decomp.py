"""Domain decomposition: virtual rank grids and ASM patch index sets (a
numpy copy of exsaddle_tpu/decomp.py for the PyTorch port).

Replicates the decompositions the reference obtains from PETSc so that
rank-count-dependent reference outputs (ASM patches, block-Jacobi blocks)
can be reproduced on any number of actual devices:

  - `dmda_rank_grid`: PETSc DMDA's default process-grid selection
    (src/dm/impls/da/da2.c, da3.c PETSC_DECIDE logic).
  - `dmda_owned_counts`: DMDA default ownership split (remainder nodes to
    the lowest ranks).
  - `element_ranges`: the reference's even-index rounding of node ranges to
    Q2 macro-element ranges (_DMCreate_SaddleQ2_BuildElementLayout,
    femixedspace.c:1075-1133).
  - `asm_patch_dofs`: the per-rank overlapping patch IS of
    DMDAFEPatchCreateGlobalIS_Q2Q1 (femixedspace.c:746-822): Q2 node box
    [2(es-ov), 2(ee+ov)] + Q1 node box [es-ov, ee+ov], in this framework's
    global dof ordering.
"""

import numpy as np


def dmda_rank_grid(size, nn):
    """Default process grid (m, n[, p]) for `size` ranks over a grid with
    node counts nn (2D or 3D), following DMDA's PETSC_DECIDE heuristic."""
    if len(nn) == 2:
        M, N = nn
        m = int(0.5 + np.sqrt(M * size / N))
        m = max(m, 1)
        while m > 0:
            n = size // m
            if m * n == size:
                break
            m -= 1
        if M > N and m < n:
            m, n = n, m
        return (m, n)
    M, N, P = nn
    n = int(0.5 + (N * N * size / (P * M)) ** (1.0 / 3.0))
    n = max(n, 1)
    while n > 0:
        pm = size // n
        if n * pm == size:
            break
        n -= 1
    n = max(n, 1)
    m = int(0.5 + np.sqrt(M * size / (P * n)))
    m = max(m, 1)
    while m > 0:
        p = size // (m * n)
        if m * n * p == size:
            break
        m -= 1
    m = max(m, 1)
    p = size // (m * n)
    if M > P and m < p:
        m, p = p, m
    return (m, n, p)


def dmda_owned_counts(M, m):
    """Nodes per rank along one dimension (remainder to low ranks)."""
    base = M // m
    rem = M % m
    return [base + (1 if r < rem else 0) for r in range(m)]


def element_ranges(M, m):
    """Per-rank [es, ee) Q2 macro-element ranges along one dimension from
    the DMDA node split of M=2*mx+1 nodes over m ranks (even rounding,
    femixedspace.c:1102-1124)."""
    counts = dmda_owned_counts(M, m)
    starts = np.concatenate([[0], np.cumsum(counts)])
    ranges = []
    for r in range(m):
        s_g, e_g = int(starts[r]), int(starts[r + 1])
        s_el = s_g if s_g % 2 == 0 else s_g - 1
        e_el = e_g if e_g % 2 == 0 else e_g - 1
        if (e_el - s_el) % 2:
            raise ValueError("Cannot generate consistent macro element")
        ranges.append((s_el // 2, e_el // 2))   # element indices [es, ee)
    return ranges


def rank_element_boxes(mesh, nranks):
    """Per-rank element boxes [(es,ee) per dim] for the virtual rank grid."""
    grid = dmda_rank_grid(nranks, mesh.nn_u)
    per_dim = [element_ranges(mesh.nn_u[d], grid[d])
               for d in range(mesh.ndim)]
    boxes = []
    if mesh.ndim == 2:
        for rj in range(grid[1]):
            for ri in range(grid[0]):
                boxes.append((per_dim[0][ri], per_dim[1][rj]))
    else:
        for rk in range(grid[2]):
            for rj in range(grid[1]):
                for ri in range(grid[0]):
                    boxes.append((per_dim[0][ri], per_dim[1][rj],
                                  per_dim[2][rk]))
    return boxes


def _box_nodes(lo, hi, nn):
    """Linear node indices of the inclusive box [lo, hi] on a grid nn."""
    nd = len(nn)
    axes = [np.arange(max(lo[d], 0), min(hi[d], nn[d] - 1) + 1)
            for d in range(nd)]
    if nd == 2:
        jj, ii = np.meshgrid(axes[1], axes[0], indexing="ij")
        return (ii + jj * nn[0]).ravel()
    kk, jj, ii = np.meshgrid(axes[2], axes[1], axes[0], indexing="ij")
    return (ii + jj * nn[0] + kk * nn[0] * nn[1]).ravel()


def asm_patch_dofs(mesh, nranks, overlap):
    """List (one per virtual rank) of global dof index arrays for the
    overlapping ASM patches (DMDAFEPatchCreateGlobalIS_Q2Q1)."""
    nd = mesh.ndim
    patches = []
    for box in rank_element_boxes(mesh, nranks):
        es = [box[d][0] - overlap for d in range(nd)]
        ee = [box[d][1] + overlap for d in range(nd)]   # ee exclusive + ov
        q2_lo = [2 * es[d] for d in range(nd)]
        q2_hi = [2 * ee[d] for d in range(nd)]          # inclusive
        q1_lo = es
        q1_hi = ee                                      # inclusive
        un = _box_nodes(q2_lo, q2_hi, mesh.nn_u)
        pn = _box_nodes(q1_lo, q1_hi, mesh.nn_p)
        udofs = (nd * un[:, None] + np.arange(nd)[None, :]).ravel()
        patches.append(np.concatenate([udofs, mesh.nu + pn]))
    return patches


def bjacobi_block_ranges(mesh, nranks):
    """Per-rank contiguous dof ranges in the reference's parallel global
    ordering is rank-interleaved [u_r | p_r]; in this framework's ordering
    blocks are not contiguous, so return explicit index arrays instead:
    rank r owns the u-dofs of its owned Q2 nodes + p-dofs of its owned Q1
    nodes (DMDA ownership)."""
    nd = mesh.ndim
    grid = dmda_rank_grid(nranks, mesh.nn_u)
    u_counts = [dmda_owned_counts(mesh.nn_u[d], grid[d])
                for d in range(nd)]
    # Q1 ownership is slaved to Q2 element ownership (femixedspace.c:1216-
    # 1258): rank owns Q1 nodes [es, ee) (+ last node on the last rank).
    el = [element_ranges(mesh.nn_u[d], grid[d]) for d in range(nd)]
    blocks = []

    def u_rank_nodes(ridx):
        axes = []
        for d in range(nd):
            starts = np.concatenate([[0], np.cumsum(u_counts[d])])
            axes.append(np.arange(starts[ridx[d]], starts[ridx[d] + 1]))
        return axes

    def p_rank_nodes(ridx):
        axes = []
        for d in range(nd):
            es, ee = el[d][ridx[d]]
            hi = ee + 1 if ridx[d] == grid[d] - 1 else ee
            axes.append(np.arange(es, hi))
        return axes

    ranks = ([(i, j) for j in range(grid[1]) for i in range(grid[0])]
             if nd == 2 else
             [(i, j, k) for k in range(grid[2]) for j in range(grid[1])
              for i in range(grid[0])])
    for ridx in ranks:
        ua = u_rank_nodes(ridx)
        pa = p_rank_nodes(ridx)
        if nd == 2:
            jj, ii = np.meshgrid(ua[1], ua[0], indexing="ij")
            un = (ii + jj * mesh.nn_u[0]).ravel()
            jj, ii = np.meshgrid(pa[1], pa[0], indexing="ij")
            pn = (ii + jj * mesh.nn_p[0]).ravel()
        else:
            kk, jj, ii = np.meshgrid(ua[2], ua[1], ua[0], indexing="ij")
            un = (ii + jj * mesh.nn_u[0]
                  + kk * mesh.nn_u[0] * mesh.nn_u[1]).ravel()
            kk, jj, ii = np.meshgrid(pa[2], pa[1], pa[0], indexing="ij")
            pn = (ii + jj * mesh.nn_p[0]
                  + kk * mesh.nn_p[0] * mesh.nn_p[1]).ravel()
        udofs = (nd * un[:, None] + np.arange(nd)[None, :]).ravel()
        blocks.append(np.concatenate([udofs, mesh.nu + pn]))
    return blocks
