"""The node gather of K1's two-pass design, on the CPU: the ELL table that
the card's second pass reads (kernels/a00.py:node_gather_table), summed in
plain PyTorch in table order, against grid_ops.scatter_u_parity; every
(element, local column) pair in the table exactly once; the operator's
copy of the table; and the two passes together against K1's plain
version."""

import numpy as np
import pytest
import torch

from exsaddle_tpu_torch import driver as tdriver
from exsaddle_tpu_torch import matfree as tmf
from exsaddle_tpu_torch import models as tmodels
from exsaddle_tpu_torch.assembly import FESpace
from exsaddle_tpu_torch.grid_ops import gather_u_parity, scatter_u_parity
from exsaddle_tpu_torch.kernels import a00
from exsaddle_tpu_torch.mesh import SaddleMesh
from exsaddle_tpu_torch.options import Options

torch.set_num_threads(1)

# (nd, m_el, lame, model, size): tests/test_torch_gpu.py CASES
CASES = [(2, (5, 4), False, "0", None),
         (3, (3, 4, 2), False, "11", (0.1, 1.0, 1.0)),
         (2, (4, 4), True, "6", None),
         (3, (3, 3, 3), True, "6", None),
         (2, (1, 1), False, "0", None),
         (3, (5, 7, 3), False, "11", (0.1, 1.0, 1.0))]
IDS = ["x".join(map(str, c[1])) + ("-lame" if c[2] else "") for c in CASES]


def _cls_shapes(m_el):
    return tmf._parity_classes(tuple(2 * m + 1 for m in m_el))[1]


def node_gather_plain(ye, table, nd):
    """What the card's node gather computes: ye (nel, 3^nd * nd) element
    results -> the flat parity-permuted u vector, each dof's contributions
    summed in table order."""
    flat = ye.reshape(-1)
    table = torch.as_tensor(table, device=ye.device).long()
    y = torch.zeros(table.shape[0], nd, dtype=ye.dtype, device=ye.device)
    comp = torch.arange(nd, device=ye.device)
    for s in range(table.shape[1]):
        col = table[:, s]
        real = (col >= 0)[:, None]
        vals = flat[(col.clamp(min=0)[:, None] + comp)]
        y = torch.where(real, y + vals, y)
    return y.reshape(-1)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_node_gather_matches_scatter(case):
    """The table-ordered sum of a random float64 Ye equals the slice-add
    scatter to 1e-14 relative (both add local node by local node)."""
    nd, m_el = case[0], case[1]
    nel = int(np.prod(m_el))
    ye = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (nel, 3 ** nd * nd)))
    table = a00.node_gather_table(m_el)
    y = node_gather_plain(ye, table, nd)
    ref = scatter_u_parity(ye, m_el, _cls_shapes(m_el))
    assert y.shape == ref.shape
    assert float((y - ref).abs().max()) <= 1e-14 * float(ref.abs().max())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_node_gather_table_holds_each_pair_once(case):
    """Each real entry is e * ncol + nd * li for one (element, local node)
    pair, every pair appears exactly once, real entries come first in a row
    and ascend in li, and the row count is the number of velocity nodes."""
    nd, m_el = case[0], case[1]
    nel = int(np.prod(m_el))
    ncol = 3 ** nd * nd
    table = a00.node_gather_table(m_el)
    assert table.dtype == np.int32
    assert table.shape == (int(np.prod([2 * m + 1 for m in m_el])), 2 ** nd)
    real = table >= 0
    assert np.array_equal(np.sort(table[real]), nd * np.arange(nel * 3 ** nd))
    # padding only at the end of a row
    assert np.all(real[:, :-1] | ~real[:, 1:])
    li = (table % ncol) // nd
    assert np.all((np.diff(li, axis=1) > 0) | ~real[:, 1:])
    # the table's row of a node is the node the gather map sends it to
    idx = torch.arange(table.shape[0] * nd)
    subs = [idx[o * nd:(o + int(np.prod(s))) * nd].view(tuple(s) + (nd,))
            for o, s in zip(np.cumsum([0] + [int(np.prod(s)) for s in
                                             _cls_shapes(m_el)[:-1]]),
                            _cls_shapes(m_el))]
    dofs = gather_u_parity(subs, m_el).numpy()          # (nel, ncol)
    e, s = np.nonzero(real)
    ent = table[e, s]
    assert np.array_equal(dofs.reshape(-1)[ent], nd * e)


def _operator(case):
    nd, m_el, lame, model, size = case
    opts = Options.from_args(["-model", model])
    ctx = tmodels.ModelContext(opts, nd, lame=lame, log=lambda *a, **k: None)
    mesh = SaddleMesh(nd, m_el, size or (1.0,) * nd)
    fes = FESpace(mesh)
    bci, _ = tmodels.create_bc_list(ctx, mesh)
    coeff = tdriver.fine_coefficients(ctx, fes)
    bc_mask = np.zeros(mesh.ndof)
    bc_mask[:mesh.nu][bci] = 1.0
    return tmf.ParityMatFreeOperator.build(mesh, fes, coeff, bc_mask,
                                           lame=lame, dtype=torch.float64,
                                           device="cpu")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_two_passes_match_plain_apply(case):
    """Element products then the table-ordered node gather (the card's two
    launches, in plain PyTorch) equal a00_apply_plain bit for bit."""
    op = _operator(case)
    nd = len(op.m_el)
    x = torch.as_tensor(np.random.default_rng(8).standard_normal(op.nu))
    xe = gather_u_parity(op.split_u(x), op.m_el)
    ye = ((xe @ op.Bs.T) * op.scale_visc) @ op.Bs
    y = node_gather_plain(ye, op.node_table, nd)
    assert torch.equal(y, a00.a00_apply_plain(op, x))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_operator_holds_node_table(case):
    """The operator builds its table once, on its own device, equal to
    node_gather_table of its element counts."""
    op = _operator(case)
    table = op.node_table
    assert table is op.node_table
    assert table.device == op.Bs.device and table.dtype == torch.int32
    assert np.array_equal(table.numpy(), a00.node_gather_table(op.m_el))
