"""K7, the Gram-Schmidt kernels' plain twins (exsaddle_tpu_torch/kernels/
gram_schmidt.py) on the CPU, where the solvers run them:

- the twins against the float64 masked products of the window's live rows
  (dots, combinations, sum of squares, the scaled row), every dot past the
  live count an exact +0, the count given L;
- the live count read from a tensor, so the twins read nothing back;
- gs_rows, the rows a solve's Gram-Schmidt read, equal to the rows the
  sliced host loop (window=False) reads;
- the wrappers refuse a device that is neither the CPU nor CUDA.

The card tests (tests/test_torch_gpu.py) hold the kernels bit for bit
against these twins. Every input is made from a numpy seed; each test
states its tolerance."""

import numpy as np
import pytest
import torch

from exsaddle_tpu_torch import abf as tabf
from exsaddle_tpu_torch import bench, graphs, treeops
from exsaddle_tpu_torch.kernels import gram_schmidt as gs

torch.set_num_threads(1)

DT = {"f32": torch.float32, "f64": torch.float64}

# (window rows, S and s given (GCR) or V only (FGMRES), weighted (a sharded
# part's ownership weight), plus: L = live + plus)
FORMS = {"gcr": (30, True, False, 0), "fgmres": (31, False, False, 1),
         "gcr_weighted": (30, True, True, 0),
         "fgmres_weighted": (31, False, True, 1)}

# the longest chain of roundings in the twins' blocked sums at these sizes:
# ITEMS + 5 shuffle steps + WARPS + the partials' lanes + 5, and the
# product's own rounding, is under 32; so a sum is within 32 eps of the sum
# of its terms' magnitudes
CHAIN = 32


def _inputs(n, rows, dtype, seed, with_s, weighted):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype)  # noqa: E731
    V, v = t(rng.standard_normal((rows, n))), t(rng.standard_normal(n))
    S = t(rng.standard_normal((rows, n))) if with_s else None
    s = t(rng.standard_normal(n)) if with_s else None
    w = t(rng.integers(0, 2, n)) if weighted else None
    return V, S, v, s, w


@pytest.mark.parametrize("L", ["0", "1", "5", "rows-1", "rows"])
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("dt", list(DT))
def test_twins_match_float64_masked_products(dt, form, L):
    """The three twins at 2,500 entries (three blocks of 1,024) against the
    float64 products of the window's first L rows: the dots within CHAIN
    eps of sum |V_ji w_i t_i|, exactly +0 past L; v' and s' within
    2 (L + 2) eps of |v_i| + sum_j |h_j V_ji| (the twin's own h); the sum
    of squares within CHAIN eps of itself; alpha within 2 eps, the new row
    v' / alpha within 4 eps of |v'| / alpha; the count gets L; the other
    rows of V and S are untouched."""
    rows, with_s, weighted, plus = FORMS[form]
    L = {"0": 0, "1": 1, "5": 5, "rows-1": rows - 1, "rows": rows}[L]
    dtype, eps = DT[dt], torch.finfo(DT[dt]).eps
    n = 2500
    V, S, v, s, w = _inputs(n, rows, dtype, 7 + L, with_s, weighted)
    V0, S0 = V.clone(), None if S is None else S.clone()
    live = torch.tensor([L - plus], dtype=torch.int32)
    ix = torch.tensor([min(L, rows - 1)], dtype=torch.int64)
    count = torch.zeros(1, dtype=torch.int64)
    d = lambda a: a.double()  # noqa: E731
    tw = d(v) if w is None else d(w) * d(v)

    h = gs.dots(V, v, live, plus, None, w, count)
    assert int(count) == L
    ref = d(V[:L]) @ tw
    bound = CHAIN * eps * (d(V[:L]).abs() @ tw.abs())
    assert torch.all((d(h[:L]) - ref).abs() <= bound)
    assert torch.equal(h[L:].view(torch.int64 if dt == "f64"
                                  else torch.int32),
                       torch.zeros(rows - L, dtype=torch.int64 if dt == "f64"
                                   else torch.int32))

    vo, so, sq = gs.combine(V, h, v, live, plus, None, S, s, w)
    hd = d(h[:L])
    for out, base, win in ((vo, v, V), (so, s, S)):
        if win is None:
            assert out is None
            continue
        ref = d(base) - hd @ d(win[:L])
        scale = d(base).abs() + hd.abs() @ d(win[:L]).abs()
        assert torch.all((d(out) - ref).abs() <= 2 * (L + 2) * eps * scale)
    terms = d(vo) * d(vo) if w is None else d(w) * d(vo) * d(vo)
    assert abs(float(sq) - float(terms.sum())) <= \
        CHAIN * eps * float(terms.sum())

    vo1 = vo.clone()
    alpha = gs.normalize(vo, sq, V, ix, S, so, in_place=S is not None)
    a_ref = float(d(sq).sqrt())
    assert abs(float(alpha) - a_ref) <= 2 * eps * a_ref
    row = int(ix)
    want = d(vo1) / a_ref
    assert torch.all((d(V[row]) - want).abs() <= 4 * eps * want.abs())
    keep = [j for j in range(rows) if j != row]
    assert torch.equal(V[keep], V0[keep])
    if S is not None:
        assert torch.equal(S[keep], S0[keep])
        assert torch.equal(vo, V[row]) and torch.equal(so, S[row])
    else:
        assert torch.equal(vo, vo1)


def test_twins_zero_norm_keeps_a_zero_row():
    """v in the span of the live rows exactly (v = V_0, h = (||V_0||^2, 0,
    ...) with V_0 of one nonzero entry 1): v' is 0, alpha 0, and the new
    row 0 / _safe(0) = 0, as treeops' whole-window form gave."""
    V = torch.zeros(30, 50, dtype=torch.float64)
    V[0, 3] = 1.0
    v = V[0].clone()
    live = torch.tensor([1], dtype=torch.int32)
    h = gs.dots(V, v, live, 0)
    vo, _, sq = gs.combine(V, h, v, live, 0)
    alpha = gs.normalize(vo, sq, V, torch.tensor([1]), in_place=False)
    assert float(h[0]) == 1.0 and float(sq) == 0.0 and float(alpha) == 0.0
    assert torch.equal(V[1], torch.zeros(50, dtype=torch.float64))


def test_wrappers_refuse_other_devices():
    """A tensor on a device that is neither the CPU nor CUDA raises."""
    V = torch.zeros(3, 4, device="meta")
    live = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        gs.dots(V, V[0], live, 0)
    with pytest.raises(ValueError, match="unsupported device meta"):
        gs.combine(V, V[:, 0], V[0], live, 0)
    with pytest.raises(ValueError, match="unsupported device meta"):
        gs.normalize(V[0], V[0, 0], V, live.long())


def test_shared_count_slot():
    """Control.shared_slot gives one slot per name, made at the first
    request; a GCR and an FGMRES on one Control count gs_rows in it."""
    ctl = graphs.Control("cpu")
    assert ctl.count_slots("a") == 0
    assert ctl.shared_slot("b") == 1 == ctl.shared_slot("b")
    assert ctl.count_names == ["a", "b"]
    ctl = graphs.Control("cpu")
    gcr = treeops.DeviceGCR(ctl, None, None, 8, torch.float64, "cpu")
    fg = treeops.DeviceFGMRES(ctl, None, lambda vin, zout: [], 8,
                              torch.float64, "cpu")
    assert ctl.count_names.count("gs_rows") == 1
    assert gcr.gs_rows.data_ptr() == fg.gs_rows.data_ptr()


def test_gs_rows_counts_the_rows_the_sliced_host_loop_reads():
    """A float64 device-loop solve (pseudoice mx=4, 3 levels, abf.opts:
    GCR in the fieldsplit PC) on the CPU: its gs_rows is the number of
    window rows that the sliced host loop over the same setup
    (window=False: GCR projects against V[:nv], FGMRES against V[:it + 1])
    hands its dots, at the same iteration count."""
    p = bench._build_problem(4, with_rhs=True)
    slv = tabf.ABFSolver(p["mesh"], p["fes"], p["coeff"], p["bc_idx"],
                         p["bc_vals"], device="cpu", nlevels=3,
                         loop="device")
    F = p["F_raw"] + slv.setup["rhs_diri"]
    rd = slv.solve(F)
    rows = []

    def bdots(V, t):
        rows.append(V.shape[0])
        return V @ t

    b = tabf._plain_bodies(slv.cfg, slv.data)
    b["dots_u"] = b["dots_sad"] = (treeops.tdot, bdots)
    solve, _ = tabf.host_solver(slv.cfg, b, window=False)
    Ft = slv.vec_to_tree(F)
    _, its, _, _, _ = solve(Ft, torch.zeros_like(Ft))
    assert its == rd["its"] > 0
    c = rd["counts"]
    assert c["gcr_steps"] > c["gcr_solves"] > 0
    assert sum(rows) == c["gs_rows"] > 0
