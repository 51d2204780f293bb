"""K1's factored element products on the CPU (kernels/a00.py,
matfree.strain_factors).

Every 3D operator holds the one-axis 3x3 factors of its strain matrix Bs,
taken from the float64 Bs it was built from, and K1's element kernel
computes ((x_e Bs^T) * s_e) Bs from them by sum factorization: the factors
rebuild Bs to 1e-13 of max |Bs| on every 3D case of test_torch_gpu.CASES
(the thin pseudoice box and 3D Lame among them), the float32 operators
and those built from the JAX package's float32 numbers hold them too, no
operator has factors in 2D or with a Bs off that form by 1e-8, the
kernel's launch check refuses a 3D operator without them, and the plain
PyTorch version of the factored products, in the kernel's contraction
order, matches the dense plain apply within the tolerances the card's
kernel is held to (test_torch_gpu.TOL). The card's own kernel is tested
in test_torch_gpu.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from exsaddle_tpu_torch import graphs
from exsaddle_tpu_torch import matfree as tmf
from exsaddle_tpu_torch.kernels import a00
from exsaddle_tpu_torch.parallel.cart import CartPartition
from exsaddle_tpu_torch.parallel.cart_abf import CartABFSolver

from test_torch_gpu import CASES, TOL, _operator, _problem
from torch_parallel_common import problems

CASES_3D = [c for c in CASES if c[0] == 3]
CASES_2D = [c for c in CASES if c[0] == 2]


def _case_id(case):
    nd, m_el, lame, model, _ = case
    return f"{nd}d_{'x'.join(map(str, m_el))}_model{model}" + (
        "_lame" if lame else "")


def _rebuilt_bs(F):
    """Bs from factors F (3, 2, 3, 3): dN_i/dx_a = D_a (x) N_b (x) N_c as
    Kronecker products over (z, y, x), q = qx + 3 qy + 9 qz and
    i = lx + 3 ly + 9 lz, through the strain rows of _strain_matrix."""
    G = np.empty((27, 3, 27))
    for a in range(3):
        f = [F[b, int(b == a)] for b in range(3)]
        G[:, a, :] = np.kron(f[2], np.kron(f[1], f[0]))
    return tmf._strain_matrix(G, 3, 27)[0]


@pytest.mark.parametrize("case", CASES_3D, ids=_case_id)
def test_factors_rebuild_bs(case):
    """The float64 operator's factors rebuild its Bs to 1e-13 of max |Bs|;
    the float32 operator holds the same float64 factors (from the float64
    Bs it was cast from); both a C-ordered numpy array on the host, whose
    pointer K1's launch passes (a device read would sync inside a graph
    capture)."""
    op = _operator(case, torch.float64, "cpu")
    F = op.factors
    assert isinstance(F, np.ndarray) and F.dtype == np.float64
    assert F.shape == (3, 2, 3, 3) and F.flags.c_contiguous
    Bs = op.Bs.numpy()
    assert np.abs(_rebuilt_bs(F) - Bs).max() <= 1e-13 * np.abs(Bs).max()
    # the basis values at the Gauss points: each row sums to 1
    assert np.allclose(F[:, 0].sum(-1), 1.0, rtol=0, atol=1e-14)
    op32 = _operator(case, torch.float32, "cpu")
    assert np.array_equal(op32.factors, F)


@pytest.mark.parametrize("kind", ["2d", "2d_lame", "perturbed",
                                  "float32_bs"])
def test_no_factors_where_bs_does_not_factor(kind):
    """No factors in 2D (the dense kernel, chosen by the operator), nor
    for a 3D Bs with one entry off by 1e-8 of max |Bs|, nor for a Bs that
    is not float64."""
    if kind.startswith("2d"):
        op = _operator(CASES_2D[kind == "2d_lame"], torch.float64, "cpu")
        assert op.factors is None
        return
    Bs = _operator(CASES_3D[0], torch.float64, "cpu").Bs.numpy()
    assert tmf.strain_factors(Bs) is not None
    if kind == "perturbed":
        bad = Bs.copy()
        bad[40, 17] += 1e-8 * np.abs(Bs).max()
        assert tmf.strain_factors(bad) is None
    else:
        assert tmf.strain_factors(Bs.astype(np.float32)) is None


@pytest.mark.parametrize("case", CASES_3D, ids=_case_id)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_factored_products_match_plain(case, dtype):
    """a00_factored_plain (the factored products in the kernel's order)
    against the dense a00_apply_plain, within the card kernel's tolerance
    of max |y|; on the CPU a00_apply stays the dense plain version and
    counts no apply."""
    op = _operator(case, dtype, "cpu")
    x = torch.as_tensor(np.random.default_rng(8).standard_normal(op.nu),
                        dtype=dtype)
    yp = a00.a00_apply_plain(op, x)
    yf = a00.a00_factored_plain(op, x)
    assert float((yf - yp).abs().max()) <= TOL[dtype] * float(
        yp.abs().max())
    n0 = (a00.LAUNCHES.applies, a00.LAUNCHES.factored)
    assert torch.equal(a00.a00_apply(op, x), yp)
    assert (a00.LAUNCHES.applies, a00.LAUNCHES.factored) == n0


@pytest.mark.parametrize("value", [0, 7])
def test_factored_count_is_a_graph_counter(value):
    """a00.factored is one of graphs' counters: named, read and set back,
    so a graph replay adds the factored applies its capture made."""
    saved = graphs._counters()
    try:
        a00.LAUNCHES.factored = value
        vals = graphs._counters()
        names = graphs._counter_names()
        assert len(names) == len(vals)
        assert dict(zip(names, vals))["a00.factored"] == value
        a00.LAUNCHES.factored = -1
        graphs._set_counters(vals)
        assert a00.LAUNCHES.factored == value
    finally:
        graphs._set_counters(saved)


@pytest.mark.parametrize("dev_shape", [(1, 2, 2)])
def test_cart_shards_hold_the_factors(dev_shape):
    """The cart path's per-shard operators (float64) hold the whole mesh's
    factors, so each shard's K1 apply takes the factored products."""
    _, t = problems(3, (8, 8, 8), ["-model", "11", "-size_x", "0.1"],
                    size=(0.1, 1.0, 1.0))
    part = CartPartition(t[1], dev_shape)
    slv = CartABFSolver(part, t[0], *t[4:], ["cpu"] * 4, nlevels=4,
                        loop="plain")
    whole = tmf.ParityMatFreeOperator.build(
        t[1], t[2], t[3], np.zeros(t[1].ndof), device="cpu",
        dtype=torch.float64)
    for op in slv.blocks.ops.parts:
        assert op.factors is not None
        assert np.array_equal(op.factors, whole.factors)


@pytest.mark.parametrize("how", ["from_matfree", "float64_matfree",
                                 "bs64"])
def test_every_3d_operator_takes_factors_from_a_float64_bs(how):
    """from_arrays given a float32 Bs with bs64, the float64 Bs it was
    rounded from (as abf.data_from_numpy passes the JAX build's float64
    operator beside its float32 one), holds the factors of bs64; so does
    from_matfree of a float64 MatFreeSaddleOperator. A float32
    MatFreeSaddleOperator holds no float64 Bs, so its parity operator has
    none, and K1's launch check refuses it (the dense 3D kernel is gone)."""
    case = CASES_3D[0]
    ref = _operator(case, torch.float64, "cpu")
    nd, m_el, lame, model, size = case
    mesh, fes, coeff, bc_mask = _problem(case)
    if how == "bs64":
        fd = tmf.factored_host(mesh, fes, coeff, lame=lame)
        op = tmf.ParityMatFreeOperator.from_arrays(
            fd["Bs"].astype(np.float32), fd["Dm"], fd["Np"], fd["scale"],
            fd["fac"], fd["facp_lam"], 1.0 - bc_mask, bc_mask, mesh,
            dtype=torch.float32, device="cpu",
            bs64=fd["Bs"])
        assert np.array_equal(op.factors, ref.factors)
        return
    dtype = torch.float64 if how == "float64_matfree" else torch.float32
    mf = tmf.MatFreeSaddleOperator.build(mesh, fes, coeff, bc_mask,
                                         lame=lame, dtype=dtype,
                                         device="cpu")
    op = tmf.ParityMatFreeOperator.from_matfree(mf, mesh)
    x = torch.zeros(op.nu, dtype=dtype)
    if dtype == torch.float64:
        assert np.array_equal(op.factors, ref.factors)
        a00._check(op, x)
    else:
        assert op.factors is None
        with pytest.raises(ValueError, match="one-axis factors"):
            a00._check(op, x)


@pytest.mark.parametrize("bad", ["none", "float32", "shape"])
def test_launch_check_refuses_3d_without_float64_factors(bad):
    """K1's launch check refuses a 3D operator whose factors are absent,
    not float64 or not (3, 2, 3, 3): the 3D kernel reads 54 doubles
    through their pointer. A 2D operator needs none."""
    op = _operator(CASES_3D[0], torch.float64, "cpu")
    x = torch.zeros(op.nu, dtype=torch.float64)
    a00._check(op, x)
    F = {"none": None, "float32": op.factors.astype(np.float32),
         "shape": op.factors.reshape(6, 3, 3)}[bad]
    with pytest.raises(ValueError, match="one-axis factors"):
        a00._check(dataclasses.replace(op, factors=F), x)
    op2 = _operator(CASES_2D[0], torch.float64, "cpu")
    a00._check(op2, torch.zeros(op2.nu, dtype=torch.float64))


def test_data_from_numpy_operators_hold_the_factors():
    """abf.data_from_numpy over the JAX package's build (mx=4 pseudoice,
    its float32 operator beside its float64 one): the port's float32 and
    float64 operators both hold the factors of the float64 Bs, those of
    the port's own build."""
    import jax
    import jax.numpy as jnp
    from exsaddle_tpu import abf as jabf
    from exsaddle_tpu_torch import abf as tabf
    j, t = problems(3, (4, 4, 4), ["-model", "11", "-size_x", "0.1"],
                    size=(0.1, 1.0, 1.0))
    jslv = jabf.ABFSolver(*j[1:], nlevels=3, dtype=jnp.float32)
    assert np.asarray(jslv.data["op"].Bs).dtype == np.float32
    own = tmf.ParityMatFreeOperator.build(
        t[1], t[2], t[3], np.zeros(t[1].ndof), device="cpu",
        dtype=torch.float64)
    for dtype in (torch.float32, torch.float64):
        _, data, setup = tabf.data_from_numpy(
            dataclasses.asdict(jslv.cfg), jax.device_get(jslv.data),
            jax.device_get(jslv.setup), "cpu", dtype)
        assert data["op"].Bs.dtype == dtype
        for op in (data["op"], setup["op64"]):
            assert np.array_equal(op.factors, own.factors)
