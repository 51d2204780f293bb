"""The PyTorch port's operator layer against the JAX package: the parity
saddle apply, the ABF block applies, the MG transfers, the block stencil,
and K1's plain version (against abf.mult_u_tree and against the Pallas
kernel itself, run in TPU interpret mode). Inputs are numpy draws from fixed
seeds handed to both packages; JAX runs on the CPU in float64 as the rest of
the suite runs it."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from exsaddle_tpu import abf as jabf
from exsaddle_tpu import driver as jdriver
from exsaddle_tpu import matfree as jmf
from exsaddle_tpu import models as jmodels
from exsaddle_tpu.assembly import FESpace as JFESpace
from exsaddle_tpu.mesh import SaddleMesh as JMesh
from exsaddle_tpu.options import Options as JOptions

from exsaddle_tpu_torch import abf as tabf
from exsaddle_tpu_torch import matfree as tmf
from exsaddle_tpu_torch.kernels import a00

# one intra-op thread: the suite runs several test processes side by
# side, and these small CPU solves gain nothing from more threads
torch.set_num_threads(1)

# (nd, m_el, lame, model, size): test_fast_apply.CASES
CASES = [(2, (5, 4), False, "0", None),
         (3, (3, 4, 2), False, "11", (0.1, 1.0, 1.0)),
         (2, (4, 4), True, "6", None),
         (3, (3, 3, 3), True, "6", None),
         (2, (1, 1), False, "0", None)]

# float64 applies: the two packages sum in different orders
TOL64 = 1e-12


def _jax_case(nd, m_el, lame, model, size):
    opts = JOptions.from_args(["-model", model])
    ctx = jmodels.ModelContext(opts, nd, lame=lame, log=lambda *a, **k: None)
    mesh = JMesh(nd, m_el, size or (1.0,) * nd)
    fes = JFESpace(mesh)
    bci, _ = jmodels.create_bc_list(ctx, mesh)
    c = jmodels.evaluate_coefficients(
        ctx, fes.qp_coords.reshape(-1, nd)).reshape(mesh.nel, fes.nqp, -1)
    coeff = jdriver._qp_dict(ctx, c)
    bc_mask = np.zeros(mesh.ndof)
    bc_mask[:mesh.nu][bci] = 1.0
    return mesh, fes, coeff, bc_mask


def _pair(case, jdtype=jnp.float64, tdtype=torch.float64):
    """(JAX parity operator, port operator) on the same numbers."""
    nd, m_el, lame, model, size = case
    mesh, fes, coeff, bc_mask = _jax_case(*case)
    jop = jmf.ParityMatFreeOperator.build(mesh, fes, coeff, bc_mask,
                                          lame=lame, dtype=jdtype)
    top = tmf.ParityMatFreeOperator.build(mesh, fes, coeff, bc_mask,
                                          lame=lame, dtype=tdtype,
                                          device="cpu")
    return mesh, fes, coeff, jop, top


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _flat(subs):
    return np.concatenate([np.asarray(s).reshape(-1) for s in subs])


@pytest.mark.parametrize("case", CASES)
def test_mult_tree_matches_jax(case):
    mesh, _, _, jop, top = _pair(case)
    x = np.random.default_rng(3).standard_normal(mesh.ndof)
    yj = jmf.from_tree(jmf.mult_tree(jop, jmf.tree_aux(jop),
                                     jmf.to_tree(jop, jnp.asarray(x))))
    yt = tmf.mult_tree(top, tmf.tree_aux(top), torch.as_tensor(x))
    assert _rel(yt.numpy(), yj) < TOL64
    # the tree views share the flat vector's numbers
    assert np.array_equal(tmf.from_tree(tmf.to_tree(top, yt)).numpy(),
                          yt.numpy())


@pytest.mark.parametrize("case", CASES)
def test_block_applies_match_jax(case):
    nd, m_el, lame, model, size = case
    mesh, fes, coeff, jop, top = _pair(case)
    rng = np.random.default_rng(4)
    xu = rng.standard_normal(mesh.nu)
    pg = rng.standard_normal(tuple(reversed(mesh.nn_p)))
    jaux, taux = jmf.tree_aux(jop), tmf.tree_aux(top)
    jsubs = jop._split_u(jnp.asarray(xu))
    txu = torch.as_tensor(xu)
    tpg = torch.as_tensor(pg)

    assert _rel(tabf.mult_u_tree(top, taux, txu).numpy(),
                _flat(jabf.mult_u_tree(jop, jaux, jsubs))) < TOL64
    assert _rel(tabf.mult_up_tree(top, taux, tpg).numpy(),
                _flat(jabf.mult_up_tree(jop, jaux, jnp.asarray(pg)))) < TOL64
    assert _rel(tabf.mult_pu_tree(top, taux, txu).numpy(),
                jabf.mult_pu_tree(jop, jaux, jsubs)) < TOL64
    inv = (1.0 / coeff["lambda"] + 1.0 / coeff["mu"]) if lame \
        else 1.0 / coeff["eta"]
    pscale = -(fes.wq[None, :] * fes.detJ_p) * inv
    assert _rel(tabf.mp_apply(top, torch.as_tensor(pscale), tpg).numpy(),
                jabf.mp_apply(jop, jnp.asarray(pscale),
                              jnp.asarray(pg))) < TOL64


@pytest.mark.parametrize("case", CASES)
def test_a00_plain_matches_jax_mult_u(case):
    """K1's plain version (the CPU side of the wrapper) against the JAX
    velocity block, with and without the Dirichlet masks."""
    mesh, _, _, jop, top = _pair(case)
    xu = np.random.default_rng(5).standard_normal(mesh.nu)
    n0 = a00.LAUNCHES.n
    yt = a00.a00_apply(top, torch.as_tensor(xu)).numpy()
    assert a00.LAUNCHES.n == n0          # the plain version is not counted
    ones = [jnp.ones_like(s) for s in jop._split_u(jnp.asarray(xu))]
    jaux_nomask = (ones, [0 * s for s in ones], None, None)
    yj = _flat(jabf.mult_u_tree(jop, jaux_nomask,
                                jop._split_u(jnp.asarray(xu))))
    assert _rel(yt, yj) < TOL64


@pytest.mark.parametrize("case", CASES)
def test_transfers_match_jax(case):
    nd, m_el = case[0], case[1]
    mesh, _, _, jop, top = _pair(case)
    rng = np.random.default_rng(6)
    xc = rng.standard_normal(tuple(m + 1 for m in reversed(m_el)) + (nd,))
    xf = rng.standard_normal(mesh.nu)
    cls = jop.cls_shapes
    assert np.array_equal(
        tabf.prolong_parity(torch.as_tensor(xc), cls, m_el).numpy(),
        _flat(jabf.prolong_parity(jnp.asarray(xc), cls, m_el)))
    assert _rel(tabf.restrict_parity(torch.as_tensor(xf), cls, m_el).numpy(),
                jabf.restrict_parity(jop._split_u(jnp.asarray(xf)), cls,
                                     m_el)) < TOL64
    # plain node-grid transfers, (M+1)/2 coarsening of the velocity grid
    fine = tuple(reversed(mesh.nn_u))
    coarse = tuple((n + 1) // 2 for n in fine)
    yc = rng.standard_normal(coarse + (nd,))
    yf = rng.standard_normal(fine + (nd,))
    assert np.array_equal(
        tabf.prolong_grid(torch.as_tensor(yc), fine).numpy(),
        np.asarray(jabf.prolong_grid(jnp.asarray(yc), fine)))
    assert _rel(tabf.restrict_grid(torch.as_tensor(yf), coarse).numpy(),
                jabf.restrict_grid(jnp.asarray(yf), coarse)) < TOL64


@pytest.mark.parametrize("grid", [(5, 4), (3, 4, 5)])
def test_stencil_apply_matches_jax(grid):
    nd = len(grid)
    rng = np.random.default_rng(7)
    W = rng.standard_normal(grid + (3 ** nd, nd, nd))
    x = rng.standard_normal(grid + (nd,))
    assert _rel(tabf.stencil_apply(torch.as_tensor(W),
                                   torch.as_tensor(x)).numpy(),
                jabf.stencil_apply(jnp.asarray(W), jnp.asarray(x))) < TOL64


def test_a00_plain_matches_pallas_kernel():
    """K1's plain version against the TPU kernel it replaces
    (pallas_apply.make_pallas_mult_u), run in TPU interpret mode on the CPU:
    float32, 1e-5 relative (float32 summation order,
    test_fast_apply.py:165)."""
    from jax.experimental.pallas import tpu as pltpu
    from exsaddle_tpu.pallas_apply import make_pallas_mult_u
    case = (3, (4, 3, 5), False, "11", (0.1, 1.0, 1.0))
    mesh, _, _, jop, top = _pair(case, jnp.float32, torch.float32)
    x = np.random.default_rng(3).standard_normal(mesh.nu).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        pm = make_pallas_mult_u(jop)
        yj = _flat(pm(jop._split_u(jnp.asarray(x))))
    yt = a00.a00_apply(top, torch.as_tensor(x)).numpy()
    assert _rel(yt, yj) < 1e-5


def test_a00_wrapper_refuses_other_devices():
    case = CASES[1]
    mesh, _, _, _, top = _pair(case)
    x = torch.zeros(mesh.nu, device="meta", dtype=torch.float64)
    with pytest.raises(ValueError, match="unsupported device"):
        a00.a00_apply(top, x)
