"""The port's cartesian ABF solve (exsaddle_tpu_torch/parallel/cart_abf.py)
against the JAX package's (exsaddle_tpu/parallel/cart_abf.py) on the CPU:
the sinker on 4x4x4 elements over a 1x2x2 device grid, 2D SolCx over 2x2,
3D Lame over 2x2x2 (models that converge in a few iterations, so the port's
CPU shards stay cheap; chip_smoke.py's cart phase runs the pseudoice
flagship). The same iteration count and reason, the monitor
history and x to 1e-10; the per-shard setup data equal to the JAX ddata to
1e-14, and a solve from the JAX ddata itself; the sharded applies (K1 per
shard: its plain version on the CPU) equal the single-device ones."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exsaddle_tpu.parallel.cart import CartPartition as JCartPartition
from exsaddle_tpu.parallel.cart_abf import CartABFSolver as JCartABFSolver

from exsaddle_tpu_torch.abf import ABFSolver, mult_u_tree
from exsaddle_tpu_torch.kernels.a00 import node_gather_table
from exsaddle_tpu_torch.parallel.cart import CartPartition
from exsaddle_tpu_torch.parallel.cart_abf import (CartABFSolver,
                                                  build_cart_abf,
                                                  cart_config_from_dict)

from torch_parallel_common import (LAME, PSEUDOICE, assert_same_solve,
                                   problems, rhs)

# (ndim, m_el, dev_shape, args, lame, size)
CASES = {"sinker_122": (3, (4, 4, 4), (1, 2, 2), ["-model", "2"], False,
                        None),
         "solcx_2d_22": (2, (8, 8), (2, 2), ["-model", "0"], False,
                         (1.0, 0.1)),
         "lame_222": (3, (4, 4, 8), (2, 2, 2), LAME, True, None)}


@pytest.fixture(scope="module", params=sorted(CASES))
def solved(request):
    """Both packages' cartesian solvers on one case, the port's
    single-device solver, and the solves of the driver's right-hand side."""
    nd, m_el, dev_shape, args, lame, size = CASES[request.param]
    j, t = problems(nd, m_el, args, lame=lame, size=size)
    ndev = int(np.prod(dev_shape))
    jslv = JCartABFSolver(JCartPartition(j[1], dev_shape), j[0], *j[4:],
                          jax.devices()[:ndev], lame=lame,
                          dtype=jnp.float64, nlevels=3)
    single = ABFSolver(*t[1:], device="cpu", lame=lame, nlevels=3)
    F = rhs(t, single.setup["rhs_diri"])
    slv = CartABFSolver(CartPartition(t[1], dev_shape), t[0], *t[4:],
                        ["cpu"] * ndev, lame=lame, nlevels=3)
    return t, dev_shape, lame, jslv, single, slv, F, jslv.solve(F), \
        slv.solve(F)


def test_cart_abf_matches_jax(solved):
    *_, rj, rt = solved
    assert_same_solve(rt, rj)


def test_cart_abf_data_matches_jax(solved):
    """build_cart_abf's per-shard data against the JAX ddata, key by key,
    and the setup's rhs_diri against the single-device build's."""
    t, dev_shape, lame, jslv, single, *_ = solved
    _, ddata, setup = build_cart_abf(CartPartition(t[1], dev_shape), t[0],
                                     *t[4:], lame=lame, nlevels=3)
    jdd = jax.device_get(jslv.ddata)
    assert sorted(ddata) == sorted(jdd)
    for key, v in ddata.items():
        a, b = jax.tree.leaves(v), jax.tree.leaves(jdd[key])
        assert len(a) == len(b), key
        for x, y in zip(a, b):
            x, y = np.asarray(x), np.asarray(y)
            assert x.shape == y.shape, key
            assert np.abs(x - y).max(initial=0.0) <= 1e-14 * max(
                np.abs(y).max(initial=0.0), 1e-300), key
    ref = single.setup["rhs_diri"]
    assert np.abs(setup["rhs_diri"] - ref).max() <= 1e-12 * np.abs(ref).max()


def test_cart_abf_solves_from_jax_data(solved):
    """The JAX solver's own ddata and config on the port's shards: the JAX
    solve, the solve isolated from the setup."""
    t, dev_shape, lame, jslv, _, _, F, rj, _ = solved
    port = CartABFSolver.from_parts(
        CartPartition(t[1], dev_shape),
        cart_config_from_dict(dataclasses.asdict(jslv.dcfg)),
        jax.device_get(jslv.ddata), {}, ["cpu"] * int(np.prod(dev_shape)))
    assert_same_solve(port.solve(F), rj)


def test_sharded_applies_match_single_device(solved):
    """The sharded mult_tree and A00 apply (K1 once per shard, then the
    interface halos) against the single-device parity applies, to 1e-12."""
    t, _, _, _, single, slv, *_ = solved
    mesh = t[1]
    blk = slv.blocks
    perm, iperm = single.setup["perm"], single.setup["iperm"]
    op, aux = single.data["op"], single.data["aux"]
    x = np.random.default_rng(4).standard_normal(mesh.ndof)
    y1 = single.tree_to_vec(op.mult(torch.as_tensor(x[perm])))
    y = slv.unshard_saddle(blk.saddle_mult(slv.shard_saddle(x)))
    assert np.abs(y - y1).max() <= 1e-12 * np.abs(y1).max()
    xu = np.concatenate([x[: mesh.nu], np.zeros(mesh.np_)])
    yu1 = single.tree_to_vec(torch.cat([
        mult_u_tree(op, aux, torch.as_tensor(xu[perm])[: op.nu]),
        torch.zeros(op.np_, dtype=torch.float64)]))
    xs = slv.shard_saddle(xu)
    yu = blk.fine_mult(xs.map(lambda v, o: v[: o.nu], blk.ops))
    yu = slv.unshard_saddle(yu.map(
        lambda v, o: torch.cat([v, v.new_zeros(o.np_)]), blk.ops))
    assert np.abs(yu - yu1).max() <= 1e-12 * np.abs(yu1).max()


def test_shards_share_one_node_table(solved):
    """K1's node table is built once per box shape and device: every shard
    on the CPU holds the same tensor, the table of the local box."""
    slv = solved[5]
    tables = [op.node_table for op in slv.blocks.ops.parts]
    assert all(tb is tables[0] for tb in tables)
    assert np.array_equal(tables[0].numpy(),
                          node_gather_table(slv.dcfg.mloc))


def test_setup_is_per_shard():
    """Per-shard element data only: (nel / ndev) elements per shard, in
    the factored form (nqp * ncomp scale columns), never a global batch."""
    _, t = problems(3, (4, 4, 8), PSEUDOICE, size=(0.1, 1.0, 1.0))
    part = CartPartition(t[1], (1, 2, 4))
    _, ddata, _ = build_cart_abf(part, t[0], *t[4:], nlevels=3)
    nel_loc = t[1].nel // 8
    assert ddata["scale_visc"].shape == (4, 2, 1, nel_loc, 27 * 6)
    assert ddata["pscale"].shape == (4, 2, 1, nel_loc, 27)


def test_two_mg_levels_fail_as_in_jax():
    """The cartesian path needs three MG levels: both packages refuse two
    with the same assertion."""
    j, t = problems(2, (4, 4), ["-model", "0"])
    with pytest.raises(AssertionError) as je:
        JCartABFSolver(JCartPartition(j[1], (2, 2)), j[0], *j[4:],
                       jax.devices()[:4], nlevels=2)
    with pytest.raises(AssertionError) as te:
        CartABFSolver(CartPartition(t[1], (2, 2)), t[0], *t[4:],
                      ["cpu"] * 4, nlevels=2)
    assert str(te.value) == str(je.value)
