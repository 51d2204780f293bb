"""The port's slab-distributed ABF solve (exsaddle_tpu_torch/parallel/
dist_abf.py) against the JAX package's (exsaddle_tpu/parallel/dist_abf.py)
on the CPU: 8 slabs in 3D, 2 in 2D, 4 with Lame (tests/test_dist_abf.py's
device counts; the 3D case is SolCx on 2x2x8 elements, which converges in
a few iterations, so the port's eight CPU shards stay cheap). The same
iteration count and reason, the monitor history and x to 1e-10; the slab
data equal to the JAX ddata to 1e-14, and a solve from the JAX ddata
itself."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from exsaddle_tpu.parallel.dist_abf import DistABFSolver as JDistABFSolver

from exsaddle_tpu_torch.parallel.dist_abf import (DistABFSolver,
                                                  build_dist_abf,
                                                  dist_config_from_dict)

from torch_parallel_common import LAME, assert_same_solve, problems, rhs

# (ndim, m_el, args, lame, size, ndev)
CASES = {"3d_8": (3, (2, 2, 8), ["-model", "0"], False, None, 8),
         "2d_2": (2, (8, 8), ["-model", "0"], False, (1.0, 0.1), 2),
         "lame_4": (3, (4, 4, 4), LAME, True, None, 4)}


@pytest.fixture(scope="module", params=sorted(CASES))
def solved(request):
    """Both packages' slab solvers on one case and their solves of the
    driver's right-hand side."""
    nd, m_el, args, lame, size, ndev = CASES[request.param]
    j, t = problems(nd, m_el, args, lame=lame, size=size)
    jslv = JDistABFSolver(*j[1:], jax.devices()[:ndev], lame=lame,
                          dtype=jnp.float64, nlevels=3)
    F = rhs(t, jslv.setup["rhs_diri"])
    slv = DistABFSolver(*t[1:], ["cpu"] * ndev, lame=lame, nlevels=3)
    return j, t, ndev, lame, jslv, slv, F, jslv.solve(F), slv.solve(F)


def test_dist_abf_matches_jax(solved):
    *_, rj, rt = solved
    assert_same_solve(rt, rj)


def test_dist_abf_data_matches_jax(solved):
    """build_dist_abf's slabs against the JAX ddata, key by key."""
    j, t, ndev, lame, jslv, *_ = solved
    _, ddata, _ = build_dist_abf(*t[1:], ndev, lame=lame, nlevels=3)
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


def test_dist_abf_solves_from_jax_data(solved):
    """The JAX solver's own ddata and config, placed on the port's shards,
    give the JAX solve: the solve in isolation from the setup."""
    j, t, ndev, lame, jslv, slv, F, rj, _ = solved
    perm = {k: np.asarray(jslv.setup[k]) for k in ("perm", "iperm")}
    port = DistABFSolver.from_parts(
        t[1], dist_config_from_dict(dataclasses.asdict(jslv.dcfg)),
        jax.device_get(jslv.ddata), perm, ["cpu"] * ndev)
    assert_same_solve(port.solve(F), rj)


def test_slab_vectors_round_trip(solved):
    *_, slv, F, _, _ = solved
    perm = slv.setup["perm"]
    t = np.asarray(F)[perm]
    assert np.array_equal(slv.unshard_tree(slv.shard_tree(t)), t)


def test_indivisible_slabs_error():
    _, t = problems(2, (3, 7), ["-model", "0"])
    with pytest.raises(ValueError, match="not divisible by 2 devices"):
        build_dist_abf(*t[1:], 2)
