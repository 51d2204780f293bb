"""The port's slab runtime (exsaddle_tpu_torch/parallel/slab.py) against the
JAX package's (exsaddle_tpu/parallel/slab.py) on the CPU: the sharded
element apply, its interface-plane halo add, the fixed FGMRES cycle and the
divisibility error; the JAX side runs on conftest's 8 virtual CPU devices,
the port's shards on the CPU device. Also the import boundary of the port's
parallel package."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from exsaddle_tpu.assembly import assemble_element_matrices as j_assemble
from exsaddle_tpu.compiled import make_fgmres_cycle as j_cycle
from exsaddle_tpu.operator import apply_dirichlet_elimination as j_elim
from exsaddle_tpu.parallel import slab as jslab

from exsaddle_tpu_torch.assembly import assemble_element_matrices
from exsaddle_tpu_torch.operator import apply_dirichlet_elimination
from exsaddle_tpu_torch.parallel import slab
from exsaddle_tpu_torch.parallel.shard_mesh import ShardMesh

from torch_parallel_common import problems

# (nd, m_el, lame, model, size, ndev): tests/test_parallel.py's cases
CASES = [(2, (3, 8), False, "0", None, 4),
         (3, (3, 4, 8), False, "11", (0.1, 1.0, 1.0), 8),
         (3, (2, 3, 4), True, "6", None, 2)]


def _ops(nd, m_el, lame, model, size):
    """The BC-eliminated element-batched operator of both packages (raw
    quadrature-point coefficients, as tests/test_parallel.py builds it)."""
    (jctx, jmesh, jfes, jco, jbi, jbv), (ctx, mesh, fes, co, bi, bv) = \
        problems(nd, m_el, ["-model", model], lame=lame, size=size,
                 project=False)
    jop, _, _, _ = j_elim(jmesh, j_assemble(jfes, jco, lame=lame), jbi, jbv)
    op, _, _, _ = apply_dirichlet_elimination(
        mesh, assemble_element_matrices(fes, co, lame=lame), bi, bv, "cpu")
    return jmesh, jop, mesh, op


def _jax_mesh(ndev):
    return Mesh(np.array(jax.devices()[:ndev]), (jslab.AXIS,))


@pytest.mark.parametrize("nd,m_el,lame,model,size,ndev", CASES)
def test_slab_mult_matches_jax(nd, m_el, lame, model, size, ndev):
    jmesh, jop, mesh, op = _ops(nd, m_el, lame, model, size)
    x = np.random.default_rng(0).standard_normal(mesh.ndof)

    jpart = jslab.SlabPartition(jmesh, ndev)
    dmesh = _jax_mesh(ndev)
    jsop = jpart.device_put(dmesh, jslab.SlabOperator.build(jpart, jop))
    yj = jpart.unshard_vector(jax.tree.map(np.asarray, jslab.make_dist_mult(
        dmesh)(jsop, jpart.device_put(dmesh, jpart.shard_vector(x)))))

    part = slab.SlabPartition(mesh, ndev)
    smesh = part.device_mesh(["cpu"] * ndev)
    sop = slab.SlabOperator.build(part, op, smesh)
    ys = slab.make_dist_mult(smesh)(
        sop, smesh.shard(part.shard_vector(x)))
    y = part.unshard_vector(ys)
    scale = np.abs(yj).max()
    assert np.abs(y - yj).max() <= 1e-12 * scale
    y1 = op.mult(torch.as_tensor(x)).numpy()
    assert np.abs(y - y1).max() <= 1e-12 * scale
    # both copies of every interface plane hold the assembled value
    nu_loc = int(np.prod(part.nn_u_loc)) * nd
    u = [v[:nu_loc].reshape(tuple(reversed(part.nn_u_loc)) + (nd,)).numpy()
         for v in ys.parts]
    for d in range(1, ndev):
        np.testing.assert_allclose(u[d][0], u[d - 1][-1], rtol=0,
                                   atol=1e-13 * scale)


def test_slab_halo_add_bitwise():
    """halo_add on random slab grids: bitwise the JAX ppermute pair."""
    ndev, shape = 4, (5, 3, 4, 3)
    g = np.random.default_rng(1).standard_normal((ndev,) + shape)
    f = jax.jit(shard_map(lambda a: jslab.halo_add(a[0])[None],
                          mesh=_jax_mesh(ndev), in_specs=P(jslab.AXIS),
                          out_specs=P(jslab.AXIS)))
    want = np.asarray(f(jnp.asarray(g)))
    smesh = ShardMesh((1, 1, ndev), ["cpu"] * ndev)
    got = slab.halo_add(smesh, smesh.shard(list(g)))
    for i in range(ndev):
        assert np.array_equal(got.parts[i].numpy(), want[i])


def test_slab_owned_mask_factor():
    smesh = ShardMesh((1, 4), ["cpu"] * 4)
    for i in range(4):
        w = slab.owned_mask_factor(smesh, i, 5)
        assert w.tolist() == [0.0 if i else 1.0] + [1.0] * 4


def test_dist_fgmres_matches_jax():
    """The fixed FGMRES(10) + Jacobi cycle over 8 slabs: the JAX package's
    distributed cycle and its single-device cycle to 1e-10."""
    jmesh, jop, mesh, op = _ops(3, (3, 4, 8), False, "11", (0.1, 1.0, 1.0))
    ndev, k = 8, 10
    F = np.random.default_rng(1).standard_normal(mesh.ndof)
    d = op.diagonal().numpy()
    inv = 1.0 / np.where(d == 0.0, 1.0, d)

    jpart = jslab.SlabPartition(jmesh, ndev)
    dmesh = _jax_mesh(ndev)
    put = lambda v: jpart.device_put(dmesh, jpart.shard_vector(v))
    xj, rj = jslab.make_dist_fgmres(dmesh, k)(
        jpart.device_put(dmesh, jslab.SlabOperator.build(jpart, jop)),
        put(inv), put(F), put(np.zeros(mesh.ndof)))
    xj = jpart.unshard_vector(jax.tree.map(np.asarray, xj))
    x1, r1 = jax.jit(j_cycle(jop.mult, lambda v: jnp.asarray(inv) * v, k))(
        jnp.asarray(F), jnp.zeros(mesh.ndof))

    part = slab.SlabPartition(mesh, ndev)
    smesh = part.device_mesh(["cpu"] * ndev)
    put = lambda v: smesh.shard(part.shard_vector(v))
    xs, rn = slab.make_dist_fgmres(smesh, k)(
        slab.SlabOperator.build(part, op, smesh), put(inv), put(F),
        put(np.zeros(mesh.ndof)))
    x = part.unshard_vector(xs)
    for xr, rr in ((xj, float(rj)), (np.asarray(x1), float(r1))):
        assert abs(float(rn) - rr) <= 1e-10 * rr
        assert np.abs(x - xr).max() <= 1e-10 * np.abs(xr).max()


def test_indivisible_slab_errors_like_jax():
    jmesh, _, mesh, _ = _ops(2, (3, 7), False, "0", None)
    with pytest.raises(ValueError) as je:
        jslab.SlabPartition(jmesh, 2)
    with pytest.raises(ValueError) as te:
        slab.SlabPartition(mesh, 2)
    assert str(te.value) == str(je.value)


def test_parallel_package_never_imports_jax():
    code = ("import sys, exsaddle_tpu_torch.parallel, "
            "exsaddle_tpu_torch.parallel.slab, "
            "exsaddle_tpu_torch.parallel.cart, "
            "exsaddle_tpu_torch.parallel.dist_abf, "
            "exsaddle_tpu_torch.parallel.cart_abf, "
            "exsaddle_tpu_torch.parallel.multihost, "
            "exsaddle_tpu_torch.parallel.shard_mesh;"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'exsaddle_tpu' or "
            "m.startswith('exsaddle_tpu.'));"
            "print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
