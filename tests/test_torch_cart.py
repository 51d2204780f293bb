"""The port's cartesian runtime (exsaddle_tpu_torch/parallel/cart.py and the
collectives of parallel/shard_mesh.py) against the JAX package's
(exsaddle_tpu/parallel/cart.py) on the CPU: the per-shard-assembled element
apply on 2D, 3D and mixed device grids and with Lame, each halo and ghost
primitive on random grids (bitwise), the ownership weights, per-shard
assembly, and the fixed FGMRES cycle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map

from exsaddle_tpu.parallel import cart as jcart

from exsaddle_tpu_torch import compiled
from exsaddle_tpu_torch.assembly import assemble_element_matrices
from exsaddle_tpu_torch.operator import apply_dirichlet_elimination
from exsaddle_tpu_torch.parallel import cart, shard_mesh
from exsaddle_tpu_torch.parallel.shard_mesh import ShardMesh

from torch_parallel_common import LAME, PSEUDOICE, problems, rhs


def _setup(nd, m_el, dev_shape, args, lame=False, size=None):
    """Both packages' cartesian operators over dev_shape, and the port's
    single-device element-batched operator."""
    j, t = problems(nd, m_el, args, lame=lame, size=size)
    jctx, jmesh, _, _, jbi, _ = j
    ctx, mesh, fes, co, bi, bv = t
    jpart = jcart.CartPartition(jmesh, dev_shape)
    dmesh = jpart.device_mesh(jax.devices())
    jcop = jcart.CartOperator.build(jpart, jctx, jbi, lame=lame,
                                    dtype=jnp.float64)
    jcop = jax.tree.map(lambda a: jpart.device_put(dmesh, a)
                        if isinstance(a, jnp.ndarray) else a, jcop,
                        is_leaf=lambda a: isinstance(a, jnp.ndarray))
    part = cart.CartPartition(mesh, dev_shape)
    smesh = part.device_mesh(["cpu"] * part.ndev)
    cop = cart.CartOperator.build(part, ctx, bi, smesh, lame=lame)
    op, _, _, _ = apply_dirichlet_elimination(
        mesh, assemble_element_matrices(fes, co, lame=lame), bi, bv, "cpu")
    return (jpart, dmesh, jcop), (part, smesh, cop), op, t


# (nd, m_el, dev_shape, args, lame, size): tests/test_cart.py's cases and Lame
CASES = [(2, (4, 4), (2, 2), ["-model", "0", "-size_x", "0.1"], False,
          (0.1, 1.0)),
         (3, (2, 2, 4), (1, 2, 4), PSEUDOICE, False, (0.1, 1.0, 1.0)),
         (3, (2, 4, 2), (2, 2, 2), PSEUDOICE, False, (0.1, 1.0, 1.0)),
         (3, (2, 2, 4), (2, 1, 2), LAME, True, None)]


@pytest.mark.parametrize("nd,m_el,dev_shape,args,lame,size", CASES)
def test_cart_mult_matches_jax(nd, m_el, dev_shape, args, lame, size):
    (jpart, dmesh, jcop), (part, smesh, cop), op, _ = _setup(
        nd, m_el, dev_shape, args, lame, size)
    x = np.random.default_rng(3).standard_normal(op.ndof)
    yj = jpart.unshard_vector(jax.tree.map(np.asarray, jcart.make_cart_mult(
        dmesh, nd)(jcop, jpart.device_put(dmesh, jpart.shard_vector(x)))))
    y = part.unshard_vector(cart.make_cart_mult(smesh)(
        cop, smesh.shard(part.shard_vector(x))))
    y1 = op.mult(torch.as_tensor(x)).numpy()
    scale = np.abs(yj).max()
    assert np.abs(y - yj).max() <= 1e-12 * scale
    assert np.abs(y - y1).max() <= 1e-12 * scale


def _jax_collective(dev_shape, fn, grids):
    """fn(local grid) under shard_map over the JAX device grid; grids:
    stacked (dev..., *local) with the device axes z-major."""
    nd = len(dev_shape)
    jpart = jcart.CartPartition(_Mesh(dev_shape), dev_shape)
    dmesh = jpart.device_mesh(jax.devices())
    spec = jpart.specs()

    def body(a):
        out = fn(a.reshape(a.shape[nd:]))
        return out.reshape((1,) * nd + out.shape)
    f = jax.jit(shard_map(body, mesh=dmesh, in_specs=spec, out_specs=spec))
    return np.asarray(f(jnp.asarray(grids)))


class _Mesh:
    """The fields of a SaddleMesh a CartPartition reads, for a bare device
    grid of one element per device."""

    def __init__(self, dev_shape):
        self.ndim = len(dev_shape)
        self.m_el = tuple(dev_shape)


# (dev_shape, local grid shape with a trailing dof axis)
GRIDS = [((2, 2, 2), (4, 3, 5, 3)), ((2, 2), (3, 4, 2)),
         ((1, 2, 4), (3, 4, 2, 3))]


@pytest.mark.parametrize("dev_shape,local", GRIDS)
def test_collectives_bitwise_match_jax(dev_shape, local):
    """halo_add_axis and ghost_extend_axis along every axis, and
    halo_add_all, on random grids: bitwise the JAX ppermute exchanges."""
    nd = len(dev_shape)
    stack = tuple(reversed(dev_shape))
    g = np.random.default_rng(7).standard_normal(stack + local)
    smesh = ShardMesh(dev_shape, ["cpu"] * int(np.prod(dev_shape)))
    flat = list(g.reshape((-1,) + local))

    def port(fn):
        out = fn(smesh.shard(flat))
        return np.stack([p.numpy() for p in out.parts]).reshape(
            stack + out.parts[0].shape)

    for d in range(nd):
        k, ax = nd - 1 - d, jcart.AXES[d]
        want = _jax_collective(dev_shape,
                               lambda a: jcart.halo_add_axis(a, ax, k), g)
        got = port(lambda v: shard_mesh.halo_add_axis(smesh, v, d))
        assert np.array_equal(got, want), ("halo_add_axis", d)
        want = _jax_collective(
            dev_shape, lambda a: jcart.ghost_extend_axis(a, ax, k), g)
        got = port(lambda v: shard_mesh.ghost_extend_axis(smesh, v, d))
        assert np.array_equal(got, want), ("ghost_extend_axis", d)
    want = _jax_collective(dev_shape,
                           lambda a: jcart.halo_add_all(a, nd), g)
    assert np.array_equal(port(lambda v: cart.halo_add_all(smesh, v)), want)


@pytest.mark.parametrize("dev_shape,local", GRIDS)
def test_owned_weight_matches_jax(dev_shape, local):
    nd = len(dev_shape)
    stack = tuple(reversed(dev_shape))
    want = _jax_collective(
        dev_shape,
        lambda a: jcart.owned_weight(a.shape, nd, a.dtype) + 0 * a[..., 0],
        np.zeros(stack + local))
    smesh = ShardMesh(dev_shape, ["cpu"] * int(np.prod(dev_shape)))
    got = np.stack([shard_mesh.owned_weight(smesh, i, local)
                    for i in range(smesh.ndev)]).reshape(want.shape)
    assert np.array_equal(got, want)


def test_psum_is_ordered_and_repeatable():
    """psum adds the partials in shard order on the first shard's device
    and hands every shard the same total, the same bits every call."""
    smesh = ShardMesh((2, 2), ["cpu"] * 4)
    parts = np.random.default_rng(2).standard_normal((4, 6))
    v = smesh.shard(list(parts))
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    s = smesh.psum(v)
    for p in s.parts:
        assert np.array_equal(p.numpy(), want)
    assert all(torch.equal(a, b) for a, b in zip(smesh.psum(v).parts,
                                                 s.parts))


def test_per_shard_assembly_matches_global_and_jax():
    """assemble_local_blocks (ghost-ring local projection): the global
    element batch cut into boxes, and the JAX package's per-box blocks."""
    j, t = problems(3, (2, 2, 2), PSEUDOICE, size=(0.1, 1.0, 1.0))
    ctx, mesh, fes, co, _, _ = t
    part = cart.CartPartition(mesh, (2, 1, 2))
    local = cart.assemble_local_blocks(part, ctx)
    jlocal = jcart.assemble_local_blocks(
        jcart.CartPartition(j[1], (2, 1, 2)), j[0])
    elm = assemble_element_matrices(fes, co)
    for name in ("A11", "A12", "A22"):
        assert np.abs(local[name] - np.asarray(jlocal[name])).max() <= \
            1e-14 * max(np.abs(local[name]).max(), 1.0)
        if elm[name] is None:                      # Stokes: A22 = 0
            assert not local[name].any()
            continue
        g = np.asarray(elm[name]).reshape(tuple(reversed(mesh.m_el))
                                          + elm[name].shape[1:])
        for box in part.dev_boxes():
            sl = tuple(slice(box[d] * part.mloc[d],
                             (box[d] + 1) * part.mloc[d])
                       for d in reversed(range(3)))
            ref = g[sl].reshape((-1,) + elm[name].shape[1:])
            np.testing.assert_allclose(local[name][tuple(reversed(box))],
                                       ref, rtol=1e-12,
                                       atol=1e-13 * np.abs(ref).max())


def test_cart_fgmres_matches_jax():
    """One FGMRES(8) + Jacobi cycle over a 2x2x2 grid: the JAX package's
    distributed cycle and the port's single-device cycle to 1e-10."""
    nd, k = 3, 8
    (jpart, dmesh, jcop), (part, smesh, cop), op, t = _setup(
        nd, (2, 2, 4), (2, 2, 2), PSEUDOICE, size=(0.1, 1.0, 1.0))
    F = rhs(t, np.zeros(op.ndof))
    d = op.diagonal().numpy()
    inv = 1.0 / np.where(d == 0.0, 1.0, d)

    jput = lambda v: jpart.device_put(dmesh, jpart.shard_vector(v))
    xj, rj = jcart.make_cart_fgmres(dmesh, nd, k)(
        jcop, jput(inv), jput(F), jput(np.zeros(op.ndof)))
    xj = jpart.unshard_vector(jax.tree.map(np.asarray, xj))

    put = lambda v: smesh.shard(part.shard_vector(v))
    xs, rn = cart.make_cart_fgmres(smesh, k)(cop, put(inv), put(F),
                                             put(np.zeros(op.ndof)))
    x = part.unshard_vector(xs)
    inv_t = torch.as_tensor(inv)
    x1, r1 = compiled.make_fgmres_cycle(op.mult, lambda v: inv_t * v, k)(
        torch.as_tensor(F), torch.zeros(op.ndof, dtype=torch.float64))
    for xr, rr in ((xj, float(rj)), (x1.numpy(), float(r1))):
        assert abs(float(rn) - rr) <= 1e-10 * rr
        assert np.linalg.norm(x - xr) <= 1e-10 * np.linalg.norm(xr)
