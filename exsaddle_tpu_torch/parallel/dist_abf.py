"""The ABF solve over slabs of the slowest grid axis (the port of
exsaddle_tpu/parallel/dist_abf.py).

The flagship solver (abf.py) over a 1-D device grid slicing the slowest
grid axis (z in 3D, y in 2D) into element-aligned slabs (the reference's
DMDA macro-element ownership rule, femixedspace.c:1102-1124):

  - setup is the single-device build (abf.build_abf, host numpy) cut into
    slabs: element data by element slab, node data with the interface
    plane stored on both neighbours;
  - the solve is the cartesian one (cart_abf.make_cart_abf_solver) on the
    device grid (1, ..., ndev): per-shard K1 applies, interface-plane
    halo adds, ownership-weighted psum dots, the sharded L-2 stencil level
    and the replicated deep levels and dense coarse inverse (PCREDUNDANT).
    The JAX package's slab body is that cartesian body with one axis split.

Use cart_abf.CartABFSolver for per-shard setup and other device grids."""

from dataclasses import dataclass

import numpy as np
import torch

from exsaddle_tpu_torch.abf import ABFConfig, build_abf, config_from_dict
from exsaddle_tpu_torch.grid_ops import split_u_parity
from exsaddle_tpu_torch.parallel.cart_abf import (CartABFConfig, CartBlocks,
                                                  _result,
                                                  make_cart_abf_solver,
                                                  shard_data)
from exsaddle_tpu_torch.parallel.shard_mesh import ShardMesh
from exsaddle_tpu_torch.parallel.slab import check_slabs
from exsaddle_tpu_torch.treeops import smap

AXIS = "z"


@dataclass(frozen=True)
class DistABFConfig:
    base: ABFConfig            # GLOBAL grid metadata + solver knobs
    ndev: int
    mloc: int                  # elements per device along the slab axis
    m_el_loc: tuple
    cls_shapes_loc: tuple      # local parity class shapes
    nn_p_loc: tuple            # local Q1 node counts (per axis, x first)
    lvl1_loc_shape: tuple      # local L-2 grid spatial shape (reversed)

    @property
    def dev_shape(self):
        return (1,) * (self.base.ndim - 1) + (self.ndev,)

    def cart(self):
        """The same layout as a cartesian config (device grid (1,..,ndev))."""
        return CartABFConfig(base=self.base, dev_shape=self.dev_shape,
                             mloc=self.m_el_loc,
                             cls_shapes_loc=self.cls_shapes_loc,
                             nn_p_loc=self.nn_p_loc,
                             lvl1_loc_shape=self.lvl1_loc_shape)


def dist_config_from_dict(d):
    """The port's DistABFConfig from dataclasses.asdict of the JAX one."""
    tup = lambda s: tuple(int(n) for n in s)
    return DistABFConfig(
        base=config_from_dict(d["base"]), ndev=int(d["ndev"]),
        mloc=int(d["mloc"]), m_el_loc=tup(d["m_el_loc"]),
        cls_shapes_loc=tuple(tup(s) for s in d["cls_shapes_loc"]),
        nn_p_loc=tup(d["nn_p_loc"]), lvl1_loc_shape=tup(d["lvl1_loc_shape"]))


def build_dist_abf(mesh, fes, coeff_qp, bc_idx, bc_vals, ndev, lame=False,
                   nlevels=3, cfg_kw=None):
    """Global setup (abf.build_abf, float64 on the CPU) cut into slabs.

    Returns (dcfg, ddata, setup): ddata holds host arrays laid out as the
    JAX package's (leaves that scale with the problem carry a leading
    device axis; cart_abf.shard_data places them), setup is build_abf's."""
    mloc = check_slabs(mesh, ndev)
    cfg, data, setup = build_abf(mesh, fes, coeff_qp, bc_idx, bc_vals,
                                 device="cpu", lame=lame,
                                 dtype=torch.float64, nlevels=nlevels,
                                 cfg_kw=cfg_kw)
    op = data["op"]
    nd = mesh.ndim
    nelxy = int(np.prod(mesh.m_el[:-1]))
    host = lambda t: t.numpy()

    def stack_el(a):
        """(nel, ...) -> (ndev, mloc*nelxy, ...): element slabs (elements
        are x-fastest, slab axis slowest)."""
        a = np.asarray(a)
        return a.reshape((ndev, mloc * nelxy) + a.shape[1:])

    def stack_cls(flat_u):
        """Flat parity u vector -> per-class (ndev, loc_z, ..., nd) slabs;
        classes even along z share their boundary plane (mloc+1 planes)."""
        out = []
        for p, g in enumerate(split_u_parity(flat_u, cfg.cls_shapes, nd)):
            g = host(g)
            cnt = mloc + 1 - ((p >> (nd - 1)) & 1)
            out.append(np.stack([g[d * mloc: d * mloc + cnt]
                                 for d in range(ndev)]))
        return out

    def stack_grid(g):
        """(z, ...) node grid with mz+1 planes -> (ndev, mloc+1, ...)."""
        g = np.asarray(g)
        return np.stack([g[d * mloc: d * mloc + mloc + 1]
                         for d in range(ndev)])

    ks, ms, kp, mp = data["aux"]
    ddata = {
        "scale_visc": stack_el(host(op.scale_visc)),
        "pscale": stack_el(host(data["pscale"])),
        "ks": stack_cls(ks), "ms": stack_cls(ms),
        "kp": stack_grid(host(kp)), "mp": stack_grid(host(mp)),
        "inv_diag_fine": stack_cls(data["inv_diag_fine"]),
        "inv_diag_l1": stack_grid(host(data["inv_diag_lvls"][-1])),
        "inv_diag_p": stack_grid(host(data["inv_diag_p"])),
        # sharded L-2 Galerkin block stencil, interface plane on both sides
        "W1": stack_grid(setup["stencils_w"][-1]),
        "facp_lam": (stack_el(host(op.facp_lam)) if lame
                     else np.zeros((ndev, 1, 1))),
        # replicated
        "Bs": host(op.Bs), "Dm": host(op.Dm), "Np": host(op.Np),
        "fac": host(op.fac), "coarse_inv": host(data["coarse_inv"]),
        "stencils": setup["stencils_w"][:-1],
        "inv_diag_repl": [host(d) for d in data["inv_diag_lvls"][:-1]],
        "bounds": data["bounds"],
        "p_bounds": data["p_bounds"],
    }
    cls_loc = tuple((mloc + 1 - ((p >> (nd - 1)) & 1),) + tuple(s[1:])
                    for p, s in enumerate(cfg.cls_shapes))
    lvl1_glob = cfg.level_grids[-2]
    dcfg = DistABFConfig(base=cfg, ndev=ndev, mloc=mloc,
                         m_el_loc=tuple(mesh.m_el[:-1]) + (mloc,),
                         cls_shapes_loc=cls_loc,
                         nn_p_loc=tuple(mesh.nn_p[:-1]) + (mloc + 1,),
                         lvl1_loc_shape=(mloc + 1,) + tuple(lvl1_glob[1:]))
    return dcfg, ddata, setup


def make_dist_abf_solver(dcfg, smesh):
    """solve(dd, F, x0) -> (x, its, rnorm, state, hist) over the slabs of
    `smesh`: the cartesian solver on the device grid (1, ..., ndev)."""
    return make_cart_abf_solver(dcfg.cart(), smesh)


class DistABFSolver:
    """Host-facing slab-distributed ABF: setup, placement on `devices` (one
    per slab, repeats allowed), the sharded solve."""

    def __init__(self, mesh, fes, coeff_qp, bc_idx, bc_vals, devices,
                 lame=False, nlevels=3, **cfg_kw):
        dcfg, ddata, setup = build_dist_abf(
            mesh, fes, coeff_qp, bc_idx, bc_vals, len(devices), lame=lame,
            nlevels=nlevels, cfg_kw=cfg_kw)
        self._init(mesh, dcfg, ddata, setup, devices)

    @classmethod
    def from_parts(cls, mesh, dcfg, ddata, setup, devices):
        """Solver over (dcfg, ddata, setup) built elsewhere -- e.g. the JAX
        package's DistABFSolver data brought to numpy (its dcfg through
        dist_config_from_dict; setup needs perm / iperm)."""
        self = cls.__new__(cls)
        self._init(mesh, dcfg, ddata, setup, devices)
        return self

    def _init(self, mesh, dcfg, ddata, setup, devices):
        self.mesh, self.dcfg, self.setup = mesh, dcfg, setup
        self.ndev = dcfg.ndev
        self.smesh = ShardMesh(dcfg.dev_shape, devices)
        self.ddata = shard_data(ddata, self.smesh, 1)
        self.blocks = CartBlocks(dcfg.cart(), self.smesh, self.ddata)
        self._solve = make_dist_abf_solver(dcfg, self.smesh)

    # --- vector conversions ------------------------------------------------
    def _counts(self):
        """(class, planes per slab) of the velocity parity classes: classes
        even along the slab axis hold the shared plane (mloc + 1)."""
        nd = self.mesh.ndim
        return [(p, self.dcfg.mloc + 1 - ((p >> (nd - 1)) & 1))
                for p in range(2 ** nd)]

    def shard_tree(self, t):
        """Global flat parity-layout vector -> ShardVec of the slabs' flat
        parity-layout vectors (interface planes on both neighbours)."""
        t = np.asarray(t)
        nd, mloc = self.mesh.ndim, self.dcfg.mloc
        subs = [g.numpy() for g in split_u_parity(
            torch.as_tensor(t[: self.mesh.nu]), self.dcfg.base.cls_shapes, nd)]
        pg = t[self.mesh.nu:].reshape(tuple(reversed(self.mesh.nn_p)))
        parts = []
        for d in range(self.ndev):
            parts.append(np.concatenate(
                [subs[p][d * mloc: d * mloc + cnt].reshape(-1)
                 for p, cnt in self._counts()]
                + [pg[d * mloc: d * mloc + mloc + 1].reshape(-1)]))
        return self.smesh.shard(parts)

    def unshard_tree(self, t):
        """ShardVec of slab vectors -> global flat parity-layout vector."""
        nd, mloc = self.mesh.ndim, self.dcfg.mloc
        u = torch.zeros(self.mesh.nu, dtype=torch.float64)
        glob = [g.numpy() for g in split_u_parity(
            u, self.dcfg.base.cls_shapes, nd)]
        gp = np.zeros(tuple(reversed(self.mesh.nn_p)))
        for d, v in enumerate(t.parts):
            v = v.cpu().numpy()
            off = 0
            for p, cnt in self._counts():
                sub = glob[p]
                n = cnt * int(np.prod(sub.shape[1:]))
                sub[d * mloc: d * mloc + cnt] = v[off:off + n].reshape(
                    (cnt,) + sub.shape[1:])
                off += n
            gp[d * mloc: d * mloc + mloc + 1] = v[off:].reshape(
                (mloc + 1,) + gp.shape[1:])
        return np.concatenate([u.numpy(), gp.reshape(-1)])

    def solve(self, F_flat, x0_flat=None):
        """Solve A x = F (natural-ordering host vectors). Returns dict with
        x, its, rnorm, state, reason, history."""
        perm, iperm = self.setup["perm"], self.setup["iperm"]
        Ft = self.shard_tree(np.asarray(F_flat)[perm])
        x0 = (self.shard_tree(np.asarray(x0_flat)[perm])
              if x0_flat is not None else smap(torch.zeros_like, Ft))
        x, its, rnorm, state, hist = self._solve(self.ddata, Ft, x0,
                                                 blocks=self.blocks)
        return _result(self.unshard_tree(x)[iperm], its, rnorm, state, hist)
