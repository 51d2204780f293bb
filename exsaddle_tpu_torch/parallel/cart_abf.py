"""The FULL ABF solve over a cartesian N-D device grid, with PER-SHARD setup
(the port of exsaddle_tpu/parallel/cart_abf.py).

The flagship solver (abf.py: FGMRES / fieldsplit-Schur-UPPER /
GCR+Galerkin-MG / Chebyshev) over a (px, py[, pz]) device grid -- the
reference's DMDA decomposition (femixedspace.c:1154-1161):

  - interface node planes are stored on both neighbours along every
    decomposed axis; element gathers need no communication;
  - after element scatters, interface partial sums are exchanged one axis
    at a time (shard_mesh.halo_add_axis);
  - Gram-Schmidt dots weight duplicated planes by the product of per-axis
    ownership weights and sum over all shards with the mesh's psum
    (treeops.make_dots);
  - MG: the fine level (K1 per shard, kernels/a00.py) and the Galerkin L-2
    level (a block stencil with one ghost plane per decomposed axis) smooth
    on shards; deeper levels and the dense coarse inverse are REPLICATED
    (PCREDUNDANT, Makefile:276): the L-2 residual is summed into the full
    L-2 grid with ownership weights, and the coarse work runs once per
    distinct device;
  - setup is PER-SHARD (femixedspace.c:2306-2647 per-rank assembly): each
    box assembles only its own elements; the small replicated quantities
    (Galerkin L-2 matrix, deep stencils, coarse inverse, Schur mass matrix)
    are accumulated box by box -- and, with a multihost.HostComm, summed
    across processes.

Each process drives the shards of its own devices (shard_mesh.py); in a
torch.distributed group the halos, psums and the L-2 gather cross processes
and give the one-process bits. Per-shard vectors are the port's flat
parity-layout tensors of the local box: the local velocity parity classes
one after another, then the local pressure grid. Setup is host numpy and
returns stacked arrays laid out as the JAX package's ddata (leading device
axes, z-major); shard_data places this process's shards on its devices."""

import copy
import logging
import threading
from dataclasses import dataclass

import numpy as np
import torch

from exsaddle_tpu_torch import graphs, treeops
from exsaddle_tpu_torch.abf import (ABFConfig, config_from_dict,
                                    mp_apply, mp_csr, mp_stencil, mult_u_raw,
                                    mult_u_tree, mult_up_tree,
                                    stencil_from_csr, _esteig_bounds)
from exsaddle_tpu_torch.kernels import cheb, peer, stencil, transfer
from exsaddle_tpu_torch.kernels._build import Launches
from exsaddle_tpu_torch.kernels.a00 import node_gather_table
from exsaddle_tpu_torch.matfree import (ParityMatFreeOperator, mult_tree,
                                        strain_factors, tree_aux)
from exsaddle_tpu_torch.parallel.cart import ghost_ring_coefficients
from exsaddle_tpu_torch.parallel.shard_mesh import (DTYPE, CardMesh,
                                                    ghost_extend,
                                                    halo_add_axes,
                                                    halo_add_axis,
                                                    owned_weight,
                                                    stack_boxes)
from exsaddle_tpu_torch.trace import span
from exsaddle_tpu_torch.treeops import ShardVec, smap

_LOG = logging.getLogger(__name__)


# --------------------------------------------------------------------------
# host-side helpers
# --------------------------------------------------------------------------

def split_grid_parity(g, nd):
    """Node-grid array (reversed spatial dims + trailing) -> 2^nd parity
    subgrids. Local boxes start at even global node indices (macro-element
    alignment), so local parity == global parity."""
    subs = []
    for p in range(2 ** nd):
        idx = tuple(slice((p >> (nd - 1 - k)) & 1, None, 2)
                    for k in range(nd))
        subs.append(g[idx])
    return subs


def _local_cls_shapes(mloc, nd):
    """Per-class local parity shapes (reversed dims): axis d contributes
    mloc[d]+1 nodes for even parity (shared planes), mloc[d] for odd."""
    shapes = []
    for p in range(2 ** nd):
        shapes.append(tuple(mloc[nd - 1 - k] + 1 - ((p >> (nd - 1 - k)) & 1)
                            for k in range(nd)))
    return tuple(shapes)


def local_element_partials(mesh, el_ids, sv, bc_idx):
    """Partial operators from ONE host's element rows (O(local) data).

    Returns (u_apply, rhs_rows):
      u_apply(v): the BC-masked A00 contribution of these elements --
        keep * scatter(Bs^T diag(sv_e) Bs gather(keep*v)); summing the
        partials over hosts and adding bc*v reproduces the global
        eliminated velocity apply (the distributed fine esteig probe).
      rhs_rows(x): the raw A11/A21 rows of these elements applied to a
        full saddle vector with zero pressure part (the rhs_diri
        partial; femixedspace.c:2634-2643)."""
    from exsaddle_tpu_torch.assembly import FESpace
    from exsaddle_tpu_torch.matfree import _strain_matrix
    nd = mesh.ndim
    fes_g = FESpace(mesh)
    G0 = fes_g.dNu_glob[0]
    Bs, _ = _strain_matrix(G0, nd, mesh.u_basis)
    fac = fes_g.wq * float(fes_g.detJ_u[0, 0])
    Dm = np.zeros((fes_g.nqp, nd * mesh.u_basis))
    for a in range(nd):
        Dm[:, a::nd] = G0[:, a, :]
    Np = np.asarray(fes_g.Np)
    nu = mesh.nu
    bc_u = np.zeros(nu)
    bc_u[np.asarray(bc_idx)] = 1.0
    keep_u = 1.0 - bc_u
    ue = np.asarray(mesh.u_el_dofs)[el_ids]
    pe = np.asarray(mesh.p_el_nodes)[el_ids]
    uef = ue.ravel()
    pef = pe.ravel()

    def u_apply(v):
        xe = (keep_u * np.asarray(v))[ue]
        yue = ((xe @ Bs.T) * sv) @ Bs
        return keep_u * np.bincount(uef, weights=yue.ravel(), minlength=nu)

    def rhs_rows(x):
        x = np.asarray(x)
        xe = x[:nu][ue]
        yue = ((xe @ Bs.T) * sv) @ Bs
        div = xe @ Dm.T
        ype = -(div * fac[None, :]) @ Np
        out = np.zeros(mesh.ndof)
        out[:nu] = np.bincount(uef, weights=yue.ravel(), minlength=nu)
        out[nu:] = np.bincount(pef, weights=ype.ravel(),
                               minlength=mesh.np_)
        return out

    return u_apply, rhs_rows


@dataclass(frozen=True)
class CartABFConfig:
    base: ABFConfig          # global grid metadata + solver knobs
    dev_shape: tuple         # devices per grid dimension (px, py[, pz])
    mloc: tuple              # local elements per dimension
    cls_shapes_loc: tuple
    nn_p_loc: tuple          # local Q1 node counts (x first)
    lvl1_loc_shape: tuple    # local L-2 spatial shape (reversed)


def cart_config_from_dict(d):
    """The port's CartABFConfig from dataclasses.asdict of the JAX one."""
    tup = lambda s: tuple(int(n) for n in s)
    return CartABFConfig(
        base=config_from_dict(d["base"]), dev_shape=tup(d["dev_shape"]),
        mloc=tup(d["mloc"]),
        cls_shapes_loc=tuple(tup(s) for s in d["cls_shapes_loc"]),
        nn_p_loc=tup(d["nn_p_loc"]), lvl1_loc_shape=tup(d["lvl1_loc_shape"]))


def assemble_host_local(part, ctx, bc_idx, P_f, grids, lame=False,
                        boxes=None):
    """Per-box (per-rank) assembly over `boxes` (default: every box).

    The host-local leg of setup: each process of a multi-host run calls it
    with its OWN boxes (multihost.local_boxes) and all-reduces the returned
    accumulations -- PETSc's MatAssemblyBegin/End stash exchange
    (femixedspace.c:2624-2625). The sum of per-host partials equals the
    single-shot assembly (all contributions are disjoint element sums).

    Returns dict with: diag_u, dmp (node-sized, additive over boxes),
    A1 (L-2 Galerkin), Mp, the device-stacked sv_stack / ps_stack /
    fl_stack (only these boxes filled -- placement, not a sum), the
    O(local) element rows el_ids_loc / sv_loc, and the element bracket
    p_elbounds of the Schur p-block spectrum."""
    import scipy.sparse as sp
    from exsaddle_tpu_torch.abf import p_spectrum_bounds
    from exsaddle_tpu_torch.assembly import (FESpace,
                                             assemble_element_matrices,
                                             assemble_schur_pre)
    from exsaddle_tpu_torch.matfree import _strain_matrix
    from exsaddle_tpu_torch.mesh import SaddleMesh

    mesh = part.mesh
    nd = mesh.ndim
    mloc = part.mloc
    nel_loc = part.nel_loc
    stack = part._stack_shape()
    cell = [s / m for s, m in zip(mesh.size, mesh.m_el)]

    nu = mesh.nu
    n1 = int(np.prod(grids[-2])) * nd
    diag_u = np.zeros(nu)
    A1_acc = sp.csr_matrix((n1, n1))
    Mp_acc = sp.csr_matrix((mesh.np_, mesh.np_))
    dmp = np.zeros(mesh.np_)
    nqp_f = 27 if nd == 3 else 9
    el_ids_loc = []
    sv_loc = []

    sv_stack = None
    # running element-eigenvalue bracket of D^-1 Mpscaled: min/max compose
    # exactly over boxes and hosts
    p_lo, p_hi = np.inf, -np.inf
    ps_stack = np.zeros(stack + (nel_loc, nqp_f))
    # A22 factored weights (Lame only); a (1, 1) zero block per device for
    # Stokes (matfree's lame sentinel)
    fl_stack = (np.zeros(stack + (nel_loc, nqp_f)) if lame
                else np.zeros(stack + (1, 1)))

    el_grid = np.arange(mesh.nel).reshape(tuple(reversed(mesh.m_el)))
    bc = np.zeros(mesh.ndof)
    bc[np.asarray(bc_idx)] = 1.0

    for box in (part.dev_boxes() if boxes is None else boxes):
        dev_idx = tuple(reversed(box))
        e0 = [box[d] * mloc[d] for d in range(nd)]
        # ghost-ring-extended coefficient projection (exact vs global)
        _, coeff_ext, owned = ghost_ring_coefficients(part, ctx, box)
        coeff = {k: owned(v) for k, v in coeff_ext.items()}

        # local factored operator data
        lmesh = SaddleMesh(nd, mloc,
                           tuple(cell[d] * mloc[d] for d in range(nd)))
        lfes = FESpace(lmesh)
        G0 = lfes.dNu_glob[0]
        detJ0 = float(lfes.detJ_u[0, 0])
        Bs, wc = _strain_matrix(G0, nd, lmesh.u_basis)
        fac = lfes.wq * detJ0
        visc = coeff["mu"] if lame else coeff["eta"]
        sv = (fac[None, :, None] * visc[:, :, None]
              * wc[None, None, :]).reshape(nel_loc, -1)   # FLAT (nel,nqpc)
        if sv_stack is None:
            sv_stack = np.zeros(stack + sv.shape)
        sv_stack[dev_idx] = sv
        if lame:
            inv = 1.0 / coeff["lambda"] + 1.0 / coeff["mu"]
            fl_stack[dev_idx] = ((lfes.wq[None, :] * lfes.detJ_p)
                                 / coeff["lambda"])
        else:
            inv = 1.0 / coeff["eta"]
        ps_stack[dev_idx] = -(lfes.wq[None, :] * lfes.detJ_p) * inv

        el_ids = el_grid[tuple(
            slice(e0[d], e0[d] + mloc[d])
            for d in reversed(range(nd)))].reshape(-1)
        el_ids_loc.append(el_ids)
        sv_loc.append(sv)

        # the transient local element batch, (nel_loc, nud, nud): the only
        # element-matrix assembly
        elm = assemble_element_matrices(lfes, coeff, lame=lame)
        A11 = np.asarray(elm["A11"])
        assert A11.shape[0] == nel_loc == mesh.nel // part.ndev

        udofs = mesh.u_el_dofs[el_ids]                  # (nel_loc, nud)
        ku = (1.0 - bc[: nu])[udofs]
        A11k = A11 * ku[:, :, None]
        A11k *= ku[:, None, :]
        np.add.at(diag_u, udofs.ravel(),
                  np.einsum("eii->ei", A11k).ravel())

        rows = np.broadcast_to(udofs[:, :, None], A11k.shape).ravel()
        cols = np.broadcast_to(udofs[:, None, :], A11k.shape).ravel()
        A_box = sp.coo_matrix((A11k.ravel(), (rows, cols)),
                              shape=(nu, nu)).tocsr()
        A1_acc = A1_acc + (P_f.T @ (A_box @ P_f)).tocsr()

        Sel = np.asarray(assemble_schur_pre(lfes, coeff, lame=lame))
        blo, bhi = p_spectrum_bounds(Sel)
        p_lo, p_hi = min(p_lo, blo), max(p_hi, bhi)
        pnod = mesh.p_el_nodes[el_ids]
        np.add.at(dmp, pnod.ravel(), np.einsum("eii->ei", Sel).ravel())
        prows = np.broadcast_to(pnod[:, :, None], Sel.shape).ravel()
        pcols = np.broadcast_to(pnod[:, None, :], Sel.shape).ravel()
        Mp_acc = Mp_acc + sp.coo_matrix(
            (Sel.ravel(), (prows, pcols)),
            shape=(mesh.np_, mesh.np_)).tocsr()
    ncomp = nd + nd * (nd - 1) // 2
    if sv_stack is None:          # empty `boxes`: true flat scale shape
        sv_stack = np.zeros(stack + (nel_loc, nqp_f * ncomp))
    el_ids_loc = (np.concatenate(el_ids_loc) if el_ids_loc
                  else np.zeros((0,), np.int64))
    sv_loc = (np.concatenate(sv_loc) if sv_loc
              else np.zeros((0, nqp_f * ncomp)))
    return {"diag_u": diag_u, "A1": A1_acc, "Mp": Mp_acc, "dmp": dmp,
            "sv_stack": sv_stack, "ps_stack": ps_stack,
            "fl_stack": fl_stack,
            "el_ids_loc": el_ids_loc, "sv_loc": sv_loc,
            "p_elbounds": np.array([p_lo, p_hi])}


def build_cart_abf(part, ctx, bc_idx, bc_vals, lame=False, nlevels=3,
                   cfg_kw=None, multihost=None):
    """Per-shard setup over a CartPartition (host numpy, float64).

    Per device box: ghost-ring coefficient projection, factored operator
    slabs, transient (nel_loc, nud, nud) element batch for the fine Jacobi
    diagonal + Galerkin/Schur contributions. Global accumulations (L-2
    Galerkin matrix, Mp, diagonals) stand in for the reference's
    MatAssembly stash exchange (femixedspace.c:2624-2625).

    multihost: optional multihost.HostComm. When given, this process
    assembles ONLY its own element boxes (multihost.local_boxes) and the
    additive setup partials are summed across processes -- sparse partials
    (A1, Mp) ride as their dense block-stencil form, whose shape does not
    depend on the host.

    Returns (dcfg, ddata, setup); ddata holds host arrays, laid out as the
    JAX package's (per-shard arrays with leading stacked device axes)."""
    import scipy.sparse as sp
    from exsaddle_tpu_torch.abf import (csr_from_stencil,
                                        p_spectrum_bounds_assembled)
    from exsaddle_tpu_torch.assembly import FESpace
    from exsaddle_tpu_torch.matfree import _strain_matrix
    from exsaddle_tpu_torch.mesh import SaddleMesh
    from exsaddle_tpu_torch.precond_mg import (Prolongation,
                                               galerkin_coarse_operators)

    assert nlevels >= 3, "cartesian ABF needs >= 3 MG levels"
    mesh = part.mesh
    nd = mesh.ndim
    mloc = part.mloc
    stack = part._stack_shape()
    cell = [s / m for s, m in zip(mesh.size, mesh.m_el)]

    # velocity-grid hierarchy (fine -> coarse), DMDA (M+1)/2 coarsening
    grids = [tuple(mesh.nn_u)]
    for _ in range(nlevels - 1):
        grids.append(tuple((m + 1) // 2 for m in grids[-1]))
    grids = grids[::-1]
    for g in grids:
        assert all(n >= 2 for n in g), "too many MG levels for this mesh"
    lvl_grids = [tuple(reversed(g)) for g in grids]
    # L-2 node grid == element-corner grid: local boxes need mloc nodes
    # per axis plus the shared plane
    assert grids[-2] == tuple(m + 1 for m in mesh.m_el), (
        "cartesian ABF assumes one coarsening step lands on the element "
        "corner grid")

    # fine -> L-2 interpolation (global CSR, setup only)
    P_f = Prolongation(grids[-2], grids[-1], nd).to_scipy()

    if multihost is not None:
        from exsaddle_tpu_torch.parallel.multihost import local_boxes
        boxes = local_boxes(part, multihost.process_id, multihost.n_hosts)
        acc = assemble_host_local(part, ctx, bc_idx, P_f, grids,
                                  lame=lame, boxes=boxes)
        # additive allreduce of the per-host partials; every box is
        # written by exactly one host, so the dense sums are exact. True
        # SUM reductions are node-sized only (diag_u, dmp; the stencil
        # forms and the rhs / esteig vectors below)
        red = multihost.allreduce_dense
        for key in ("diag_u", "dmp"):
            acc[key] = red(acc[key], key)
        # the device-stacked element slabs are per-shard PLACEMENT
        for key in ("sv_stack", "ps_stack", "fl_stack"):
            acc[key] = multihost.place_shards(acc[key], key)
        # the spectrum bracket reduces by min/max, not sum
        acc["p_elbounds"] = multihost.allreduce_minmax(acc["p_elbounds"])
        W1p = stencil_from_csr(acc["A1"], lvl_grids[-2], nd)
        acc["A1"] = csr_from_stencil(red(W1p, "A1_stencil"),
                                     lvl_grids[-2], nd)
        Mpp = stencil_from_csr(acc["Mp"], tuple(reversed(mesh.nn_p)), 1)
        acc["Mp"] = csr_from_stencil(red(Mpp, "Mp_stencil"),
                                     tuple(reversed(mesh.nn_p)), 1)
    else:
        acc = assemble_host_local(part, ctx, bc_idx, P_f, grids, lame=lame)
    diag_u = acc["diag_u"]
    A1_acc = acc["A1"]
    Mp_acc = acc["Mp"]
    dmp = acc["dmp"]
    nu = mesh.nu

    bc = np.zeros(mesh.ndof)
    bc[np.asarray(bc_idx)] = 1.0
    diag_u = np.where(bc[:nu] == 1.0, 1.0, diag_u)
    diag_u = np.where(diag_u == 0.0, 1.0, diag_u)
    # the eliminated A00 carries a unit diagonal on BC rows
    # (MatZeroRowsColumns diag=1.0, femixedspace.c:2645); the Galerkin
    # chain must see it exactly like build_abf's assembled A00 does
    A1_acc = (A1_acc + P_f.T @ sp.diags(bc[:nu]) @ P_f).tocsr()

    # replicated hierarchy below L-2
    prolongs = [Prolongation(grids[k], grids[k + 1], nd)
                for k in range(nlevels - 2)]        # up to the L-2 grid
    coarse_csrs = galerkin_coarse_operators(A1_acc, prolongs)
    level_mats = coarse_csrs + [A1_acc]             # levels 0 .. nlev-2

    # esteig per smoothed level (coarsest+1 .. fine), PETSc transform
    diags, bounds = [], []
    for k in range(1, nlevels - 1):
        A = level_mats[k]
        d = A.diagonal()
        d = np.where(d == 0.0, 1.0, d)
        apply_fn = (lambda v, A=A: A @ np.asarray(v))
        emin, emax = _esteig_bounds(apply_fn, d, A.shape[0])
        diags.append(d)
        bounds.append((emin, emax))

    # fine level esteig through the distributed factored apply: this
    # process contributes only its own element rows; the partials sum
    # across hosts with one O(nu) vector allreduce per application
    fes_g = FESpace(mesh)
    Bs_g, wc = _strain_matrix(fes_g.dNu_glob[0], nd, mesh.u_basis)
    fac_g = fes_g.wq * float(fes_g.detJ_u[0, 0])
    keep_u = 1.0 - bc[:nu]
    u_partial, rhs_partial = local_element_partials(
        mesh, acc["el_ids_loc"], acc["sv_loc"], bc_idx)
    bc_u = bc[:nu]

    def fine_apply(v):
        v = np.asarray(v)
        if multihost is not None:
            y = multihost.apply_partial_sum(v, u_partial, "fine_esteig")
        else:
            y = u_partial(v)
        return y + bc_u * v

    emin_f, emax_f = _esteig_bounds(fine_apply, diag_u, nu)
    bounds.append((emin_f, emax_f))
    diags.append(diag_u)

    A0 = level_mats[0].toarray()
    coarse_inv = np.linalg.inv(A0)
    stencils = [stencil_from_csr(coarse_csrs[k], lvl_grids[k], nd)
                for k in range(1, nlevels - 2)]
    # the L-2 Galerkin level as a SHARDED block stencil: mloc+1 planes per
    # axis per device, interface planes redundant
    W1 = stencil_from_csr(A1_acc, lvl_grids[-2], nd)

    # Schur p-block spectrum (build_abf semantics): dense-exact on small
    # problems, deterministic Lanczos + the box-accumulated element bracket
    p_emin, p_emax = p_spectrum_bounds_assembled(Mp_acc, dmp,
                                                 acc["p_elbounds"])

    # --- shard the node-grid quantities ---
    def shard_u_parity(vec_u):
        """(nu,) natural -> per-class stacked local parity subgrids."""
        g = np.asarray(vec_u).reshape(tuple(reversed(mesh.nn_u)) + (nd,))
        outs = [np.empty(stack + s + (nd,), g.dtype)
                for s in _local_cls_shapes(mloc, nd)]
        for box in part.dev_boxes():
            dev_idx = tuple(reversed(box))
            loc = g[part._grid_slices(box, 2, (slice(None),))]
            for p, sub in enumerate(split_grid_parity(loc, nd)):
                outs[p][dev_idx] = sub
        return outs

    def shard_p(vec_p):
        g = np.asarray(vec_p).reshape(tuple(reversed(mesh.nn_p)))
        out = np.empty(stack + tuple(reversed(part.nn_p_loc)), g.dtype)
        for box in part.dev_boxes():
            out[tuple(reversed(box))] = g[part._grid_slices(box, 1, ())]
        return out

    def shard_l1_grid(W):
        """L-2 node-grid array with trailing dims -> stacked local boxes,
        interface planes redundant."""
        loc_shape = tuple(mloc[nd - 1 - k] + 1 for k in range(nd))
        out = np.empty(stack + loc_shape + W.shape[nd:], W.dtype)
        for box in part.dev_boxes():
            sl = tuple(slice(box[d] * mloc[d],
                             box[d] * mloc[d] + mloc[d] + 1)
                       for d in reversed(range(nd)))
            out[tuple(reversed(box))] = W[sl]
        return out

    lfes0 = FESpace(SaddleMesh(nd, mloc,
                               tuple(cell[d] * mloc[d] for d in range(nd))))
    # divergence sampling matrix (matfree.factored_host)
    G0g = fes_g.dNu_glob[0]
    Dm_mat = np.zeros((fes_g.nqp, nd * mesh.u_basis))
    for a in range(nd):
        Dm_mat[:, a::nd] = G0g[:, a, :]
    ddata = {
        "scale_visc": acc["sv_stack"],
        "pscale": acc["ps_stack"],
        "facp_lam": acc["fl_stack"],
        "ks": shard_u_parity(keep_u),
        "ms": shard_u_parity(bc[:nu]),
        "kp": shard_p(1.0 - bc[nu:]),
        "mp": shard_p(bc[nu:]),
        "inv_diag_fine": shard_u_parity(1.0 / diag_u),
        "inv_diag_l1": shard_l1_grid(
            (1.0 / diags[-2]).reshape(lvl_grids[-2] + (nd,))),
        "inv_diag_p": shard_p(1.0 / dmp),
        "W1": shard_l1_grid(W1),
        # replicated
        "Bs": Bs_g, "Dm": Dm_mat, "Np": np.asarray(lfes0.Np), "fac": fac_g,
        "coarse_inv": coarse_inv,
        "stencils": stencils,
        "inv_diag_repl": [(1.0 / diags[k - 1]).reshape(lvl_grids[k] + (nd,))
                          for k in range(1, nlevels - 2)],
        "bounds": bounds,
        "p_bounds": (p_emin, p_emax),
    }

    cfgb = ABFConfig(ndim=nd, nlevels=nlevels,
                     cls_shapes=_local_cls_shapes(tuple(mesh.m_el), nd),
                     m_el=tuple(mesh.m_el), level_grids=tuple(lvl_grids),
                     **(cfg_kw or {}))
    dcfg = CartABFConfig(base=cfgb, dev_shape=part.dev_shape, mloc=mloc,
                         cls_shapes_loc=_local_cls_shapes(mloc, nd),
                         nn_p_loc=part.nn_p_loc,
                         lvl1_loc_shape=tuple(
                             mloc[nd - 1 - k] + 1 for k in range(nd)))

    # rhs_diri = -A x_bc with BC rows zeroed, accumulated the same way A1
    # is: per-host element rows + ONE dense O(ndof) allreduce
    # (femixedspace.c:2634-2643; x_bc has zero pressure part so only the
    # A11/A21 rows contribute)
    x_bc = np.zeros(mesh.ndof)
    x_bc[np.asarray(bc_idx)] = np.asarray(bc_vals)
    if multihost is not None:
        rows = multihost.apply_partial_sum(x_bc, rhs_partial, "rhs_diri")
    else:
        rows = rhs_partial(x_bc)
    rhs_diri = -rows * (1 - bc)

    setup = {"mesh": mesh, "rhs_diri": rhs_diri, "bc_mask": bc,
             "A1": A1_acc, "Mp": Mp_acc, "diag_u": diag_u,
             "coarse_csrs": coarse_csrs}
    return dcfg, ddata, setup


# --------------------------------------------------------------------------
# placement: stacked host data -> per-shard tensors
# --------------------------------------------------------------------------

_SHARDED = {"scale_visc", "pscale", "facp_lam", "ks", "ms", "kp", "mp",
            "inv_diag_fine", "inv_diag_l1", "inv_diag_p", "W1"}


def shard_data(ddata, smesh, nstack):
    """Place a ddata dict of host arrays (the port's build_cart_abf /
    dist_abf.build_dist_abf output, or the JAX package's ddata brought to
    numpy with jax.device_get) on the mesh's devices: this process's shards
    only.

    nstack: the number of leading device axes of the sharded arrays (the
    grid's ndim for the cartesian layout, 1 for slabs). Sharded entries
    become ShardVecs -- the per-class velocity arrays one flat local
    parity-layout vector per shard; replicated ones are held once per
    distinct device under "repl" (device -> dict); the Chebyshev bounds
    become float64 numpy scalars, as abf._device_data keeps them."""

    def per_shard(a):
        a = np.asarray(a)
        return list(a.reshape((smesh.ndev,) + a.shape[nstack:]))

    dd = {}
    for key in _SHARDED:
        v = ddata[key]
        if isinstance(v, (list, tuple)):        # per-class velocity data
            parts = [np.concatenate([c.reshape(-1) for c in cls])
                     for cls in zip(*[per_shard(c) for c in v])]
        else:
            parts = per_shard(v)
        dd[key] = smesh.shard(parts)

    def cast(a, dev):
        return torch.as_tensor(np.require(a, requirements="CW"),
                               dtype=DTYPE, device=dev)
    factors = strain_factors(ddata["Bs"])
    dd["repl"] = {dev: {
        "Bs": cast(ddata["Bs"], dev), "Dm": cast(ddata["Dm"], dev),
        "Np": cast(ddata["Np"], dev), "fac": cast(ddata["fac"], dev),
        "factors": factors,
        "coarse_inv": cast(ddata["coarse_inv"], dev),
        "stencils": [cast(W, dev) for W in ddata["stencils"]],
        "inv_diag_repl": [cast(d, dev) for d in ddata["inv_diag_repl"]]}
        for dev in smesh.distinct}
    f64 = lambda b: np.float64(np.asarray(b))
    dd["bounds"] = [(f64(b0), f64(b1)) for b0, b1 in ddata["bounds"]]
    dd["p_bounds"] = tuple(f64(b) for b in ddata["p_bounds"])
    return dd


def card_data(dd, i):
    """Shard i's share of placed data `dd` (shard_data): its part of every
    sharded entry (a ShardVec of one part) and its device's replicated
    entries; nothing copied."""
    dev = dd["ks"].parts[i].device
    out = {k: ShardVec([v.parts[i]]) if isinstance(v, ShardVec) else v
           for k, v in dd.items()}
    out["repl"] = {dev: dd["repl"][dev]}
    return out


# --------------------------------------------------------------------------
# the sharded solver
# --------------------------------------------------------------------------

# what the solve asks its mesh to exchange, per call of this process's
# blocks (per card on the cards' path), whatever the mesh makes of it:
# halo_u (K1's interface planes, every axis), halo_p (a pressure grid's),
# halo_r (the L-2 slab the fine residual restricts to), ghost extensions
# of an L-2 slab (every axis) and L-2 gathers. Python counts, tracked by
# graphs so that a graph replay or a device-loop execution adds what its
# capture made.
HALOS_U, HALOS_P, HALOS_R, GHOSTS, L2_GATHERS = (
    Launches(), Launches(), Launches(), Launches(), Launches())
EXCHANGES = (("halo_u", HALOS_U), ("halo_p", HALOS_P), ("halo_r", HALOS_R),
             ("ghosts", GHOSTS), ("l2_gathers", L2_GATHERS))
for _, _c in EXCHANGES:
    graphs.track(_c)


class CartBlocks:
    """The per-shard pieces of a sharded ABF solve on placed data `dd`:
    one ParityMatFreeOperator per shard over its local box (local nu, so
    K1's shape checks hold, kernels/a00.py; one node table per device),
    the keep/mask aux, the halos and the ownership weights. saddle_mult is
    the sharded matfree.mult_tree (one K1 apply per shard); each halo_u,
    halo_p or halo_r adds one to HALOS_U, HALOS_P or HALOS_R (on the
    cards' path, every card's view, card(), counts its own)."""

    def __init__(self, dcfg, smesh, dd):
        nd = len(dcfg.mloc)
        self.dcfg, self.smesh, self.nd = dcfg, smesh, nd
        mloc, cls_loc = dcfg.mloc, dcfg.cls_shapes_loc
        nu = sum(int(np.prod(s)) for s in cls_loc) * nd
        # K1's node table: one per distinct device, shared by its shards
        table = node_gather_table(tuple(mloc))
        tables = {dev: torch.as_tensor(table, device=dev)
                  for dev in smesh.distinct}
        ops = []
        for i, dev in enumerate(smesh.devices):
            rep = dd["repl"][dev]
            ops.append(ParityMatFreeOperator(
                Bs=rep["Bs"], Dm=rep["Dm"], Np=rep["Np"],
                scale_visc=dd["scale_visc"].parts[i], fac=rep["fac"],
                facp_lam=dd["facp_lam"].parts[i],
                keep=torch.cat([dd["ks"].parts[i],
                                dd["kp"].parts[i].reshape(-1)]),
                bc_mask=torch.cat([dd["ms"].parts[i],
                                   dd["mp"].parts[i].reshape(-1)]),
                m_el=tuple(mloc), nn_u=tuple(2 * m + 1 for m in mloc),
                nn_p=tuple(dcfg.nn_p_loc), nu=nu,
                np_=int(np.prod(dcfg.nn_p_loc)),
                ncomp=nd + nd * (nd - 1) // 2, nqp=3 ** nd,
                cls_shapes=tuple(cls_loc), gather_table=tables[dev],
                factors=rep["factors"]))
        self.ops = ShardVec(ops)
        self.aux = smap(tree_aux, self.ops)
        # K3's operand: each shard's Mpscaled stencil from its own elements
        # only, over its local node box (an interface node holds this
        # shard's partial coefficients; halo_p sums the partial applies)
        self.mp_w = smap(
            lambda o, ps: torch.as_tensor(mp_stencil(mp_csr(
                o.Np.cpu().numpy(), ps.cpu().numpy(), o.m_el), o.nn_p),
                dtype=ps.dtype, device=ps.device), self.ops, dd["pscale"])

        def w_cls(i, p):
            return owned_weight(smesh, i, cls_loc[p],
                                axes=[d for d in range(nd)
                                      if not (p >> d) & 1])
        w_u = [np.concatenate([np.repeat(w_cls(i, p).reshape(-1), nd)
                               for p in range(2 ** nd)])
               for i in range(smesh.ndev)]
        w_p = [owned_weight(smesh, i, tuple(reversed(dcfg.nn_p_loc)))
               for i in range(smesh.ndev)]
        self.w_u = smesh.shard(w_u)
        self.w_l1 = smesh.shard(
            [owned_weight(smesh, i, dcfg.lvl1_loc_shape)[..., None]
             for i in range(smesh.ndev)])
        self.w_sad = smesh.shard(
            [np.concatenate([a, b.reshape(-1)]) for a, b in zip(w_u, w_p)])
        self.dots_u = treeops.make_dots(weight=self.w_u, psum=smesh.psum)
        self.dots_sad = treeops.make_dots(weight=self.w_sad,
                                          psum=smesh.psum)

    def card(self, i, cmesh):
        """Shard i's blocks over its card's view `cmesh` (a CardMesh):
        every per-shard piece shared, nothing built again; the dots reduce
        through cmesh's psum."""
        v = copy.copy(self)
        pick = lambda sv: ShardVec([sv.parts[i]])           # noqa: E731
        v.smesh = cmesh
        v.ops, v.mp_w = pick(self.ops), pick(self.mp_w)
        v.aux = tuple(pick(a) for a in self.aux)
        v.w_u, v.w_l1, v.w_sad = (pick(self.w_u), pick(self.w_l1),
                                  pick(self.w_sad))
        v.dots_u = treeops.make_dots(weight=v.w_u, psum=cmesh.psum)
        v.dots_sad = treeops.make_dots(weight=v.w_sad, psum=cmesh.psum)
        return v

    def halo_u(self, y):
        """Per-axis halo-add of K1's raw output: a class holds an interface
        plane along axis d only where its parity bit d is even; those
        classes exchange along d together, axis by axis as each class
        alone would (in place on the flat vectors, which it returns)."""
        views = [o.split_u(v) for o, v in zip(self.ops.parts, y.parts)]
        classes = [ShardVec(v[p] for v in views) for p in range(2 ** self.nd)]
        for d in range(self.nd):
            halo_add_axes(self.smesh, [c for p, c in enumerate(classes)
                                       if not (p >> d) & 1], d)
        HALOS_U.n += 1
        return y

    def halo_p(self, g, counter=HALOS_P):
        """Per-axis halo-add of a pressure-shaped grid (trailing dims ok),
        counted in `counter`."""
        for d in range(self.nd):
            halo_add_axis(self.smesh, g, d)
        counter.n += 1
        return g

    def halo_r(self, g):
        """halo_p of the L-2 slab the fine residual restricts to (nd values
        a node), counted in HALOS_R."""
        return self.halo_p(g, HALOS_R)

    def saddle_mult(self, t):
        return mult_tree(self.ops, self.aux, t, halo_u=self.halo_u,
                         halo_p=self.halo_p)

    def fine_mult(self, xu):
        return mult_u_tree(self.ops, self.aux, xu, halo_u=self.halo_u)

    def fine_raw(self, xu):
        """K1 of ks x_u per shard (the keep in K1's loads), the interface
        planes added: the fine apply before its keep/mask terms."""
        return mult_u_raw(self.ops, self.aux, xu, halo_u=self.halo_u)

    # --- the local L-2 slabs <-> the replicated full L-2 grid -----------
    def _l1_slices(self, i):
        nd, mloc, box = self.nd, self.dcfg.mloc, self.smesh.boxes[i]
        return tuple(slice(box[d] * mloc[d], box[d] * mloc[d] + mloc[d] + 1)
                     for d in reversed(range(nd)))

    def l1_to_replicated(self, slabs, full_shape):
        """Ownership-weighted sum of every shard's L-2 slab (gathered from
        every process) into the full L-2 grid, in global shard order on the
        first local device, replicated."""
        w = self.w_l1 * slabs
        L2_GATHERS.n += 1
        dev0 = self.smesh.devices[0]
        full = torch.zeros(tuple(full_shape) + (self.nd,), dtype=w.dtype,
                           device=dev0)
        for i, part in enumerate(self.smesh.all_parts(w)):
            full[self._l1_slices(i)] += part
        return self.smesh.replicate(full)

    def l1_from_replicated(self, full):
        return ShardVec(f[self._l1_slices(i)]
                        for i, f in zip(self.smesh.shards, full.parts))


class _ShardedStencil:
    """The sharded L-2 block stencil as the smoothers and the V-cycle take
    it (kernels.stencil.StencilOp's interface on ShardVecs): each call
    extends x by one ghost plane per axis (shard_mesh.ghost_extend: the
    neighbours' planes, zeros at the domain's edges), then runs the
    kernel's padded form on every shard, the fused residual and Chebyshev
    updates included."""

    def __init__(self, smesh, W, nd):
        self.smesh, self.W, self.nd = smesh, W, nd

    def _ghosted(self, x):
        GHOSTS.n += 1
        return ghost_extend(self.smesh, x)

    def __call__(self, x):
        return smap(stencil.stencil_accum, self.W, self._ghosted(x))

    def residual(self, b, x):
        return smap(lambda W, xp, b_: stencil.stencil_residual(
            W, xp, b_, padded=True), self.W, self._ghosted(x), b)

    def cheb_first(self, b, x0, d, scale):
        return smap(lambda W, xp, b_, d_: stencil.stencil_cheb_first(
            W, xp, b_, d_, scale, padded=True), self.W, self._ghosted(x0),
            b, d)

    def cheb_step(self, b, p_k, p_km1, d, scale, omega):
        return smap(lambda W, xp, b_, d_, q: stencil.stencil_cheb_step(
            W, xp, b_, d_, q, scale, omega, padded=True), self.W,
            self._ghosted(p_k), b, d, p_km1)


class _ShardedFine:
    """The sharded fine level as the smoothers and the V-cycle take it
    (kernels.a00.A00Op's interface on ShardVecs): called, the fine apply
    (K1 with the keep in its loads, the halo, the mask terms as torch ops);
    its Chebyshev updates run K1 with the keep, the halo, then K6's masked
    form per shard, which forms y ks + ms x in its loads (bitwise the
    separate ops: the halo sits between K1's raw output and the masks, so
    they cannot go into K1's store)."""

    def __init__(self, blk):
        self.blk = blk

    def __call__(self, xu):
        return self.blk.fine_mult(xu)

    def cheb_first(self, b, x0, d, scale):
        ks, ms = self.blk.aux[0], self.blk.aux[1]
        return smap(lambda b_, y, k, m, d_, x: cheb.cheb_first_masked(
            b_, y, k, m, d_, x, scale), b, self.blk.fine_raw(x0), ks, ms, d,
            x0)

    def cheb_step(self, b, p_k, p_km1, d, scale, omega):
        ks, ms = self.blk.aux[0], self.blk.aux[1]
        return smap(lambda b_, y, k, m, d_, p, q: cheb.cheb_step_masked(
            b_, y, k, m, d_, p, q, scale, omega), b, self.blk.fine_raw(p_k),
            ks, ms, d, p_k, p_km1)


def _cart_bodies(dcfg, smesh, dd, blk, trace=None):
    """The sharded ABF solve's bodies over placed data `dd` and the blocks
    `blk` (the structure of the JAX package's shard_map body): mg_pc (one
    V-cycle on a u ShardVec), p_solve (the p-block's Chebyshev polynomial
    on pressure grids) and up (the A01 apply of a p ShardVec, halos
    included). Every Chebyshev smoother takes its level's inverse diagonal
    as diag=, so its update is K6 per shard on the p level, K6's masked
    form after K1 (keep in its loads) and the halo on the fine level
    (_ShardedFine) and,
    on the stencil levels (L-2 per shard, the replicated levels per
    distinct device), computed in K4's store, as is their residual. The
    transfers are K5's entries: the parity pair per shard (the
    prolongation adding the correction in its store), the grid pair on
    the replicated levels. With `trace` (trace.Trace) the V-cycle is the
    device span vcycle."""
    cfg = dcfg.base
    # zero-guess pre-smooths skip the initial A x0 apply (bit-identical)
    pre_its = cfg.cheb_pre_its if cfg.cheb_pre_its > 0 else cfg.cheb_its
    nd = cfg.ndim
    nlev = cfg.nlevels
    mloc = dcfg.mloc
    cls_loc = dcfg.cls_shapes_loc
    lvl1_glob = cfg.level_grids[-2]
    ops, aux = blk.ops, blk.aux
    repl = dd["repl"]

    # L-2 Galerkin level: sharded block stencil; one ghost plane per
    # axis (ghost_extend_axis zero-pads where the axis has one shard --
    # exactly the domain-boundary padding)
    lvl1A = _ShardedStencil(smesh, dd["W1"], nd)

    def coarse_solve(xg):
        cinv = repl[xg.device]["coarse_inv"]
        return (cinv @ xg.reshape(-1)).reshape(xg.shape)

    def repl_restrict(k, r):
        """Level k's residual r (replicated, or the full L-2 grid) on level
        k - 1's grid, and, where level k - 1 is smoothed, its first
        pre-smoothing iterate from the same K5 launch (else None)."""
        if k == 1:
            return transfer.restrict_grid(r, cfg.level_grids[0]), None
        emin, emax = dd["bounds"][k - 2]
        return transfer.restrict_grid_cheb_first(
            r, cfg.level_grids[k - 1], repl[r.device]["inv_diag_repl"][k - 2],
            float(treeops.cheb_scale(emin, emax)))

    def repl_vcycle(k, b, p1=None):
        """Replicated V-cycle below the sharded levels (PCREDUNDANT),
        on one device's copy; p1 its first pre-smoothing iterate."""
        if k == 0:
            return coarse_solve(b)
        rep = repl[b.device]
        A = stencil.StencilOp(rep["stencils"][k - 1])
        emin, emax = dd["bounds"][k - 1]
        invd = rep["inv_diag_repl"][k - 1]
        x = treeops.cheb_smooth(A, None, emin, emax, pre_its, b,
                                torch.zeros_like(b), x0_zero=True,
                                diag=invd, p1=p1)
        xc = repl_vcycle(k - 1, *repl_restrict(k, A.residual(b, x)))
        x = transfer.prolong_grid(xc, cfg.level_grids[k], add=x)
        return treeops.cheb_smooth(A, None, emin, emax, cfg.cheb_its, b, x,
                                   diag=invd)

    def coarse_correction(r_full):
        r_rep, p1 = repl_restrict(nlev - 2, r_full)
        xc_rep = (coarse_solve(r_rep) if nlev == 3
                  else repl_vcycle(nlev - 3, r_rep, p1))
        return transfer.prolong_grid(xc_rep, cfg.level_grids[nlev - 2])

    emin1, emax1 = dd["bounds"][nlev - 2 - 1]

    def smooth_l1(b, x0v, pre=False):
        return treeops.cheb_smooth(lvl1A, None, emin1, emax1,
                                   pre_its if pre else cfg.cheb_its,
                                   b, x0v, x0_zero=pre,
                                   diag=dd["inv_diag_l1"])

    def vcycle_l1(b):
        x = smooth_l1(b, smap(torch.zeros_like, b), pre=True)
        r = lvl1A.residual(b, x)
        xc = blk.l1_from_replicated(smesh.per_device(
            coarse_correction, blk.l1_to_replicated(r, lvl1_glob)))
        x = x + xc
        return smooth_l1(b, x)

    eminf, emaxf = dd["bounds"][-1]

    fineA = _ShardedFine(blk)

    def smooth_fine(b, x0v, pre=False):
        return treeops.cheb_smooth(fineA, None, eminf, emaxf,
                                   pre_its if pre else cfg.cheb_its,
                                   b, x0v, x0_zero=pre,
                                   diag=dd["inv_diag_fine"])

    def mg_pc(r):
        with span(trace, "vcycle"):
            x = smooth_fine(r, smap(torch.zeros_like, r), pre=True)
            # the ownership-weighted residual w_u * (r - A x), formed in
            # K5's loads; L-2's first step stays K6 (smooth_l1): each
            # shard's restriction is a partial slab that only halo_r
            # completes
            r1 = blk.halo_r(smap(
                lambda b, y, w: transfer.restrict_parity_weighted_residual(
                    b, y, w, cls_loc, mloc), r, blk.fine_mult(x), blk.w_u))
            x1 = vcycle_l1(r1)
            x = smap(lambda v, a: transfer.prolong_parity(v, cls_loc, mloc,
                                                          add=a), x1, x)
            return smooth_fine(r, x)

    # Schur p-block: Chebyshev in Jacobi-preconditioned Mpscaled
    p_emin, p_emax = dd["p_bounds"]

    def p_solve(bp):
        # K3's plain form per shard, the halo, then K6: the update cannot
        # go in K3's store before the interface planes are summed
        return treeops.cheb_smooth(
            lambda pg: mp_apply(ops, dd["pscale"], pg, halo_p=blk.halo_p,
                                W=blk.mp_w),
            None, p_emin, p_emax, cfg.p_cheb_its, bp,
            smap(torch.zeros_like, bp), x0_zero=True, diag=dd["inv_diag_p"])

    def up(yp):
        return mult_up_tree(ops, aux, yp, halo_u=blk.halo_u)

    return {"mg_pc": mg_pc, "p_solve": p_solve, "up": up}


def _split(ops, t):
    """(u, p) views of a ShardVec of saddle vectors: each shard's velocity
    head and its pressure tail as a grid."""
    return (smap(lambda o, v: v[: o.nu], ops, t),
            smap(lambda o, v: v[o.nu:].view(o.p_shape), ops, t))


def make_cart_abf_solver(dcfg, smesh):
    """solve(dd, F, x0) -> (x, its, rnorm, state, hist) over `smesh`, with
    dd from shard_data and F / x0 ShardVecs of flat local parity-layout
    saddle vectors: the host loop (treeops.make_gcr / make_fgmres, one host
    read per iteration) over _cart_bodies, with the device loop's window
    arithmetic on every device (treeops.host_window), so it gives
    CartDeviceLoopSolver's bits (in one process and in a group)."""
    cfg = dcfg.base
    window = treeops.host_window(smesh.devices[0], sharded=True)

    def solver(dd, F, x0, blocks=None):
        blk = blocks if blocks is not None else CartBlocks(dcfg, smesh, dd)
        ops = blk.ops
        b = _cart_bodies(dcfg, smesh, dd, blk)
        gcr = treeops.make_gcr(blk.fine_mult, b["mg_pc"],
                               restart=cfg.gcr_restart, rtol=cfg.gcr_rtol,
                               max_it=cfg.gcr_max_it, dots=blk.dots_u,
                               window=window)

        # fieldsplit Schur UPPER (exSaddle.c:313-318)
        def pc_apply(t):
            bu, bp = _split(ops, t)
            yp = b["p_solve"](bp)
            yu, _, _ = gcr(bu - b["up"](yp))
            return smap(lambda u, p: torch.cat([u, p.reshape(-1)]), yu, yp)

        fgmres = treeops.make_fgmres(blk.saddle_mult, pc_apply,
                                     restart=cfg.restart, rtol=cfg.rtol,
                                     atol=cfg.atol, dtol=cfg.dtol,
                                     max_it=cfg.max_it,
                                     hist_len=cfg.hist_len,
                                     dots=blk.dots_sad, window=window)
        return fgmres(F, x0)

    return solver


class CartDeviceLoopSolver:
    """The sharded ABF solve with its loops on the device (CartABFSolver
    loop="device" / "plain"): the counterpart of the JAX package's
    jit(shard_map(...)) whose GCR and FGMRES are lax.while_loops
    (exsaddle_tpu/parallel/cart_abf.py, exsaddle_tpu/treeops.py), and the
    sharded twin of abf.DeviceLoopSolver.

    Every shard of `smesh` on one device (world 1, one distinct device:
    every shard of this process on one card, or one card's CardMesh view):
    treeops.DeviceFGMRES over blk.saddle_mult, its fieldsplit PC a Piece
    (the p-block and the GCR start), the treeops.DeviceGCR loop over
    blk.fine_mult and the V-cycle, and a Piece that assembles z; the
    vectors and bases are ShardVecs of static per-shard buffers, the dots
    ownership-weighted and summed by the mesh's psum, the control state
    single. The bodies are the host loop's (_cart_bodies).

    graph=True (CUDA, smesh.capturable): the items become one
    graphs.ControlGraph, captured here; a solve is one staged input copy,
    one graph launch under torch.cuda.set_sync_debug_mode("error") and one
    copy of the packed result (every shard's x, its, rnorm, state, hist,
    Control.counts, and on a CardMesh the card's peer error word).
    graph=False: graphs.run_plain drives the same items from Python, one
    host read per loop test. trace (trace.Trace): the solve, its pieces,
    the V-cycle, the Krylov spans and a CardMesh's collectives are device
    spans of it."""

    def __init__(self, dcfg, smesh, dd, blk, graph, trace=None):
        if smesh.world != 1 or len(smesh.distinct) != 1:
            raise ValueError("the sharded device loop needs every shard in "
                             "this process on one device")
        if graph and not smesh.capturable:
            raise ValueError("graph=True needs a capturable ShardMesh "
                             "(every shard on one CUDA device)")
        cfg = dcfg.base
        self.device = dev = smesh.distinct[0]
        self.group = getattr(smesh, "group", None)
        # the card's peer error word, copied into the result (a CudaGroup)
        self.err = (self.group.state[smesh.index]["err"]
                    if hasattr(self.group, "state") else None)
        ops = blk.ops
        nu, np_ = ops.parts[0].nu, ops.parts[0].np_
        self.n = n = nu + np_
        self.nloc = nloc = len(smesh.devices)
        self.ctl = ctl = graphs.Control(dev, trace=trace)
        b = _cart_bodies(dcfg, smesh, dd, blk, trace)
        devs = list(smesh.devices)
        self.gcr = gcr = treeops.DeviceGCR(
            ctl, blk.fine_mult, b["mg_pc"], nu, DTYPE, devs,
            restart=cfg.gcr_restart, rtol=cfg.gcr_rtol,
            max_it=cfg.gcr_max_it, dots=blk.dots_u)
        yp = ShardVec(torch.zeros(o.p_shape, dtype=DTYPE, device=dev)
                      for o in ops.parts)

        def pc_items(vin, zout):
            # fieldsplit Schur UPPER, the u-block a loop
            def p_block():
                vu, vp = _split(ops, vin)
                yp.copy_(b["p_solve"](vp))
                gcr.start(vu - b["up"](yp))

            def assemble():
                zu, zp = _split(ops, zout)
                zu.copy_(gcr.x)
                zp.copy_(yp)
            return [graphs.Piece(p_block, "p-block + gcr start"),
                    gcr.loop(), graphs.Piece(assemble, "fieldsplit z")]

        self.fg = fg = treeops.DeviceFGMRES(
            ctl, blk.saddle_mult, pc_items, n, DTYPE, devs,
            restart=cfg.restart, rtol=cfg.rtol, atol=cfg.atol, dtol=cfg.dtol,
            max_it=cfg.max_it, hist_len=cfg.hist_len, dots=blk.dots_sad)
        # staged input: every shard's F, then every shard's x0
        self.inp = torch.zeros(2 * nloc * n, dtype=DTYPE, device=dev)
        parts = self.inp.view(2, nloc, n)
        self._F, self._x0 = ShardVec(parts[0]), ShardVec(parts[1])
        self.nc = nc = ctl.counts.numel()
        m = nloc * n + 3 + cfg.hist_len
        self.counts_at = slice(m, m + nc)
        self.out = torch.zeros(m + nc + (4 if self.group else 0),
                               dtype=torch.float64, device=dev)
        self.items = [graphs.Piece(self._init, "fgmres init"), fg.loop(),
                      graphs.Piece(self._pack, "fgmres result")]
        self.graph = None
        self.capture_seconds = 0.0
        self._pinned = None
        self.host_launches = 0
        if graph:
            self.graph = graphs.ControlGraph(self.items, ctl)
            self.capture_seconds = self.graph.capture_seconds

    def _init(self):
        self.ctl.counts.zero_()
        self.fg.F.copy_(self._F)
        self.fg.init(self._x0)

    def _pack(self):
        m, fg, o = self.nloc * self.n, self.fg, self.out
        ShardVec(o[:m].view(self.nloc, self.n)).copy_(fg.x)
        o[m:m + 1].copy_(fg.ints[2])
        o[m + 1:m + 2].copy_(fg.sc[1])
        o[m + 2:m + 3].copy_(fg.ints[0])
        o[m + 3:m + 3 + fg.hist_len].copy_(fg.hist)
        o[self.counts_at].copy_(self.ctl.counts)
        if self.err is not None:
            o[self.counts_at.stop:].copy_(self.err)

    def _stage(self, *host_inp):
        """The input, host_inp's arrays one after another, in pinned host
        memory (CUDA)."""
        if self._pinned is None:
            self._pinned = (torch.empty(self.inp.shape, dtype=DTYPE,
                                        pin_memory=True),
                            torch.empty(self.out.shape, dtype=DTYPE,
                                        pin_memory=True))
        staged = self._pinned[0].numpy()
        off = 0
        for a in host_inp:
            staged[off:off + a.size] = a
            off += a.size

    def _launch(self):
        """The staged input's copy, the graph's launch and the result's
        copy back, enqueued on the device's current stream."""
        pin_in, pin_out = self._pinned
        with torch.cuda.device(self.device):
            self.inp.copy_(pin_in, non_blocking=True)
            self.graph.launch()
            pin_out.copy_(self.out, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record()

    def _finish(self):
        """Wait for the launched solve; the result buffer on the host, what
        ran added to the counts."""
        self._done.synchronize()
        res = self._pinned[1].numpy().copy()
        self.graph.account(res[self.counts_at])
        return res

    def _run(self, host_inp):
        """Stage host_inp, run the items, return the result buffer on the
        host (numpy float64) and add what ran to the counts."""
        if self.device.type == "cpu":
            self.inp.copy_(torch.from_numpy(host_inp))
            graphs.run_plain(self.items, self.ctl)
            return self.out.numpy().copy()
        self._stage(host_inp)
        if self.graph is None:
            pin_in, pin_out = self._pinned
            done = torch.cuda.Event()
            self.inp.copy_(pin_in, non_blocking=True)
            graphs.run_plain(self.items, self.ctl)
            pin_out.copy_(self.out, non_blocking=True)
            done.record()
            done.synchronize()
            return pin_out.numpy().copy()
        before = graphs._counters()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            self._launch()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        self._done.synchronize()
        # counts the host moved during the solve (a wrapper called outside
        # the graph): 0 when the whole solve is the one launch
        self.host_launches = sum(b - a for a, b in zip(before,
                                                       graphs._counters()))
        return self._finish()

    def unpack(self, out):
        """(x parts, its, rnorm, state, hist, counts) of a result buffer."""
        m, hl = self.nloc * self.n, self.fg.hist_len
        return (list(out[:m].reshape(self.nloc, self.n)), int(out[m]),
                np.float64(out[m + 1]), int(out[m + 2]),
                out[m + 3:m + 3 + hl], out[self.counts_at].astype(np.int64))

    def solve(self, F_parts, x0_parts):
        """F_parts, x0_parts: per-shard numpy saddle vectors (this
        process's shards). Returns (x parts, its, rnorm, state, hist,
        counts)."""
        return self.unpack(self._run(np.concatenate(list(F_parts)
                                                    + list(x0_parts))))


class CartCardsSolver:
    """The sharded solve with one shard on each card of one process, its
    loops on the cards: card i runs a CartDeviceLoopSolver over its view of
    the mesh (shard_mesh.CardMesh, its blocks CartBlocks.card(i), its data
    card_data(i)), with its own Control and, with graph=True, its own
    graphs.ControlGraph; the cards meet in the peer collectives of `group`
    (kernels.peer: a CudaGroup, or on the CPU a ThreadGroup). Every card
    runs the same loops on replicated control state and its own shard's
    bodies: the psums fold in global shard order and the halos add in the
    one-card order, so each card's control state, and x, are the bits of
    the same shards' device loop on one card.

    A conditional graph's body holds nodes of one device only, so a solve
    is one graph launch per card: every card's input staged, the graphs
    launched back to back from this thread with no host read between
    them, then every result read. With graph=False (a ThreadGroup) each
    card's plain driver runs in its own thread. The cards' its, rnorm,
    state, history and counts must agree exactly (else it raises), and a
    peer wait that timed out raises naming the card and the collective.
    traces: one trace.Trace per card, or None."""

    def __init__(self, dcfg, smesh, dd, blk, group, graph, traces=None):
        if graph and not smesh.one_per_card:
            raise ValueError("the cards' device loop needs one shard on each "
                             "CUDA card of this process")
        if not graph and isinstance(group, peer.CudaGroup):
            # the plain drivers would allocate while the other cards'
            # collectives wait, and an allocation waits for them in turn
            raise ValueError("across cards the loops run on the device "
                             "only: loop='plain' needs one card")
        self.group, self.graph_mode = group, graph
        self.views = []
        group.rehearse = graph
        try:
            for i in range(smesh.ndev):
                tr = None if traces is None else traces[i]
                cm = CardMesh(smesh, i, group, trace=tr)
                v = CartDeviceLoopSolver(dcfg, cm, card_data(dd, i),
                                         blk.card(i, cm), graph, trace=tr)
                self.views.append(v)
        finally:
            group.rehearse = False
        self.nloc = len(self.views)
        self.graphs = [v.graph for v in self.views] if graph else None
        self.capture_seconds = sum(v.capture_seconds for v in self.views)
        self.host_launches = 0
        self.collectives = None

    def _threads(self, inputs):
        out, errs = [None] * self.nloc, [None] * self.nloc

        def run(i):
            try:
                out[i] = self.views[i]._run(inputs[i])
            except BaseException as e:         # raised after the join
                errs[i] = e
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(self.nloc)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for e in errs:
            if e is not None:
                raise e
        return out

    def solve(self, F_parts, x0_parts):
        """As CartDeviceLoopSolver.solve, shard i on card i."""
        if not self.graph_mode:
            res = self._threads([np.concatenate([F_parts[i], x0_parts[i]])
                                 for i in range(self.nloc)])
        else:
            for v, F, x0 in zip(self.views, F_parts, x0_parts):
                v._stage(F, x0)
            before = graphs._counters()
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                for v in self.views:
                    v._launch()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
            for v in self.views:
                v._done.synchronize()
            self.host_launches = sum(b - a for a, b in zip(
                before, graphs._counters()))
            res = [v._finish() for v in self.views]
        v0 = self.views[0]
        if not self.graph_mode or any(r[v0.counts_at.stop] for r in res):
            self.group.check()
        tail = slice(v0.nloc * v0.n, v0.counts_at.stop)
        if any(r[tail].tobytes() != res[0][tail].tobytes() for r in res):
            raise RuntimeError("the cards' control results differ: "
                               + "; ".join(f"card {i}: {v.unpack(r)[1:4]}"
                                           for i, (v, r) in
                                           enumerate(zip(self.views, res))))
        if self.graph_mode:
            self.collectives = self.counted(res[0][v0.counts_at])
        parts = [v.unpack(r)[0][0] for v, r in zip(self.views, res)]
        return (parts,) + v0.unpack(res[0])[1:]

    def counted(self, counts):
        """What one solve of `counts` (Control.counts by slot) ran across
        the cards, from each card's captured graphs: graph launches, and per
        card its collectives (psums, the L-2 gathers among them; halo and
        ghost exchanges), the values its psums reduced, and what the solve
        asked its mesh to exchange (EXCHANGES: halo_u, halo_p, ghosts,
        l2_gathers), whatever the collectives made of it."""
        per = {key: [g.counted(counts, c) for g in self.graphs]
               for key, c in (("psums", peer.PSUMS),
                              ("halo_exchanges", peer.HALOS),
                              ("psum_values", peer.PSUM_VALUES))
               + EXCHANGES}
        per["graph_launches"] = len(self.graphs)
        return per


def _result(x, its, rnorm, state, hist):
    return {"x": x, "its": int(its), "rnorm": float(rnorm),
            "state": int(state), "reason": treeops.reason_name(state),
            "history": [float(h) for h in hist[: its + 1] if h >= 0.0]}


class CartABFSolver:
    """Host-facing distributed ABF over a cartesian device grid: per-shard
    setup, placement on `devices` (one per shard of this process, repeats
    allowed), the sharded solve. In a torch.distributed group of W
    processes each holds 1/W of the shards (CartPartition.device_mesh) and
    every rank returns the full solution.

    loop picks who runs the Krylov loops (as abf.ABFSolver's):
    - "device" (the default when the ShardMesh is capturable: one process,
      every shard on one CUDA device; and when it has one shard on each
      CUDA card of this process, every pair of cards with peer access):
      the whole solve one CUDA graph with conditional nodes per card,
      captured at construction (CartDeviceLoopSolver on one card,
      CartCardsSolver across cards, whose collectives are peer kernels);
      a solve is one graph launch per card and no host read. It raises on
      the CPU and on a mesh that neither holds.
    - "plain": CartDeviceLoopSolver's steps driven from Python
      (graphs.run_plain), one host read of a loop predicate per test: the
      reference the graph is held against, and its CPU form (one process,
      one device).
    - "host" (the default otherwise: on the CPU, across processes, whose
      halos and psums are staged through host memory over the group and
      cannot be captured, and across cards without peer access, which is
      logged): make_cart_abf_solver, one host read per iteration, with the
      device loop's window arithmetic, so it gives "device"'s bits, in one
      process and in a group.
    trace: a trace.Trace per card of the device loop (a list, in the
    order of smesh.distinct; one Trace for one card), or None; the host
    loop takes none.
    The graph reads the placed data by address: the solver holds it for
    its lifetime and never rebinds it."""

    def __init__(self, part, ctx, bc_idx, bc_vals, devices, lame=False,
                 nlevels=3, multihost=None, loop=None, trace=None,
                 **cfg_kw):
        dcfg, ddata, setup = build_cart_abf(
            part, ctx, bc_idx, bc_vals, lame=lame, nlevels=nlevels,
            cfg_kw=cfg_kw, multihost=multihost)
        self._init(part, dcfg, ddata, setup, devices, loop, trace)

    @classmethod
    def from_parts(cls, part, dcfg, ddata, setup, devices, loop=None,
                   trace=None):
        """Solver over (dcfg, ddata, setup) built elsewhere -- e.g. the JAX
        package's CartABFSolver data brought to numpy (its dcfg through
        cart_config_from_dict), so a comparison isolates the solve."""
        self = cls.__new__(cls)
        self._init(part, dcfg, ddata, setup, devices, loop, trace)
        return self

    def _init(self, part, dcfg, ddata, setup, devices, loop, trace):
        self.part, self.mesh = part, part.mesh
        self.dcfg, self.setup = dcfg, setup
        self.smesh = part.device_mesh(devices)
        self.ddata = shard_data(ddata, self.smesh, self.mesh.ndim)
        self.blocks = CartBlocks(dcfg, self.smesh, self.ddata)
        self._group = self._boxes_at = None
        self._set_loop(loop, trace)

    def _cards(self):
        """(whether the cards' device loop can run, why not): one shard on
        each CUDA card of this process, peer access between every pair."""
        if not self.smesh.one_per_card:
            return False, ""
        ok, why = peer.peer_access(self.smesh.distinct)
        if ok:
            return True, ""
        return False, (f"the cards' device loop needs peer access between "
                       f"every pair of cards ({why}): the host loop runs")

    def _set_loop(self, loop, trace=None):
        capturable = self.smesh.capturable
        cards, why = self._cards()
        if loop is None:
            loop = "device" if capturable or cards else "host"
            if why:
                _LOG.warning(why)
        if loop not in ("device", "plain", "host"):
            raise ValueError(f"loop {loop!r}: 'device', 'plain' or 'host'")
        if loop == "device" and not (capturable or cards):
            raise ValueError(
                "loop='device' needs every shard in this process on one "
                "CUDA device, or one shard on each CUDA card with peer "
                f"access (devices {list(self.smesh.devices)}, "
                f"{self.smesh.world} processes){'; ' + why if why else ''}")
        traces = None
        if trace is not None:
            traces = list(trace) if isinstance(trace, (list, tuple)) \
                else [trace]
            if loop == "host" or len(traces) != len(self.smesh.distinct):
                raise ValueError(f"trace: one Trace per card of the device "
                                 f"loop ({len(self.smesh.distinct)}), not "
                                 f"{len(traces)} with loop {loop!r}")
        self.loop, self.traces = loop, traces
        self.capture_seconds = 0.0
        self._solve = self._dev = None
        if loop == "host":
            self._solve = make_cart_abf_solver(self.dcfg, self.smesh)
        elif cards:
            if self._group is None:
                self._group = peer.CudaGroup(
                    self.smesh.distinct, self.blocks.ops.parts[0].nu
                    + self.blocks.ops.parts[0].np_)
            self._dev = CartCardsSolver(self.dcfg, self.smesh, self.ddata,
                                        self.blocks, self._group,
                                        loop == "device", traces)
            self.capture_seconds = self._dev.capture_seconds
        else:
            self._dev = CartDeviceLoopSolver(
                self.dcfg, self.smesh, self.ddata, self.blocks,
                loop == "device", trace=traces[0] if traces else None)
            self.capture_seconds = self._dev.capture_seconds

    def with_loop(self, loop, trace=None):
        """A solver over this one's placed data and blocks (the same setup,
        nothing placed again) whose Krylov loops run as `loop`, traced by
        `trace` (as the constructor's): the traced twin of a solver is
        with_loop("device", trace=[Trace(d) for d in smesh.distinct])."""
        other = copy.copy(self)
        other._set_loop(loop, trace)
        return other

    # --- vector conversions ------------------------------------------------
    def _box_index(self):
        """Every shard's flat local parity-layout vector as indices into the
        natural (ndof,) ordering, in stack order; made once. A plane that
        two boxes share appears in both."""
        if self._boxes_at is None:
            self._boxes_at = self._box_slices(np.arange(self.mesh.ndof))
        return self._boxes_at

    def _saddle_parts(self, x_flat):
        """Natural (ndof,) -> every shard's flat local parity-layout
        vector (numpy, stack order)."""
        x = np.asarray(x_flat)
        return [x[i] for i in self._box_index()]

    def _box_slices(self, x):
        """_saddle_parts by slicing: each box's node grids, split into
        parity classes, then its pressure grid."""
        mesh, part = self.mesh, self.part
        nd = mesh.ndim
        g = x[: mesh.nu].reshape(tuple(reversed(mesh.nn_u)) + (nd,))
        gp = x[mesh.nu:].reshape(tuple(reversed(mesh.nn_p)))
        parts = []
        for box in stack_boxes(part.dev_shape):
            loc = g[part._grid_slices(box, 2, (slice(None),))]
            parts.append(np.concatenate(
                [s.reshape(-1) for s in split_grid_parity(loc, nd)]
                + [gp[part._grid_slices(box, 1, ())].reshape(-1)]))
        return parts

    def shard_saddle(self, x_flat):
        """Natural (ndof,) -> ShardVec of flat local parity-layout vectors
        (this process's shards)."""
        return self.smesh.shard(self._saddle_parts(x_flat))

    def unshard_saddle(self, t):
        """ShardVec -> natural (ndof,) host vector, every process's shards
        gathered (so every rank returns the whole vector)."""
        return self._unshard_parts([v.numpy() for v in
                                    self.smesh.all_parts(t, "cpu")])

    def _unshard_parts(self, parts):
        """Every shard's flat local vector (numpy, stack order) -> natural
        (ndof,) float64 host vector, box by box: a plane that two boxes
        share takes the later box's values."""
        x = np.zeros(self.mesh.ndof)
        for i, v in zip(self._box_index(), parts):
            x[i] = v
        return x

    def solve(self, F_flat, x0_flat=None):
        """Solve A x = F (natural-ordering host vectors). Returns dict with
        x, its, rnorm, state, reason, history, loop, halo_exchanges (the
        solve's halo_u, halo_p and halo_r calls: on the cards' path each
        card's),
        counts (Control.counts by name, the device loop) and, across cards,
        collectives (CartCardsSolver.counted)."""
        h0 = HALOS_U.n + HALOS_P.n + HALOS_R.n
        if self._dev is not None:
            Fp = self._saddle_parts(F_flat)
            x0p = (self._saddle_parts(x0_flat) if x0_flat is not None
                   else [np.zeros_like(f) for f in Fp])
            x, its, rnorm, state, hist, counts = self._dev.solve(Fp, x0p)
            res = _result(self._unshard_parts(x), its, rnorm, state, hist)
            ctl = (self._dev.views[0] if hasattr(self._dev, "views")
                   else self._dev).ctl
            res["counts"] = ctl.named(counts)
            if getattr(self._dev, "collectives", None) is not None:
                res["collectives"] = self._dev.collectives
        else:
            Ft = self.shard_saddle(F_flat)
            x0 = (self.shard_saddle(x0_flat) if x0_flat is not None
                  else smap(torch.zeros_like, Ft))
            x, its, rnorm, state, hist = self._solve(self.ddata, Ft, x0,
                                                     blocks=self.blocks)
            res = _result(self.unshard_saddle(x), its, rnorm, state, hist)
        views = len(getattr(self._dev, "views", ())) or 1
        res.update(loop=self.loop,
                   halo_exchanges=(HALOS_U.n + HALOS_P.n + HALOS_R.n - h0)
                   // views)
        return res
