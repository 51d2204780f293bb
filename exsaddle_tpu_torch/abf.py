"""The ABF (Approximate Block Factorization) saddle solver, in PyTorch.

The port of exsaddle_tpu/abf.py: the flagship solver configuration
(abf.opts:1-16): FGMRES(30, right PC, unpreconditioned norm) over
fieldsplit-Schur-UPPER, whose u-block is GCR(rtol 1e-2) preconditioned by a
Galerkin-MG V-cycle with Chebyshev(8)/Jacobi smoothers and a dense coarse
solve, and whose p-block is a fixed Chebyshev polynomial in the
Jacobi-preconditioned viscosity-scaled pressure mass matrix.

Multigrid structure (-saddle_fieldsplit_u_pc_mg_galerkin, abf.opts:13):
  - fine level: the factored matrix-free A00 apply, K1 on CUDA
    (kernels/a00.py);
  - intermediate levels, including the Galerkin L-2 level: 3^nd-point block
    stencils W (*grid, 3^nd, nd, nd) extracted from the host Galerkin
    products;
  - coarsest: dense matvec with a precomputed inverse (PCREDUNDANT + LU).

Setup (build_abf) is host numpy, copied from the JAX package so both build
the same numbers; its last step casts the solver data to tensors on the
given device. Vectors are flat tensors in the parity-permuted dof order of
matfree.py; the "_tree" names of the JAX package are kept for the block
applies so each counterpart is easy to find."""

import contextlib
import itertools
import os
import sys
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from exsaddle_tpu_torch import treeops
from exsaddle_tpu_torch.treeops import smap
from exsaddle_tpu_torch.grid_ops import (gather_u_parity, scatter_u_parity,
                                         _gather_q1, _scatter_q1)
from exsaddle_tpu_torch.kernels.a00 import a00_apply
from exsaddle_tpu_torch.matfree import (ParityMatFreeOperator,
                                        factored_host, parity_permutation,
                                        mult_tree, tree_aux)
from exsaddle_tpu_torch.mesh import SaddleMesh


# --------------------------------------------------------------------------
# Block applies on the parity operator (the fieldsplit blocks of the
# BC-eliminated saddle matrix, as PETSc's MatCreateSubMatrix extracts them)
# --------------------------------------------------------------------------

def mult_u_tree(op, aux, xu, halo_u=None):
    """A00 x_u (flat u vector): K1 with keep/mask Dirichlet elimination
    (unit diagonal on BC rows). In a sharded layout (parallel/) op, aux and
    xu are per shard and halo_u adds the interface planes of K1's raw
    output before the keep/mask terms."""
    ks, ms, _, _ = aux
    y = smap(a00_apply, op, xu * ks)
    if halo_u is not None:
        y = halo_u(y)
    return y * ks + ms * xu


def _up_local(op, pg):
    pe = _gather_q1(pg, op.m_el)
    ptmp = pe @ op.Np.T
    yue = -((ptmp * op.fac[None, :]) @ op.Dm)
    return scatter_u_parity(yue, op.m_el, op.cls_shapes)


def mult_up_tree(op, aux, pg, halo_u=None):
    """A01 x_p: pressure-gradient block into u space (BC rows zeroed).
    pg: pressure grid; returns a flat u vector."""
    ks, _, _, _ = aux
    y = smap(_up_local, op, pg)
    if halo_u is not None:
        y = halo_u(y)
    return y * ks


def _pu_local(op, xk):
    xe = gather_u_parity(op.split_u(xk), op.m_el)
    div = xe @ op.Dm.T
    ype = -(div * op.fac[None, :]) @ op.Np
    return _scatter_q1(ype, op.m_el, op.nn_p)


def mult_pu_tree(op, aux, xu, halo_p=None):
    """A10 x_u: divergence block into p space (BC columns zeroed).
    Returns a pressure grid."""
    ks, _, _, _ = aux
    yp = smap(_pu_local, op, xu * ks)
    return yp if halo_p is None else halo_p(yp)


def _mp_local(op, pscale, pg):
    pe = _gather_q1(pg, op.m_el)
    ptmp = (pe @ op.Np.T) * pscale
    return _scatter_q1(ptmp @ op.Np, op.m_el, op.nn_p)


def mp_apply(op, pscale, pg, halo_p=None):
    """Mpscaled x_p: viscosity-scaled pressure mass matrix in factored form
    (MatAssemble_Schur weights, femixedspace.c:2837-2948).
    pscale: (nel, nqp) = -w_q detJp (1/eta) [Lame: (1/lambda + 1/mu)]."""
    yp = smap(_mp_local, op, pscale, pg)
    return yp if halo_p is None else halo_p(yp)


# --------------------------------------------------------------------------
# MG transfers
# --------------------------------------------------------------------------

def _class_bits(p, nd):
    return [(p >> a) & 1 for a in range(nd)]


def prolong_parity(xc, cls_shapes, m_el):
    """Multilinear interpolation coarse grid -> fine parity layout.

    xc: (*rev(m+1 per axis), nd). Coarse nodes coincide with fine parity
    class 0; a fine node with parity bits b averages its 2^{popcount(b)}
    coarse neighbors -- every term a unit-stride slice. Returns a flat
    parity-permuted u vector."""
    nd = len(m_el)
    subs = []
    for p, shp in enumerate(cls_shapes):
        bits = _class_bits(p, nd)
        w = 0.5 ** sum(bits)
        acc = None
        for deltas in itertools.product(*[range(b + 1) for b in bits]):
            idx = tuple(
                slice(deltas[nd - 1 - dim], deltas[nd - 1 - dim]
                      + shp[dim]) for dim in range(nd)) + (slice(None),)
            piece = xc[idx]
            acc = piece if acc is None else acc + piece
        subs.append((w * acc).reshape(-1))
    return torch.cat(subs)


def restrict_parity(xu, cls_shapes, m_el):
    """Transpose of prolong_parity: flat fine u vector -> coarse grid."""
    nd = len(m_el)
    cshape = tuple(m_el[nd - 1 - dim] + 1 for dim in range(nd))
    out = torch.zeros(cshape + (nd,), dtype=xu.dtype, device=xu.device)
    off = 0
    for p, shp in enumerate(cls_shapes):
        n = int(np.prod(shp)) * nd
        sub = xu[off:off + n].view(tuple(shp) + (nd,))
        off += n
        bits = _class_bits(p, nd)
        w = 0.5 ** sum(bits)
        for deltas in itertools.product(*[range(b + 1) for b in bits]):
            idx = tuple(slice(deltas[nd - 1 - dim],
                              deltas[nd - 1 - dim] + shp[dim])
                        for dim in range(nd))
            out[idx] += w * sub
    return out


def prolong_grid(xc, fine_shape):
    """Separable multilinear interpolation between plain node grids
    (spatial dims leading, dof trailing). fine_shape: spatial shape of the
    output. Matches precond_mg.Prolongation for (M+1)/2-coarsened grids."""
    x = xc
    for dim in range(len(fine_shape)):
        x = _prolong_axis(x, dim, fine_shape[dim])
    return x


def _prolong_axis(x, axis, nf):
    x = torch.movedim(x, axis, 0)
    a = x                                     # even fine slots
    b = 0.5 * (x[:-1] + x[1:])                # odd fine slots
    inter = torch.stack([a[:-1], b], dim=1).reshape((-1,) + x.shape[1:])
    out = torch.cat([inter, a[-1:]], dim=0)
    if out.shape[0] != nf:
        raise ValueError(f"prolong_grid: {out.shape[0]} != {nf} nodes")
    return torch.movedim(out, 0, axis)


def restrict_grid(rf, coarse_shape):
    """Transpose of prolong_grid."""
    x = rf
    for dim in range(len(coarse_shape)):
        x = _restrict_axis(x, dim, coarse_shape[dim])
    return x


def _restrict_axis(x, axis, nc):
    x = torch.movedim(x, axis, 0)
    r = x[::2].clone()
    odd = 0.5 * x[1::2]
    r[:-1] += odd
    r[1:] += odd
    if r.shape[0] != nc:
        raise ValueError(f"restrict_grid: {r.shape[0]} != {nc} nodes")
    return torch.movedim(r, 0, axis).contiguous()


# --------------------------------------------------------------------------
# Block stencil operator (deep Galerkin levels)
# --------------------------------------------------------------------------

def stencil_from_csr(A_csr, grid_shape, nd):
    """Extract a 3^ndim-point block stencil from an assembled operator on a
    structured node grid with nd dofs per node (Galerkin RAP of a Q1-type
    operator stays within the 3^ndim-point pattern).

    grid_shape: spatial (reversed: z,y,x) node counts.
    Returns W: (*grid_shape, 3^ndim, nd, nd) with W[..., s, i, j] the
    coupling to the neighbor at offset s (offsets x-fastest, -1..1)."""
    import scipy.sparse as sp
    ndim = len(grid_shape)
    nn = tuple(reversed(grid_shape))          # per-axis counts, x first
    nnod = int(np.prod(nn))
    A = sp.bsr_matrix(A_csr.tocsr(), blocksize=(nd, nd))
    indptr, indices, data = A.indptr, A.indices, A.data
    rows = np.repeat(np.arange(nnod, dtype=np.int64), np.diff(indptr))
    cols = indices.astype(np.int64)

    def decode(lin):
        out = []
        for d in range(ndim):
            out.append(lin % nn[d])
            lin = lin // nn[d]
        return out                            # per-axis coords, x first

    rc = decode(rows.copy())
    cc = decode(cols.copy())
    slot = np.zeros(rows.shape, dtype=np.int64)
    mult = 1
    for d in range(ndim):
        off = cc[d] - rc[d]
        if np.abs(off).max(initial=0) > 1:
            raise ValueError("operator exceeds the 3^ndim-point stencil "
                             "pattern")
        slot += (off + 1) * mult
        mult *= 3
    W = np.zeros((nnod, 3 ** ndim, nd, nd))
    W[rows, slot] = data
    return W.reshape(grid_shape + (3 ** ndim, nd, nd))


def _stencil_offsets(ndim):
    """Neighbor offsets, x-fastest (off[0] is the x offset)."""
    return [tuple(reversed(o))
            for o in itertools.product(*[(-1, 0, 1)] * ndim)]


def stencil_accum(W, xp):
    """y = A x for a block stencil operator, with xp carrying one ghost
    layer on each side of every spatial dim (zeros at domain boundaries).
    W: (*grid_shape, 3^nd, nd, nd) -- the W form of the JAX package. The
    3^nd shifted views are stacked and contracted with W as one elementwise
    product and one sum over (slot, column). A batched (nd x nd) matmul per
    slot ran as ~10^6 tiny cuBLAS gemvs on an H100 (~0.5 ms per mx=32 L-2
    apply)."""
    ndim = xp.ndim - 1
    shape = tuple(W.shape[:ndim])
    views = []
    for off in _stencil_offsets(ndim):
        idx = tuple(slice(1 + off[ndim - 1 - dim],
                          1 + off[ndim - 1 - dim] + shape[dim])
                    for dim in range(ndim))
        views.append(xp[idx])
    X = torch.stack(views, dim=ndim)                 # (*grid, 3^nd, nd)
    return (W * X.unsqueeze(-2)).sum(dim=(ndim, ndim + 2))


def stencil_apply(W, x):
    """y = A x for a block stencil operator. x: (*grid_shape, nd)."""
    ndim = x.ndim - 1
    xp = torch.nn.functional.pad(x, (0, 0) + (1, 1) * ndim)
    return stencil_accum(W, xp)


# --------------------------------------------------------------------------
# Setup (host numpy; the same arithmetic as the JAX package's build)
# --------------------------------------------------------------------------

def _setup_profile():
    return os.environ.get("EXSADDLE_SETUP_PROFILE") == "1"


@contextlib.contextmanager
def _stage(name):
    """Setup-phase stage timer: prints the stage's wall time to stderr as
    `[setup] <name>: <s> s` when EXSADDLE_SETUP_PROFILE=1, else nothing."""
    if not _setup_profile():
        yield
        return
    t0 = time.perf_counter()
    yield
    print(f"[setup] {name}: {time.perf_counter() - t0:.2f} s",
          file=sys.stderr, flush=True)


@dataclass(frozen=True)
class ABFConfig:
    """Static solver configuration (the JAX package's ABFConfig without its
    TPU matmul-precision knobs: the port's precision policy is global,
    exsaddle_tpu_torch/__init__.py)."""
    ndim: int
    nlevels: int = 3
    restart: int = 30
    rtol: float = 1e-5
    atol: float = 1e-50
    dtol: float = 1e4
    max_it: int = 10000
    hist_len: int = 256
    gcr_rtol: float = 1e-2
    gcr_restart: int = 30
    gcr_max_it: int = 200
    # >0: the u-block solve is this many MG-preconditioned Richardson steps
    # (n V-cycles and n-1 fine applies, no Krylov window and no host read)
    # in place of GCR; the outer FGMRES is flexible, so a fixed-work inner
    # solve is admissible. 0 is GCR at gcr_rtol, as abf.opts:5-6.
    u_fixed_vcycles: int = 0
    cheb_its: int = 8
    # pre-smoothing iteration count; 0 means "same as cheb_its"
    cheb_pre_its: int = 0
    p_cheb_its: int = 12
    # grid metadata (filled by build)
    cls_shapes: tuple = ()
    m_el: tuple = ()
    level_grids: tuple = ()     # reversed spatial node shapes, coarse->fine


def _esteig_bounds(apply_fn, diag, n, transform=(0.0, 0.2, 0.0, 1.1)):
    """Setup-phase Chebyshev eigenvalue estimation: GMRES(10) Hessenberg
    eigenvalues with left Jacobi preconditioning on the noisy RHS, then
    PETSc's esteig transform (abf.opts:10). Classical Gram-Schmidt, Givens
    recurrence, preconditioned-norm test at rtol 1e-12, in numpy."""
    invd = 1.0 / np.asarray(diag)

    def Aop(v):
        return np.asarray(apply_fn(v))

    from exsaddle_tpu_torch.krylov import noisy_vector
    b = noisy_vector(n)
    max_it = 10
    rtol = 1e-12
    haptol = 1e-30
    V = np.zeros((max_it + 1, n))
    Hes = np.zeros((max_it + 1, max_it))       # unrotated (for eig)
    H = np.zeros((max_it + 1, max_it))         # rotated (residual recurrence)
    cs = np.zeros(max_it)
    sn = np.zeros(max_it)
    g = np.zeros(max_it + 1)
    v0 = invd * b
    res0 = float(np.linalg.norm(v0))
    V[0] = v0 / res0
    g[0] = res0
    it = 0
    while it < max_it:
        w = invd * Aop(V[it])
        h = V[: it + 1] @ w
        w = w - h @ V[: it + 1]
        tt = float(np.linalg.norm(w))
        Hes[: it + 1, it] = h
        Hes[it + 1, it] = tt
        H[: it + 1, it] = h
        H[it + 1, it] = tt
        hapbnd = min(abs(tt / g[it]) if g[it] != 0 else 0.0, haptol)
        hapend = tt <= hapbnd
        if not hapend:
            V[it + 1] = w / tt
        for i in range(it):
            t1, t2 = H[i, it], H[i + 1, it]
            H[i, it] = cs[i] * t1 + sn[i] * t2
            H[i + 1, it] = -sn[i] * t1 + cs[i] * t2
        delta = np.hypot(H[it, it], H[it + 1, it])
        if delta == 0.0:
            break
        cs[it] = H[it, it] / delta
        sn[it] = H[it + 1, it] / delta
        g[it + 1] = -sn[it] * g[it]
        g[it] = cs[it] * g[it]
        it += 1
        if hapend or abs(g[it]) <= rtol * res0:
            break
    ev = np.linalg.eigvals(Hes[:it, :it])
    emin_est, emax_est = float(ev.real.min()), float(ev.real.max())
    a, b_, c, d = transform
    return (a * emin_est + b_ * emax_est, c * emin_est + d * emax_est)


def p_spectrum_bounds(Sel):
    """Spectrum bracket of D^-1 Mpscaled from the ELEMENT matrices alone:
    the extreme eigenvalues of the diagonally scaled element blocks
    (one-sided safe: it can only widen the interval).
    Sel: (nel, npb, npb) negative-definite Schur-pre element matrices."""
    Se = -np.asarray(Sel)
    d = np.einsum("eii->ei", Se)
    s = 1.0 / np.sqrt(d)
    B = Se * s[:, :, None] * s[:, None, :]
    ew = np.linalg.eigvalsh(B)
    return float(ew[:, 0].min()), float(ew[:, -1].max())


def _lanczos_extremes(Msym, m=48):
    """Deterministic fixed-step Lanczos (full reorthogonalization, ones
    start vector) extreme Ritz values of a symmetric CSR matrix."""
    n = Msym.shape[0]
    m = min(m, n)
    V = np.zeros((m + 1, n))
    alph = np.zeros(m)
    beta = np.zeros(m)
    V[0] = 1.0 / np.sqrt(n)
    k = m
    for j in range(m):
        w = Msym @ V[j]
        alph[j] = V[j] @ w
        w -= alph[j] * V[j]
        if j > 0:
            w -= beta[j - 1] * V[j - 1]
        w -= V[: j + 1].T @ (V[: j + 1] @ w)
        beta[j] = np.linalg.norm(w)
        if beta[j] == 0.0:
            k = j + 1
            break
        V[j + 1] = w / beta[j]
    T = (np.diag(alph[:k]) + np.diag(beta[:k - 1], 1)
         + np.diag(beta[:k - 1], -1))
    ew = np.linalg.eigvalsh(T)
    return float(ew[0]), float(ew[-1])


def p_spectrum_bounds_assembled(Mp, dmp, el_bounds):
    """Chebyshev interval for the Schur p-block: spectrum of D^-1 Mpscaled.
    Exact dense eigenvalues up to 600 unknowns; above, 48-step Lanczos for
    lambda_max with the element bracket's safe lower end."""
    import scipy.sparse as sp
    Dm_s = sp.diags(1.0 / np.sqrt(np.abs(dmp)))
    Msym = (Dm_s @ (-Mp) @ Dm_s).tocsr()
    if Msym.shape[0] <= 600:
        ew = np.linalg.eigvalsh(Msym.toarray())
        return float(ew[0]), float(ew[-1])
    lo_l, hi_l = _lanczos_extremes(Msym)
    return min(float(el_bounds[0]), lo_l), hi_l


def _p_loc_l2(nd):
    """Element-local block of the fine <- L-2 multilinear interpolation:
    P_loc[(l, a), (c, a)] for one element (identical for every element on
    the uniform grid). Rows: Q2-local nodes x-fastest, dof interleaved;
    cols: corners x-fastest, dof interleaved."""
    w1 = np.array([[1.0, 0.0], [0.5, 0.5], [0.0, 1.0]])
    P = w1
    for _ in range(nd - 1):
        P = np.kron(w1, P)     # slowest axis outermost: l = la + 3 lb + ...
    return np.kron(P, np.eye(nd))


def _galerkin_l2_elements(mesh, P_loc, Bs, s_flat, keep_e, bc_u):
    """Per-element Galerkin L-2 contributions of the BC-eliminated fine
    velocity block A00 = K (Bs^T diag(s) Bs) K + diag(bc), corner-ordered
    x-fastest, with sum_e scatter(A1e) == P^T A00 P exactly (the diag(bc)
    term folded in with 1/multiplicity weights on element-shared nodes).
    Interior elements share C0 = Bs P_loc; only BC-touching elements get a
    per-element masked C."""
    nd = mesh.ndim
    nel = mesh.nel
    ue = np.asarray(mesh.u_el_dofs)
    mels = np.asarray(mesh.m_el)

    C0 = Bs @ P_loc                                           # (nqpc, ncd)
    ncd = P_loc.shape[1]

    A1e = np.empty((nel, ncd, ncd))
    interior = np.all(keep_e == 1.0, axis=1)
    bidx = np.nonzero(~interior)[0]

    # 1/multiplicity ownership weight of each local fine node, for the
    # O(surface) BC-touching elements only
    egrid = np.stack(np.meshgrid(
        *[np.arange(m) for m in reversed(mels)], indexing="ij"),
        -1)[..., ::-1].reshape(-1, nd)[bidx]    # element x-fastest
    loff = np.stack(np.meshgrid(*[np.arange(3)] * nd, indexing="ij"),
                    -1)[..., ::-1].reshape(-1, nd)            # x-fastest
    gco = 2 * egrid[:, None, :] + loff[None, :, :]            # (nb,nbu,nd)
    shared = ((loff[None, :, :] % 2 == 0) & (gco > 0)
              & (gco < (2 * mels)[None, None, :]))
    multipl = np.prod(np.where(shared, 2.0, 1.0), axis=2)     # (nb, nbu)
    wbc_b = np.repeat(1.0 / multipl, nd, axis=1) * bc_u[ue[bidx]]
    # interior elements in ONE dgemm: A1e[e] = sum_q s[e,q] C0[q,:]C0[q,:]^T
    K = (C0[:, :, None] * C0[:, None, :]).reshape(C0.shape[0], ncd * ncd)
    A1e[interior] = (s_flat[interior] @ K).reshape(-1, ncd, ncd)
    for c0 in range(0, len(bidx), 4096):
        sel = bidx[c0:c0 + 4096]
        wsel = wbc_b[c0:c0 + 4096]
        b = len(sel)
        T = keep_e[sel][:, :, None] * P_loc[None]             # (b,nud,ncd)
        # one dgemm for every masked C: Bs @ [T_e | T_e | ...]
        C = (Bs @ T.transpose(1, 0, 2).reshape(T.shape[1], b * ncd))
        C = C.reshape(-1, b, ncd).transpose(1, 0, 2)          # (b,nqpc,ncd)
        blk = np.matmul(C.transpose(0, 2, 1) * s_flat[sel][:, None, :], C)
        blk += np.matmul(P_loc.T[None] * wsel[:, None, :], P_loc[None])
        A1e[sel] = blk
    return A1e


def _stencil_from_l2_elements(A1e, m_el, nd):
    """Scatter per-element L-2 Galerkin blocks (corner ordering x-fastest)
    straight into the 3^nd-point block stencil via 4^nd slice-adds."""
    grid = tuple(reversed([m + 1 for m in m_el]))
    W = np.zeros(grid + (3 ** nd, nd, nd))
    A1g = A1e.reshape(tuple(reversed(m_el)) + A1e.shape[1:])
    for ca in range(2 ** nd):
        abits = [(ca >> d) & 1 for d in range(nd)]
        idx = tuple(slice(abits[nd - 1 - k],
                          abits[nd - 1 - k] + m_el[nd - 1 - k])
                    for k in range(nd))
        for cb in range(2 ** nd):
            slot = sum((((cb >> d) & 1) - abits[d] + 1) * 3 ** d
                       for d in range(nd))
            W[idx + (slot,)] += A1g[..., ca * nd:(ca + 1) * nd,
                                    cb * nd:(cb + 1) * nd]
    return W


def csr_from_stencil(W, grid_shape, nd):
    """Inverse of stencil_from_csr: assemble the scipy CSR directly from a
    block stencil (indices come out sorted, no COO sort)."""
    import scipy.sparse as sp
    ndim = len(grid_shape)
    nn = tuple(reversed(grid_shape))          # per-axis counts, x first
    nnod = int(np.prod(nn))
    ns = 3 ** ndim
    coords = []
    lin = np.arange(nnod, dtype=np.int64)
    for d in range(ndim):
        coords.append(lin % nn[d])
        lin = lin // nn[d]
    valid = np.ones((nnod, ns), dtype=bool)
    cols_nb = np.zeros((nnod, ns), dtype=np.int64)
    for s, off in enumerate(_stencil_offsets(ndim)):
        col = np.zeros(nnod, dtype=np.int64)
        mult = 1
        ok = np.ones(nnod, dtype=bool)
        for d in range(ndim):
            c = coords[d] + off[d]
            ok &= (c >= 0) & (c < nn[d])
            col += np.clip(c, 0, nn[d] - 1) * mult
            mult *= nn[d]
        valid[:, s] = ok
        cols_nb[:, s] = col
    # rows ordered (node, i); entries within a row ordered (s, j)
    Wl = W.reshape(nnod, ns, nd, nd).transpose(0, 2, 1, 3)  # (nnod,i,s,j)
    vmask = np.broadcast_to(valid[:, None, :, None], Wl.shape)
    data = Wl[vmask]
    cols = np.broadcast_to(
        (cols_nb[:, :, None] * nd + np.arange(nd))[:, None, :, :],
        Wl.shape)[vmask]
    counts = (valid.sum(axis=1, dtype=np.int64) * nd)
    counts = np.repeat(counts, nd)
    indptr = np.zeros(nnod * nd + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    n = nnod * nd
    return sp.csr_matrix((data, cols.astype(np.int32), indptr),
                         shape=(n, n))


def build_abf(mesh, fes, coeff_qp, bc_idx, bc_vals, *, device, lame=False,
              dtype=torch.float64, nlevels=3, cfg_kw=None):
    """Build (cfg, data, setup) for the ABF solve on `device`.

    Host setup in FACTORED form, as the JAX package's build_abf: the fine
    Jacobi diagonal, the esteig probe apply, the Galerkin L-2 matrix and
    rhs_diri all come from Bs/scale; Galerkin RAP below L-2 is scipy; the
    coarse inverse is dense. data holds tensors of `dtype` on `device`;
    setup holds the host arrays plus the float64 operator for residuals."""
    from exsaddle_tpu_torch.precond_mg import (Prolongation,
                                               galerkin_coarse_operators)
    from exsaddle_tpu_torch.assembly import assemble_schur_pre
    import scipy.sparse as sp

    nd = mesh.ndim
    nu = mesh.nu
    ue = np.asarray(mesh.u_el_dofs)

    bc_mask = np.zeros(mesh.ndof)
    bc_mask[:nu][np.asarray(bc_idx)] = 1.0
    x_bc = np.zeros(mesh.ndof)
    x_bc[:nu][np.asarray(bc_idx)] = np.asarray(bc_vals)
    bc_u = bc_mask[:nu]
    keep_u = 1.0 - bc_u

    with _stage("factored_host"):
        fd = factored_host(mesh, fes, coeff_qp, lame=lame)
    Bs, Dm_m, Np_m, fac = fd["Bs"], fd["Dm"], fd["Np"], fd["fac"]
    s_flat = fd["scale"]                          # (nel, nqp*ncomp), f64

    with _stage("parity op build"):
        pop = ParityMatFreeOperator.build(mesh, fes, coeff_qp, bc_mask,
                                          lame=lame, dtype=dtype,
                                          device=device, host=fd)
        perm, iperm = parity_permutation(mesh)

    # rhs_diri = -(A_raw x_bc), BC rows zeroed (femixedspace.c:2634-2643);
    # only the O(surface) elements touching a BC node contribute
    with _stage("rhs_diri"):
        bce = np.nonzero(bc_u[ue].any(axis=1))[0]
        xbe = x_bc[:nu][ue[bce]]
        yue = ((xbe @ Bs.T) * s_flat[bce]) @ Bs
        ype = -((xbe @ Dm_m.T) * fac[None, :]) @ Np_m
        rhs_diri = np.zeros(mesh.ndof)
        rhs_diri[:nu] = np.bincount(ue[bce].ravel(), weights=yue.ravel(),
                                    minlength=nu)
        rhs_diri[nu:] = np.bincount(
            np.asarray(mesh.p_el_nodes)[bce].ravel(),
            weights=ype.ravel(), minlength=mesh.np_)
        rhs_diri = -rhs_diri
        rhs_diri[:nu][np.asarray(bc_idx)] = 0.0

    # float64 operator for true residuals (tests, iterative refinement)
    with _stage("f64 saddle op"):
        op64 = pop if dtype == torch.float64 else \
            ParityMatFreeOperator.build(mesh, fes, coeff_qp, bc_mask,
                                        lame=lame, dtype=torch.float64,
                                        device=device, host=fd)

    # velocity-grid hierarchy (fine -> coarse), DMDA (M+1)/2 coarsening
    grids = [tuple(mesh.nn_u)]
    for _ in range(nlevels - 1):
        grids.append(tuple((m + 1) // 2 for m in grids[-1]))
    grids = grids[::-1]                      # coarsest first
    for g in grids:
        if not all(n >= 2 for n in g):
            raise ValueError("too many MG levels for this mesh")

    with _stage("prolongations"):
        prolongs = [Prolongation(grids[k], grids[k + 1], nd)
                    for k in range(nlevels - 2)]

    with _stage("fine diagonal"):
        keep_e = keep_u[ue]
        diag_e = s_flat @ (Bs ** 2)           # (nel, nud)
        fine_diag = bc_u + np.bincount(
            ue.ravel(), weights=(keep_e * diag_e).ravel(), minlength=nu)

    ue_flat = ue.ravel()

    def fine_apply(v):
        x = np.asarray(v)
        xe = (keep_u * x)[ue]
        yue = ((xe @ Bs.T) * s_flat) @ Bs
        y = np.bincount(ue_flat, weights=yue.ravel(), minlength=nu)
        return keep_u * y + bc_u * x

    # the fine-level esteig probe depends only on fine_diag/s_flat: run it
    # on a worker thread overlapped with the independent L-2/RAP chain
    # (numpy releases the GIL in BLAS; results are identical to the
    # sequential order)
    d_fine_w = np.where(fine_diag == 0.0, 1.0, fine_diag)
    fine_est = {}

    def _fine_esteig():
        try:
            fine_est["bounds"] = _esteig_bounds(fine_apply, d_fine_w, nu)
        except BaseException as e:       # re-raised at the join site
            fine_est["error"] = e

    th = threading.Thread(target=_fine_esteig)
    t_est0 = time.perf_counter()
    th.start()
    # per-level Jacobi diagonals + esteig bounds (levels coarsest..finest;
    # smoothers live on levels 1..nlevels-1, the fine one's from the thread)
    diags, bounds = [], []
    try:
        with _stage("L-2 Galerkin elements"):
            A1e = _galerkin_l2_elements(mesh, _p_loc_l2(nd), Bs, s_flat,
                                        keep_e, bc_u)
        with _stage("L-2 stencil + csr"):
            W1 = _stencil_from_l2_elements(A1e, mesh.m_el, nd)
            A1 = csr_from_stencil(W1, tuple(reversed(grids[-2])), nd)
        with _stage("deep Galerkin RAPs"):
            coarse_csrs = galerkin_coarse_operators(A1, prolongs) + [A1]
        for k in range(1, nlevels - 1):
            A = coarse_csrs[k]
            d = A.diagonal()
            d = np.where(d == 0.0, 1.0, d)
            with _stage(f"esteig level {k}"):
                emin, emax = _esteig_bounds(lambda v, A=A: A @ np.asarray(v),
                                            d, A.shape[0])
            diags.append(d)
            bounds.append((emin, emax))
    finally:
        with _stage("fine esteig join"):
            th.join()
    if "error" in fine_est:
        raise fine_est["error"]
    if _setup_profile():
        print(f"[setup] fine esteig total (overlapped): "
              f"{time.perf_counter() - t_est0:.2f} s", file=sys.stderr,
              flush=True)
    diags.append(d_fine_w)
    bounds.append(fine_est["bounds"])

    # coarse inverse (PCREDUNDANT + stable dense LU stand-in for UMFPACK)
    with _stage("coarse inverse"):
        coarse_inv = np.linalg.inv(coarse_csrs[0].toarray())

    # block stencils for every intermediate level 1..nlevels-2, including
    # the L-2 Galerkin level (built with A1, no re-extract)
    lvl_grids = [tuple(reversed(g)) for g in grids]   # reversed (z,y,x)
    stencils = []
    for k in range(1, nlevels - 1):
        if k == nlevels - 2:
            stencils.append(W1)
        else:
            stencils.append(stencil_from_csr(coarse_csrs[k],
                                             lvl_grids[k], nd))

    # Schur p-block: Mpscaled factored weights + Jacobi + Chebyshev bounds
    with _stage("Schur-pre assembly"):
        if lame:
            inv = 1.0 / coeff_qp["lambda"] + 1.0 / coeff_qp["mu"]
        else:
            inv = 1.0 / coeff_qp["eta"]
        pscale = -(fes.wq[None, :] * fes.detJ_p) * inv      # (nel, nqp)
        Sel = assemble_schur_pre(fes, coeff_qp, lame=lame)
        dmp = np.bincount(mesh.p_el_nodes.ravel(),
                          weights=np.einsum("eii->ei", Sel).ravel(),
                          minlength=mesh.np_)
        rows = np.broadcast_to(mesh.p_el_nodes[:, :, None],
                               Sel.shape).ravel()
        cols = np.broadcast_to(mesh.p_el_nodes[:, None, :],
                               Sel.shape).ravel()
        Mp = sp.coo_matrix((Sel.ravel(), (rows, cols)),
                           shape=(mesh.np_, mesh.np_)).tocsr()
    with _stage("p-block spectrum"):
        p_emin, p_emax = p_spectrum_bounds_assembled(
            Mp, dmp, p_spectrum_bounds(Sel))

    cfg = ABFConfig(ndim=nd, nlevels=nlevels,
                    cls_shapes=tuple(tuple(s) for s in pop.cls_shapes),
                    m_el=tuple(mesh.m_el),
                    level_grids=tuple(lvl_grids),
                    **(cfg_kw or {}))
    host = {
        "inv_diag_fine": 1.0 / diags[-1][perm[:nu]],
        "inv_diag_lvls": [(1.0 / diags[k - 1]).reshape(lvl_grids[k] + (nd,))
                          for k in range(1, nlevels - 1)],
        "stencils_w": stencils,
        "coarse_inv": coarse_inv,
        "bounds": bounds,
        "pscale": pscale,
        "inv_diag_p": (1.0 / dmp).reshape(tuple(reversed(mesh.nn_p))),
        "p_bounds": (p_emin, p_emax),
    }
    with _stage("device cast"):
        data = _device_data(pop, host, dtype, device)
    setup = {"mesh": mesh, "op64": op64, "aux64": tree_aux(op64),
             "rhs_diri": rhs_diri, "bc_mask": bc_mask, "x_bc": x_bc,
             "perm": perm, "iperm": iperm, "coarse_csrs": coarse_csrs,
             "Mp": Mp, "stencils_w": stencils}
    return cfg, data, setup


def _device_data(op, host, dtype, device):
    """Solver data on the device: tensors of `dtype`, and the Chebyshev
    bounds as numpy scalars of that dtype (the scalar recurrences run in
    the working precision, as in the JAX package)."""
    npdt = treeops.NP_DTYPE[dtype]

    def cast(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)
    return {
        "op": op,
        "aux": tree_aux(op),
        "inv_diag_fine": cast(host["inv_diag_fine"]),
        "inv_diag_lvls": [cast(d) for d in host["inv_diag_lvls"]],
        "stencils": [cast(W) for W in host["stencils_w"]],
        "coarse_inv": cast(host["coarse_inv"]),
        "bounds": [(npdt(b[0]), npdt(b[1])) for b in host["bounds"]],
        "pscale": cast(host["pscale"]),
        "inv_diag_p": cast(host["inv_diag_p"]),
        "p_bounds": (npdt(host["p_bounds"][0]), npdt(host["p_bounds"][1])),
    }


def config_from_dict(cfg_dict):
    """The port's ABFConfig from dataclasses.asdict of the JAX ABFConfig
    (its TPU matmul precisions are dropped)."""
    drop = ("matmul_precision", "pc_matmul_precision")
    kw = {k: v for k, v in cfg_dict.items() if k not in drop}
    for key in ("cls_shapes", "level_grids"):
        kw[key] = tuple(tuple(int(n) for n in s) for s in kw[key])
    kw["m_el"] = tuple(int(m) for m in kw["m_el"])
    return ABFConfig(**kw)


def data_from_numpy(cfg_dict, data_np, setup_np, device, dtype):
    """The port's (cfg, data, setup) from the JAX package's build_abf
    output brought to numpy, so both packages solve the same system from
    the same numbers.

    cfg_dict: dataclasses.asdict of the JAX ABFConfig (config_from_dict).
    data_np: the JAX
    `data` with numpy leaves (jax.device_get); its "op" only needs the
    ParityMatFreeOperator fields as attributes. setup_np: the JAX `setup`;
    its W-form "stencils_w" (the JAX data holds only the merged form), its
    float64 "sop" (natural order) and "mesh" are read."""
    cfg = config_from_dict(cfg_dict)
    m = setup_np["mesh"]
    mesh = SaddleMesh(m.ndim, tuple(m.m_el), tuple(m.size))
    jop = data_np["op"]
    op = ParityMatFreeOperator.from_arrays(
        jop.Bs, jop.Dm, jop.Np, jop.scale_visc, jop.fac, jop.facp_lam,
        jop.keep, jop.bc_mask, mesh, dtype=dtype, device=device,
        permuted=True)
    sop = setup_np["sop"]
    op64 = ParityMatFreeOperator.from_arrays(
        sop.Bs, sop.Dm, sop.Np, sop.scale_visc, sop.fac, sop.facp_lam,
        sop.keep, sop.bc_mask, mesh, dtype=torch.float64, device=device)
    host = {
        "inv_diag_fine": np.concatenate(
            [np.asarray(a).reshape(-1) for a in data_np["inv_diag_fine"]]),
        "inv_diag_lvls": [np.asarray(a) for a in data_np["inv_diag_lvls"]],
        "stencils_w": [np.asarray(W) for W in setup_np["stencils_w"]],
        "coarse_inv": data_np["coarse_inv"],
        "bounds": [(np.asarray(b0), np.asarray(b1))
                   for b0, b1 in data_np["bounds"]],
        "pscale": data_np["pscale"],
        "inv_diag_p": data_np["inv_diag_p"],
        "p_bounds": tuple(np.asarray(b) for b in data_np["p_bounds"]),
    }
    data = _device_data(op, host, dtype, device)
    setup = {"mesh": mesh, "op64": op64, "aux64": tree_aux(op64),
             "rhs_diri": np.asarray(setup_np["rhs_diri"]),
             "bc_mask": np.asarray(setup_np["bc_mask"]),
             "x_bc": np.asarray(setup_np["x_bc"]),
             "perm": np.asarray(setup_np["perm"]),
             "iperm": np.asarray(setup_np["iperm"]),
             "stencils_w": host["stencils_w"]}
    return cfg, data, setup


# --------------------------------------------------------------------------
# The composed solver
# --------------------------------------------------------------------------

def make_abf_solver(cfg):
    """Return solve(data, F, x0) -> (x, its, rnorm, state, hist) on flat
    parity-layout vectors (matfree.to_tree gives their grid views)."""
    nlev = cfg.nlevels

    def solver(data, F, x0):
        op = data["op"]
        aux = data["aux"]
        nu = op.nu

        # --- level applies (index k: 0 coarsest .. nlev-1 finest) ---------
        def fineA(xu):
            return mult_u_tree(op, aux, xu)

        def coarse_solve(xg):
            return (data["coarse_inv"] @ xg.reshape(-1)).reshape(xg.shape)

        lvl_ops, lvl_pc = {}, {}
        for k in range(1, nlev):
            if k == nlev - 1:
                lvl_ops[k] = fineA
                lvl_pc[k] = lambda t, d=data["inv_diag_fine"]: d * t
            else:
                lvl_ops[k] = (lambda x, W=data["stencils"][k - 1]:
                              stencil_apply(W, x))
                lvl_pc[k] = lambda t, d=data["inv_diag_lvls"][k - 1]: d * t

        pre_its = cfg.cheb_pre_its if cfg.cheb_pre_its > 0 else cfg.cheb_its

        def smooth(k, b, x0v, pre=False):
            emin, emax = data["bounds"][k - 1]
            # pre-smooths start from zero: x0_zero skips the initial A x0
            return treeops.cheb_smooth(lvl_ops[k], lvl_pc[k], emin, emax,
                                       pre_its if pre else cfg.cheb_its,
                                       b, x0v, x0_zero=pre)

        def vcycle(k, b):
            """PCMG multiplicative V-cycle from zero initial guess."""
            if k == 0:
                return coarse_solve(b)
            x = smooth(k, b, torch.zeros_like(b), pre=True)
            r = b - lvl_ops[k](x)
            if k == nlev - 1:
                xc = vcycle(k - 1, restrict_parity(r, cfg.cls_shapes,
                                                   cfg.m_el))
                x = prolong_parity(xc, cfg.cls_shapes, cfg.m_el) + x
            else:
                xc = vcycle(k - 1, restrict_grid(r, cfg.level_grids[k - 1]))
                x = x + prolong_grid(xc, cfg.level_grids[k])
            return smooth(k, b, x)

        def mg_pc(r):
            return vcycle(nlev - 1, r)

        # --- u-block solve (abf.opts:5-6) ---------------------------------
        if cfg.u_fixed_vcycles > 0:
            nfv = cfg.u_fixed_vcycles

            def gcr(ru):
                x = mg_pc(ru)
                for _ in range(nfv - 1):
                    x = mg_pc(ru - fineA(x)) + x
                return x, nfv, 0.0
        else:
            gcr = treeops.make_gcr(fineA, mg_pc, restart=cfg.gcr_restart,
                                   rtol=cfg.gcr_rtol, max_it=cfg.gcr_max_it)

        # --- Schur p-block: Chebyshev in Jacobi-preconditioned Mpscaled ---
        p_emin, p_emax = data["p_bounds"]

        def p_solve(bp):
            return treeops.cheb_smooth(
                lambda pg: mp_apply(op, data["pscale"], pg),
                lambda pg: data["inv_diag_p"] * pg, p_emin, p_emax,
                cfg.p_cheb_its, bp, torch.zeros_like(bp), x0_zero=True)

        # --- fieldsplit Schur UPPER (exSaddle.c:313-318) -------------------
        def pc_apply(t):
            yp = p_solve(t[nu:].view(op.p_shape))
            ru = t[:nu] - mult_up_tree(op, aux, yp)
            yu, _, _ = gcr(ru)
            return torch.cat([yu, yp.reshape(-1)])

        fgmres = treeops.make_fgmres(lambda t: mult_tree(op, aux, t),
                                     pc_apply, restart=cfg.restart,
                                     rtol=cfg.rtol, atol=cfg.atol,
                                     dtol=cfg.dtol, max_it=cfg.max_it,
                                     hist_len=cfg.hist_len)
        return fgmres(F, x0)

    return solver


def make_ir_solver(cfg, wdt, max_rounds=10):
    """Mixed-precision iterative refinement: float64 true-residual
    correction rounds around the ABF solve in the working dtype `wdt`.

    Semantics of the JAX package's make_ir_solver: at least one round; a
    diverged inner solve or a non-contracting correction REJECTS the update
    and stops (stalled); otherwise rounds continue until the float64
    residual falls below rtol * ||r0|| or n_rounds is hit.

    Returns solve(data, op64, aux64, F64, rtol, n_rounds) ->
    (x64, rounds, inner_total, rnorm, rnorm0, history, stalled)."""
    inner = make_abf_solver(cfg)

    def resid(op64, aux64, F64, x64):
        r = F64 - mult_tree(op64, aux64, x64)
        return r, float(treeops.tnorm(r))

    def solve(data, op64, aux64, F64, rtol, n_rounds):
        if n_rounds > max_rounds:
            raise ValueError(f"n_rounds {n_rounds} > max_rounds {max_rounds}")
        x64 = torch.zeros_like(F64)
        r64, rnorm0 = resid(op64, aux64, F64, x64)
        rnorm = rnorm0
        history = [rnorm0]
        rounds = inner_total = 0
        stalled = False
        while rounds < n_rounds:
            rt = r64.to(wdt)
            dx, its, _, state, _ = inner(data, rt, torch.zeros_like(rt))
            x_try = x64 + dx.to(torch.float64)
            r_try, rn_try = resid(op64, aux64, F64, x_try)
            rounds += 1
            inner_total += its
            stalled = not (state >= 0 and rn_try < rnorm)
            if stalled:
                break
            x64, r64, rnorm = x_try, r_try, rn_try
            history.append(rn_try)
            if rnorm <= rtol * rnorm0:
                break
        return x64, rounds, inner_total, rnorm, rnorm0, history, stalled

    return solve


class ABFSolver:
    """Host-facing wrapper: setup + solve + monitor history.

    device is required: nothing here probes for a GPU."""

    def __init__(self, mesh, fes, coeff_qp, bc_idx, bc_vals, *, device,
                 lame=False, dtype=torch.float64, nlevels=3, ir=False,
                 **cfg_kw):
        cfg, data, setup = build_abf(mesh, fes, coeff_qp, bc_idx, bc_vals,
                                     device=device, lame=lame, dtype=dtype,
                                     nlevels=nlevels, cfg_kw=cfg_kw)
        if ir:
            # the float64 residual operator's K1 node table: built here, so
            # its host-to-device copy does not fall into the first solve
            with _stage("ir op64 build"):
                op64 = setup["op64"]
                if op64.Bs.device.type == "cuda":
                    op64.node_table
        self._init(cfg, data, setup, dtype, device, ir)

    @classmethod
    def from_parts(cls, cfg, data, setup, *, device, dtype, ir=False):
        """Solver over (cfg, data, setup) built elsewhere, e.g. by
        data_from_numpy."""
        self = cls.__new__(cls)
        self._init(cfg, data, setup, dtype, device, ir)
        return self

    def _init(self, cfg, data, setup, dtype, device, ir):
        self.cfg, self.data, self.setup = cfg, data, setup
        self.mesh = setup["mesh"]
        self.dtype = dtype
        self.device = torch.device(device)
        self._solve = make_abf_solver(cfg)
        self._solve_ir_fn = make_ir_solver(cfg, dtype) if ir else None

    def vec_to_tree(self, x_flat, dtype=None):
        """Natural-ordering (ndof,) vector -> flat parity-layout tensor."""
        xp = np.asarray(x_flat)[self.setup["perm"]]
        return torch.as_tensor(xp, dtype=dtype or self.dtype,
                               device=self.device)

    def tree_to_vec(self, t):
        return t.cpu().numpy()[self.setup["iperm"]]

    def rhs_tree(self, coeff_qp=None, F_flat=None):
        """F_flat (natural ordering) in the solver's layout; coeff_qp is
        accepted for the JAX package's signature and not read."""
        if F_flat is None:
            raise ValueError("pass F_flat (natural ordering)")
        return self.vec_to_tree(F_flat)

    def solve(self, F_flat, x0_flat=None):
        """Solve A x = F. Returns dict with x (natural ordering), its,
        rnorm, reason, history (list of monitored residuals)."""
        Ft = self.vec_to_tree(F_flat)
        x0 = (self.vec_to_tree(x0_flat) if x0_flat is not None
              else torch.zeros_like(Ft))
        x, its, rnorm, state, hist = self._solve(self.data, Ft, x0)
        history = [float(h) for h in hist[: its + 1] if h >= 0.0]
        return {"x": self.tree_to_vec(x), "its": int(its),
                "rnorm": float(rnorm), "reason": treeops.reason_name(state),
                "history": history}

    def solve_ir(self, F_flat, rtol=1e-8, max_rounds=10):
        """Mixed-precision iterative refinement (construct with ir=True):
        inner solves in the working dtype, float64 true residuals.

        Returns dict with x (natural ordering, float64), rounds, inner_its
        (total), rnorm (true float64 residual), rnorm0, history (true
        residual per accepted round), stalled, converged."""
        if self._solve_ir_fn is None:
            raise ValueError("construct with ir=True")
        F64 = self.vec_to_tree(F_flat, dtype=torch.float64)
        x64, rounds, inner_total, rnorm, rnorm0, history, stalled = \
            self._solve_ir_fn(self.data, self.setup["op64"],
                              self.setup["aux64"], F64, rtol, max_rounds)
        return {"x": self.tree_to_vec(x64), "rounds": rounds,
                "inner_its": int(inner_total), "rnorm": rnorm,
                "rnorm0": rnorm0, "history": history, "stalled": stalled,
                "converged": rnorm <= rtol * rnorm0}
