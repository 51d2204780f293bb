"""The ABF (Approximate Block Factorization) saddle solver, in PyTorch.

The port of exsaddle_tpu/abf.py: the flagship solver configuration
(abf.opts:1-16): FGMRES(30, right PC, unpreconditioned norm) over
fieldsplit-Schur-UPPER, whose u-block is GCR(rtol 1e-2) preconditioned by a
Galerkin-MG V-cycle with Chebyshev(8)/Jacobi smoothers and a dense coarse
solve, and whose p-block is a fixed Chebyshev polynomial in the
Jacobi-preconditioned viscosity-scaled pressure mass matrix.

Multigrid structure (-saddle_fieldsplit_u_pc_mg_galerkin, abf.opts:13):
  - fine level: the factored matrix-free A00 apply, K1 on CUDA
    (kernels/a00.py), its Dirichlet terms and Chebyshev updates in K1's
    loads and store (kernels.a00.A00Op);
  - intermediate levels, including the Galerkin L-2 level: 3^nd-point block
    stencils W (*grid, 3^nd, nd, nd) extracted from the host Galerkin
    products;
  - coarsest: dense matvec with a precomputed inverse (PCREDUNDANT + LU).

Setup (build_abf) is host numpy, copied from the JAX package so both build
the same numbers; its last step casts the solver data to tensors on the
given device. On CUDA the solver then captures the whole solve, its Krylov
loops included, as one CUDA graph with conditional nodes
(DeviceLoopSolver), the port's counterpart of the JAX package's one jitted
solve; loop="host" keeps the loops on the host over captured fixed-work
bodies (make_abf_solver). Vectors are flat tensors in the parity-permuted dof order of
matfree.py; the "_tree" names of the JAX package are kept for the block
applies so each counterpart is easy to find."""

import contextlib
import os
import sys
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from exsaddle_tpu_torch import graphs, treeops
from exsaddle_tpu_torch import trace as tracing
from exsaddle_tpu_torch.kernels import krylov_ctl
from exsaddle_tpu_torch.treeops import ShardVec, first, smap
from exsaddle_tpu_torch.grid_ops import (gather_u_parity, scatter_u_parity,
                                         _gather_q1, _scatter_q1)
# K1's and K3's entries, called through their modules (a00.<entry>,
# mp.<entry>) so a caller may swap the fused forms for their twins
from exsaddle_tpu_torch.kernels import a00, mp
# stencil_accum and stencil_apply: K4's entries, this module's names for
# the block stencil apply (as exsaddle_tpu/abf.py's)
from exsaddle_tpu_torch.kernels.stencil import (  # noqa: F401
    StencilOp, stencil_accum, stencil_apply, stencil_offsets)
# the MG transfers: K5's entries under exsaddle_tpu/abf.py's names; the
# V-cycles call them through the module (transfer.<entry>), so a caller
# may swap them for their twins
from exsaddle_tpu_torch.kernels import transfer
from exsaddle_tpu_torch.kernels.transfer import (  # noqa: F401
    prolong_grid, prolong_parity, restrict_grid, restrict_parity)
from exsaddle_tpu_torch.matfree import (ParityMatFreeOperator,
                                        factored_host, parity_permutation,
                                        mult_tree, tree_aux)
from exsaddle_tpu_torch.mesh import SaddleMesh


# --------------------------------------------------------------------------
# Block applies on the parity operator (the fieldsplit blocks of the
# BC-eliminated saddle matrix, as PETSc's MatCreateSubMatrix extracts them)
# --------------------------------------------------------------------------

def _a00_keep(op, xu, ks):
    return a00.a00_apply(op, xu, keep=ks)


def _a00_masked(op, xu, ks, ms):
    return a00.a00_masked(op, (ks, ms), xu)


def mult_u_raw(op, aux, xu, halo_u=None):
    """The raw A00 (ks x_u) before the output's keep/mask terms: K1 with
    the keep in its loads; in a sharded layout (parallel/) per shard, with
    the interface planes of K1's output added by halo_u."""
    y = smap(_a00_keep, op, xu, aux[0])
    return y if halo_u is None else halo_u(y)


def mult_u_tree(op, aux, xu, halo_u=None):
    """A00 x_u (flat u vector): K1 with keep/mask Dirichlet elimination
    (unit diagonal on BC rows): the keep in K1's loads, and on one device
    the mask terms in its store (a00.a00_masked). In a sharded layout
    (parallel/) op, aux and xu are per shard and halo_u adds the interface
    planes of K1's raw output before the keep/mask terms, which stay torch
    ops there."""
    ks, ms, _, _ = aux
    if halo_u is None:
        return smap(_a00_masked, op, xu, ks, ms)
    return mult_u_raw(op, aux, xu, halo_u) * ks + ms * xu


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


def _mp_local(op, pscale, W, pg):
    return mp.mp_apply(op, pscale, W, pg)


def mp_apply(op, pscale, pg, halo_p=None, W=None):
    """Mpscaled x_p: viscosity-scaled pressure mass matrix in factored form
    (MatAssemble_Schur weights, femixedspace.c:2837-2948): K3 per shard
    (kernels/mp.py: the kernel on CUDA, on W; its plain version on the
    CPU, on the factored form).
    pscale: (nel, nqp) = -w_q detJp (1/eta) [Lame: (1/lambda + 1/mu)].
    W: Mpscaled's node stencil (mp_stencil), which the kernel reads."""
    yp = smap(_mp_local, op, pscale, W, pg)
    return yp if halo_p is None else halo_p(yp)


def mp_csr(Np, pscale, m_el):
    """The assembled Mpscaled (scipy CSR, float64) from its factored form:
    each element's Np^T diag(pscale_e) Np on its 2^nd corner nodes (the
    node grid x fastest, elements x fastest)."""
    import scipy.sparse as sp
    nd = len(m_el)
    nn = [m + 1 for m in m_el] + [1] * (3 - nd)
    Np, ps = np.asarray(Np, np.float64), np.asarray(pscale, np.float64)
    Me = np.einsum("qa,eq,qb->eab", Np, ps, Np)
    e = np.arange(ps.shape[0])
    ex, ey = e % m_el[0], (e // m_el[0]) % m_el[1]
    ez = e // (m_el[0] * m_el[1]) if nd == 3 else 0 * e
    node = np.stack([((ez + (c >> 2)) * nn[1] + ey + ((c >> 1) & 1)) * nn[0]
                     + ex + (c & 1) for c in range(2 ** nd)], 1)
    rows = np.repeat(node, 2 ** nd, 1).reshape(-1)
    cols = np.tile(node, (1, 2 ** nd)).reshape(-1)
    n = int(np.prod(nn))
    return sp.coo_matrix((Me.reshape(-1), (rows, cols)),
                         shape=(n, n)).tocsr()


def mp_stencil(Mp, nn_p):
    """K3's operand: the assembled Mpscaled's 3^ndim-point node stencil,
    (3^ndim, *rev(nn_p)) float64, slot-major (slots x-fastest over the
    offsets -1..1), zero where a neighbour is off the grid."""
    grid = tuple(reversed(tuple(nn_p)))
    W = stencil_from_csr(Mp, grid, 1).reshape(grid + (3 ** len(grid),))
    return np.ascontiguousarray(np.moveaxis(W, -1, 0))


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


# --------------------------------------------------------------------------
# Setup (host numpy; the same arithmetic as the JAX package's build)
# --------------------------------------------------------------------------

def _setup_profile():
    return os.environ.get("EXSADDLE_SETUP_PROFILE") == "1"


@contextlib.contextmanager
def _stage(name, trace=None, label=None, show=True):
    """A set-up stage: a host span of `trace` (trace.Trace; the device
    synchronised at both ends), and with EXSADDLE_SETUP_PROFILE=1 its
    time on stderr as `[setup] <label or name>: <s> s` (show=False: no
    line). With neither, nothing is timed."""
    shown = show and _setup_profile()
    if trace is None and not shown:
        yield
        return
    if trace is None:
        t0 = time.perf_counter_ns()
        yield
        t1 = time.perf_counter_ns()
    else:
        trace.host_open(name, sync=True)
        try:
            yield
        finally:
            s = trace.host_close(sync=True)
        t0, t1 = s.start, s.end
    if shown:
        print(f"[setup] {label or name}: {1e-9 * (t1 - t0):.2f} s",
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
    for s, off in enumerate(stencil_offsets(ndim)):
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
              dtype=torch.float64, nlevels=3, cfg_kw=None, trace=None):
    """Build (cfg, data, setup) for the ABF solve on `device`; its stages
    are host spans of `trace` (_stage) where one is given.

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

    with _stage("factored_host", trace):
        fd = factored_host(mesh, fes, coeff_qp, lame=lame)
    Bs, Dm_m, Np_m, fac = fd["Bs"], fd["Dm"], fd["Np"], fd["fac"]
    s_flat = fd["scale"]                          # (nel, nqp*ncomp), f64

    with _stage("parity op build", trace):
        pop = ParityMatFreeOperator.build(mesh, fes, coeff_qp, bc_mask,
                                          lame=lame, dtype=dtype,
                                          device=device, host=fd)
        perm, iperm = parity_permutation(mesh)

    # rhs_diri = -(A_raw x_bc), BC rows zeroed (femixedspace.c:2634-2643);
    # only the O(surface) elements touching a BC node contribute
    with _stage("rhs_diri", trace):
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
    with _stage("f64 saddle op", trace):
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

    with _stage("prolongations", trace):
        prolongs = [Prolongation(grids[k], grids[k + 1], nd)
                    for k in range(nlevels - 2)]

    with _stage("fine diagonal", trace):
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
    # per-level Jacobi diagonals + esteig bounds (levels coarsest..finest;
    # smoothers live on levels 1..nlevels-1, the fine one's from the thread)
    diags, bounds = [], []
    with _stage("esteig", trace, label="fine esteig total (overlapped)"):
        th.start()
        try:
            with _stage("L-2 Galerkin elements", trace):
                A1e = _galerkin_l2_elements(mesh, _p_loc_l2(nd), Bs, s_flat,
                                            keep_e, bc_u)
            with _stage("L-2 stencil + csr", trace):
                W1 = _stencil_from_l2_elements(A1e, mesh.m_el, nd)
                A1 = csr_from_stencil(W1, tuple(reversed(grids[-2])), nd)
            with _stage("deep Galerkin RAPs", trace):
                coarse_csrs = galerkin_coarse_operators(A1, prolongs) + [A1]
            for k in range(1, nlevels - 1):
                A = coarse_csrs[k]
                d = A.diagonal()
                d = np.where(d == 0.0, 1.0, d)
                with _stage(f"esteig level {k}", trace):
                    emin, emax = _esteig_bounds(
                        lambda v, A=A: A @ np.asarray(v), d, A.shape[0])
                diags.append(d)
                bounds.append((emin, emax))
        finally:
            with _stage("fine esteig join", trace):
                th.join()
        if "error" in fine_est:
            raise fine_est["error"]
    diags.append(d_fine_w)
    bounds.append(fine_est["bounds"])

    # coarse inverse (PCREDUNDANT + stable dense LU stand-in for UMFPACK)
    with _stage("coarse inverse", trace):
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
    with _stage("Schur-pre assembly", trace):
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
        W_p = mp_stencil(Mp, mesh.nn_p)
    with _stage("p-block spectrum", trace):
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
        "mp_stencil": W_p,
        "inv_diag_p": (1.0 / dmp).reshape(tuple(reversed(mesh.nn_p))),
        "p_bounds": (p_emin, p_emax),
    }
    with _stage("device cast", trace):
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
        "mp_stencil": cast(host["mp_stencil"]),
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
    float64 "sop" (natural order; K1's factors come from its Bs) and
    "mesh" are read."""
    cfg = config_from_dict(cfg_dict)
    m = setup_np["mesh"]
    mesh = SaddleMesh(m.ndim, tuple(m.m_el), tuple(m.size))
    jop = data_np["op"]
    sop = setup_np["sop"]
    op = ParityMatFreeOperator.from_arrays(
        jop.Bs, jop.Dm, jop.Np, jop.scale_visc, jop.fac, jop.facp_lam,
        jop.keep, jop.bc_mask, mesh, dtype=dtype, device=device,
        permuted=True, bs64=sop.Bs)
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
        "mp_stencil": mp_stencil(mp_csr(jop.Np, data_np["pscale"],
                                        mesh.m_el), mesh.nn_p),
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

def _mg_pc(cfg, data, fineA, trace=None):
    """mg_pc(r): one PCMG multiplicative V-cycle from a zero initial guess
    over the u-block hierarchy of `data`, fine level applied by fineA; the
    V-cycle and its coarse solve are device spans of `trace`
    (trace.span)."""
    nlev = cfg.nlevels

    # --- level applies (index k: 0 coarsest .. nlev-1 finest) -------------
    def coarse_solve(xg):
        with tracing.span(trace, "coarse_solve"):
            return (data["coarse_inv"] @ xg.reshape(-1)).reshape(xg.shape)

    # each level's operator and Jacobi inverse diagonal (K6 takes it for
    # the fine level's zero-guess first step, and K5's restrictions for
    # every other level's; K1's node gather on the fine level and K4 on the
    # stencil levels compute every other update in their store)
    lvl_ops, lvl_diag = {}, {}
    for k in range(1, nlev):
        if k == nlev - 1:
            lvl_ops[k] = fineA
            lvl_diag[k] = data["inv_diag_fine"]
        else:
            lvl_ops[k] = StencilOp(data["stencils"][k - 1])
            lvl_diag[k] = data["inv_diag_lvls"][k - 1]

    pre_its = cfg.cheb_pre_its if cfg.cheb_pre_its > 0 else cfg.cheb_its

    def smooth(k, b, x0v, pre=False, p1=None):
        emin, emax = data["bounds"][k - 1]
        # pre-smooths start from zero: x0_zero skips the initial A x0
        return treeops.cheb_smooth(lvl_ops[k], None, emin, emax,
                                   pre_its if pre else cfg.cheb_its,
                                   b, x0v, x0_zero=pre, diag=lvl_diag[k],
                                   p1=p1)

    def restrict(k, r):
        """Stencil level k's residual r on level k - 1's grid, and, where
        level k - 1 is smoothed, its first pre-smoothing iterate from the
        same K5 launch (else None)."""
        if k == 1:
            return transfer.restrict_grid(r, cfg.level_grids[0]), None
        emin, emax = data["bounds"][k - 2]
        return transfer.restrict_grid_cheb_first(
            r, cfg.level_grids[k - 1], lvl_diag[k - 1],
            float(treeops.cheb_scale(emin, emax)))

    def restrict_fine(b, y):
        """The fine residual b - y on L-2's grid, and, where L-2 is
        smoothed, its first pre-smoothing iterate from the same K5 launch
        (else None)."""
        if nlev == 2:
            return transfer.restrict_parity_residual(
                b, y, cfg.cls_shapes, cfg.m_el), None
        emin, emax = data["bounds"][nlev - 3]
        return transfer.restrict_parity_residual_cheb_first(
            b, y, cfg.cls_shapes, cfg.m_el, lvl_diag[nlev - 2],
            float(treeops.cheb_scale(emin, emax)))

    def vcycle(k, b, p1=None):
        if k == 0:
            return coarse_solve(b)
        x = smooth(k, b, torch.zeros_like(b), pre=True, p1=p1)
        if k == nlev - 1:
            xc = vcycle(k - 1, *restrict_fine(b, lvl_ops[k](x)))
            x = transfer.prolong_parity(xc, cfg.cls_shapes, cfg.m_el, add=x)
        else:
            xc = vcycle(k - 1, *restrict(k, lvl_ops[k].residual(b, x)))
            x = transfer.prolong_grid(xc, cfg.level_grids[k], add=x)
        return smooth(k, b, x)

    def mg_pc(r):
        with tracing.span(trace, "vcycle"):
            return vcycle(nlev - 1, r)

    return mg_pc


def _fieldsplit(b, p_solve, u_solve):
    """Fieldsplit Schur UPPER (exSaddle.c:313-318) on a saddle vector of
    the bodies `b`: the p-block solve, its A01 coupling (b["up"]) into the
    u right-hand side, then the u-block solve; b["split"] gives the u and
    p views."""
    def pc_apply(t):
        tu, tp = b["split"](t)
        yp = p_solve(tp)
        yu = u_solve(tu - b["up"](yp))
        return smap(lambda u, p: torch.cat([u, p.reshape(-1)]), yu, yp)

    return pc_apply


def _plain_bodies(cfg, data, trace=None):
    """The ABF solve's bodies on one device, under the keys every layout's
    bodies share (parallel/cart_abf._cart_bodies): mult (the full saddle
    apply), fineA (A00 with the Dirichlet terms: a kernels.a00.A00Op,
    whose Chebyshev updates the V-cycle's fine-level smoother calls),
    mg_pc (one V-cycle), p_solve (the p-block's Chebyshev polynomial), up
    (the A01 coupling of a pressure grid), split (a flat saddle vector's
    u head and its pressure tail as a grid, views), dots_u and dots_sad
    (the Gram-Schmidt dots: None, the plain ones) and, with
    cfg.u_fixed_vcycles > 0, fixed_pc (the fieldsplit PC with fixed
    V-cycles in place of GCR). trace: mg_pc's spans (_mg_pc)."""
    op, aux = data["op"], data["aux"]
    fineA = a00.A00Op(op, aux)
    mg_pc = _mg_pc(cfg, data, fineA, trace)
    p_emin, p_emax = data["p_bounds"]

    # --- Schur p-block: Chebyshev in Jacobi-preconditioned Mpscaled -------
    # (K3 with K6's update in its store: one launch per step after the
    # zero-guess first, which applies nothing and stays K6)
    p_mult = mp.MpOp(op, data["pscale"], data["mp_stencil"])

    def p_solve(bp):
        return treeops.cheb_smooth(
            p_mult, None, p_emin, p_emax, cfg.p_cheb_its, bp,
            torch.zeros_like(bp), x0_zero=True, diag=data["inv_diag_p"])

    bodies = {"mult": lambda t: mult_tree(op, aux, t), "fineA": fineA,
              "mg_pc": mg_pc, "p_solve": p_solve,
              "up": lambda yp: mult_up_tree(op, aux, yp),
              "split": lambda t: (t[:op.nu], t[op.nu:].view(op.p_shape)),
              "dots_u": None, "dots_sad": None}
    if cfg.u_fixed_vcycles > 0:
        nfv = cfg.u_fixed_vcycles

        def fixed_vcycles(ru):
            x = mg_pc(ru)
            for _ in range(nfv - 1):
                x = mg_pc(ru - fineA(x)) + x
            return x

        bodies["fixed_pc"] = _fieldsplit(bodies, p_solve, fixed_vcycles)
    return bodies


def host_solver(cfg, b, window):
    """solve(F, x0) -> (x, its, rnorm, state, hist) with the loops on the
    host over the bodies `b` (_plain_bodies' keys, in any layout):
    FGMRES over b["mult"], right-preconditioned by b["fixed_pc"] where
    there is one, else by the fieldsplit PC whose u-block is GCR over
    b["fineA"] preconditioned by b["mg_pc"]; the dots are b's. Returns
    (solve, the fieldsplit PC). window: treeops.make_gcr's."""
    if "fixed_pc" in b:
        pc_apply = b["fixed_pc"]
    else:
        gcr = treeops.make_gcr(b["fineA"], b["mg_pc"],
                               restart=cfg.gcr_restart, rtol=cfg.gcr_rtol,
                               max_it=cfg.gcr_max_it, dots=b["dots_u"],
                               window=window)
        pc_apply = _fieldsplit(b, b["p_solve"], lambda ru: gcr(ru)[0])
    solve = treeops.make_fgmres(b["mult"], pc_apply, restart=cfg.restart,
                                rtol=cfg.rtol, atol=cfg.atol, dtol=cfg.dtol,
                                max_it=cfg.max_it, hist_len=cfg.hist_len,
                                dots=b["dots_sad"], window=window)
    return solve, pc_apply


def make_abf_solver(cfg, data, eager=False, window=None):
    """Return (solve, bodies) over `data`: solve(F, x0) -> (x, its, rnorm,
    state, hist) on flat parity-layout vectors (matfree.to_tree gives their
    grid views); bodies is {name: callable}, the bodies that solve runs:
    mult (FGMRES's operator, the full saddle apply), mg_pc (one V-cycle on
    a u vector), p_solve (the p-block's Chebyshev polynomial on a pressure
    grid) and pc_apply (the fieldsplit PC on a saddle vector).

    This is the host-loop solve (ABFSolver loop="host", host_solver over
    _plain_bodies): GCR and FGMRES read one residual per iteration on the
    host and call the bodies. On a CUDA device, unless eager, the
    fixed-work bodies (no host read, no data-dependent branch) are
    captured here once as CUDA graphs (graphs.Captured) and replayed by
    every solve: mult, and mg_pc and p_solve or, with
    cfg.u_fixed_vcycles > 0, the whole pc_apply; each graph has its own
    memory pool, since they replay interleaved. The
    capture reads data's tensors by address, so the caller keeps `data`
    alive and never rebinds or writes its tensors while it solves.
    eager=True launches every op from Python (the plain version the graphs
    are held against); the CPU always does.

    window: GCR's and FGMRES's window arithmetic (treeops.make_gcr); by
    default treeops.host_window's rule: True on CUDA, where the host loop
    then rounds as the device loop (DeviceLoopSolver) does, bit for bit,
    and False on the CPU, whose host loop keeps its pinned bits."""
    op = data["op"]
    b = _plain_bodies(cfg, data)
    if window is None:
        window = treeops.host_window(op.Bs.device)
    if op.Bs.device.type == "cuda" and not eager:
        def zeros(shape):
            return torch.zeros(shape, dtype=op.Bs.dtype, device=op.Bs.device)
        if "fixed_pc" in b:
            b["fixed_pc"] = graphs.Captured(b["fixed_pc"], zeros((op.ndof,)))
        else:
            b["mg_pc"] = graphs.Captured(b["mg_pc"], zeros((op.nu,)))
            b["p_solve"] = graphs.Captured(b["p_solve"], zeros(op.p_shape))
        b["mult"] = graphs.Captured(b["mult"], zeros((op.ndof,)))
    solve, pc_apply = host_solver(cfg, b, window)
    return solve, {"mult": b["mult"], "mg_pc": b["mg_pc"],
                   "p_solve": b["p_solve"], "pc_apply": pc_apply}


def make_ir_solver(inner, wdt, max_rounds=10):
    """Mixed-precision iterative refinement: float64 true-residual
    correction rounds around `inner`, the ABF solve(F, x0) of
    make_abf_solver in the working dtype `wdt`.

    Semantics of the JAX package's make_ir_solver: at least one round; a
    diverged inner solve or a non-contracting correction REJECTS the update
    and stops (stalled); otherwise rounds continue until the float64
    residual falls below rtol * ||r0|| or n_rounds is hit.

    Returns solve(op64, aux64, F64, rtol, n_rounds) ->
    (x64, rounds, inner_total, rnorm, rnorm0, history, stalled)."""

    def resid(op64, aux64, F64, x64):
        r = F64 - mult_tree(op64, aux64, x64)
        return r, float(treeops.tnorm(r))

    def solve(op64, aux64, F64, rtol, n_rounds):
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
            dx, its, _, state, _ = inner(rt, torch.zeros_like(rt))
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


class DeviceIR:
    """The refinement loop's state (float64): F64 and the staged rtol and
    n_rounds (`inp`), x64, r64, and the control state of
    kernels/krylov_ctl.ir_ctl: sc [rnorm0, rnorm, rtol, n_rounds], ints
    [rounds, inner_total, done, stalled, accept], hist (max_rounds + 1)."""

    def __init__(self, ctl, n, device, max_rounds):
        f64 = torch.float64
        self.inp = torch.zeros(n + 2, dtype=f64, device=device)
        self.F64 = self.inp[:n]
        self.x64 = torch.zeros(n, dtype=f64, device=device)
        self.r64 = torch.zeros(n, dtype=f64, device=device)
        self.sc = torch.zeros(4, dtype=f64, device=device)
        self.ints = torch.zeros(5, dtype=torch.int32, device=device)
        self.hist = torch.zeros(max_rounds + 1, dtype=f64, device=device)
        self.p = ctl.pred_slots(1)
        self.c0 = ctl.count_slots("ir_solves", "ir_rounds")


class DeviceLoopSolver:
    """The ABF solve and its float64 iterative refinement with the loops on
    the device: ABFSolver's loop="device" / "plain" over _plain_bodies,
    and CartABFSolver's over parallel/cart_abf._cart_bodies (one per card
    across cards). The counterpart of the JAX package's make_abf_solver +
    make_ir_solver, whose GCR, FGMRES and refinement loops are
    lax.while_loops (exsaddle_tpu/abf.py:1106-1171,
    exsaddle_tpu/treeops.py:238-434).

    The solve is graphs.Pieces and Loops over static device tensors:
    treeops.DeviceFGMRES over bodies["mult"], preconditioned by the
    fieldsplit PC, whose u-block is a treeops.DeviceGCR loop over
    bodies["fineA"] and the V-cycle (or bodies["fixed_pc"], where there is
    one: one Piece); with ir, a DeviceIR round around it: cast to the
    working dtype, the inner solve, the float64 residual, accept/reject
    and history (exsaddle_tpu/abf.py:1143-1163). bodies: _plain_bodies'
    keys over saddle vectors of n entries; parts: None for plain tensors
    on `device`, else the number of shards, all on `device`, whose vectors
    are ShardVecs. ir_ops: (op64, aux64), the float64 residual operator
    (setup["op64"]), for the refinement (plain tensors only); None for a
    solver of the direct solve only. err: a card's peer error word
    (kernels.peer.CudaGroup), packed after the direct result's counts.

    graph=True (CUDA): the items become one graphs.ControlGraph, captured
    here (with ir, a second one for the direct solve, which shares the
    first's captured FGMRES loop); graph=False: graphs.run_plain drives
    the same items from Python, one host read per loop test (the CPU's
    path, and the reference on the card). A solve is stage (the input into
    pinned host memory), launch (the input's copy, one graph launch under
    set_sync_debug_mode("error"), the packed result's copy back) and
    finish (the wait, the result on the host). rtol and n_rounds are
    device scalars: a new tolerance replays the same graph. Counts,
    histories and x come back in one float64 buffer (`out`, the direct
    solve's `out_direct`); the counts by name are ctl.named(...) of it.

    trace (trace.Trace): the solve's device spans (the graph's or the plain
    driver's solve and pieces, and the spans at the work sites: FGMRES's
    saddle_apply, GCR's and FGMRES's gram_schmidt, the vcycle and its
    coarse_solve); with host_spans also the host spans launch, wait and
    read_out, after the caller's stage_in (ABFSolver opens solve_call and
    stage_in, and closes read_out and solve_call)."""

    # what a solve ran across cards (cart_abf.CartCardsSolver): none here
    collectives = None

    def __init__(self, cfg, bodies, n, dtype, device, graph, parts=None,
                 ir_ops=None, max_rounds=10, trace=None, err=None,
                 host_spans=False):
        self.device = dev = torch.device(device)
        ir = ir_ops is not None
        self.dtype, self.parts, self.n = dtype, parts, n
        self.max_rounds, self.err, self.host_spans = max_rounds, err, \
            host_spans
        self.ctl = ctl = graphs.Control(dev, trace=trace)
        b = bodies
        vdev = dev if parts is None else [dev] * parts
        self.m = m = n * (parts or 1)
        if "fixed_pc" in b:
            def pc_items(vin, zout):
                return [graphs.Piece(lambda: zout.copy_(b["fixed_pc"](vin)),
                                     "fieldsplit fixed V-cycles")]
            self.gcr = None
        else:
            # the u and p views' shapes, from a vector on no device
            u0, p0 = b["split"](self._x(torch.empty(m, device="meta")))
            self.gcr = gcr = treeops.DeviceGCR(
                ctl, b["fineA"], b["mg_pc"], first(u0).numel(), dtype, vdev,
                restart=cfg.gcr_restart, rtol=cfg.gcr_rtol,
                max_it=cfg.gcr_max_it, dots=b["dots_u"])
            yp = smap(lambda p: torch.zeros(p.shape, dtype=dtype, device=dev),
                      p0)

            def pc_items(vin, zout):
                # fieldsplit Schur UPPER (_fieldsplit), the u-block a loop
                def p_block():
                    vu, vp = b["split"](vin)
                    yp.copy_(b["p_solve"](vp))
                    gcr.start(vu - b["up"](yp))

                def assemble():
                    zu, zp = b["split"](zout)
                    zu.copy_(gcr.x)
                    zp.copy_(yp)
                return [graphs.Piece(p_block, "p-block + gcr start"),
                        gcr.loop(), graphs.Piece(assemble, "fieldsplit z")]
        self.fg = fg = treeops.DeviceFGMRES(
            ctl, b["mult"], pc_items, n, dtype, vdev,
            restart=cfg.restart, rtol=cfg.rtol, atol=cfg.atol, dtol=cfg.dtol,
            max_it=cfg.max_it, hist_len=cfg.hist_len, dots=b["dots_sad"])
        nc = ctl.counts.numel()
        fl = fg.loop()
        # the direct solve (solve): its input (F, then x0) and its result
        # buffer (x, its, rnorm, state, hist, counts, err) over the one
        # FGMRES loop
        self.inp = torch.zeros(2 * m, dtype=dtype, device=dev)
        self._F, self._x0 = self._x(self.inp[:m]), self._x(self.inp[m:])
        at = m + 3 + cfg.hist_len
        self.counts_at = slice(at, at + nc)
        self.out_direct = torch.zeros(
            at + nc + (0 if err is None else err.numel()),
            dtype=torch.float64, device=dev)
        self.direct_items = [graphs.Piece(self._init, "fgmres init"), fl,
                             graphs.Piece(self._pack, "fgmres result")]
        self.state = None
        if ir:
            self.state = st = DeviceIR(ctl, n, dev, max_rounds)
            self.out = torch.zeros(n + 5 + max_rounds + 1 + nc,
                                   dtype=torch.float64, device=dev)
            self.items = [graphs.Piece(self._ir_init, "ir init"),
                          graphs.Loop("while", st.p, [
                              graphs.Piece(self._ir_pre, "ir round start"),
                              fl,
                              graphs.Piece(self._ir_post, "ir round end")],
                              count=st.c0 + 1),
                          graphs.Piece(self._ir_pack, "ir result")]
        else:
            self.out, self.items = self.out_direct, self.direct_items
        self.op64, self.aux64 = ir_ops or (None, None)
        self._pinned = {}
        self._ir = False
        self.host_launches = 0
        # graph: the solver's own solve (the refinement with ir);
        # direct_graph: solve's, which with ir shares every captured piece
        # of the FGMRES loop with graph and captures only its own ends
        self.graph = self.direct_graph = None
        self.capture_seconds = 0.0
        if graph:
            self.graph = graphs.ControlGraph(self.items, ctl)
            self.direct_graph = (graphs.ControlGraph(
                self.direct_items, ctl, share=self.graph) if ir
                else self.graph)
            self.capture_seconds = self.graph.capture_seconds + (
                self.direct_graph.capture_seconds if ir else 0.0)

    def _x(self, flat):
        """flat as the solve's vector: itself, or with parts a ShardVec of
        its parts (one after another)."""
        return flat if self.parts is None else ShardVec(
            flat.view(self.parts, self.n))

    # --- pieces of the direct solve --------------------------------------
    def _init(self):
        self.ctl.counts.zero_()
        self.fg.F.copy_(self._F)
        self.fg.init(self._x0)

    def _pack(self):
        fg, o, m = self.fg, self.out_direct, self.m
        self._x(o[:m]).copy_(fg.x)
        o[m:m + 1].copy_(fg.ints[2])
        o[m + 1:m + 2].copy_(fg.sc[1])
        o[m + 2:m + 3].copy_(fg.ints[0])
        o[m + 3:self.counts_at.start].copy_(fg.hist)
        o[self.counts_at].copy_(self.ctl.counts)
        if self.err is not None:
            o[self.counts_at.stop:].copy_(self.err)


    # --- pieces of the refinement ----------------------------------------
    def _resid(self, x64):
        r = self.state.F64 - mult_tree(self.op64, self.aux64, x64)
        return r, treeops.tnorm(r)

    def _ir_init(self):
        st = self.state
        self.ctl.counts.zero_()
        st.sc[2:4].copy_(st.inp[self.n:])
        st.x64.zero_()
        r, rn0 = self._resid(st.x64)
        st.r64.copy_(r)
        krylov_ctl.ir_ctl(0, st, rn0, self.fg.ints, self.ctl)

    def _ir_pre(self):
        self.fg.F.copy_(self.state.r64.to(self.dtype))
        self.fg.init()

    def _ir_post(self):
        st = self.state
        x_try = st.x64 + self.fg.x.to(torch.float64)
        r_try, rn_try = self._resid(x_try)
        krylov_ctl.ir_ctl(1, st, rn_try, self.fg.ints, self.ctl)
        accept = st.ints[4].bool()
        st.x64.copy_(torch.where(accept, x_try, st.x64))
        st.r64.copy_(torch.where(accept, r_try, st.r64))

    def _ir_pack(self):
        n, st, o = self.n, self.state, self.out
        o[:n].copy_(st.x64)
        o[n:n + 2].copy_(st.ints[:2])
        o[n + 2:n + 3].copy_(st.sc[1])
        o[n + 3:n + 4].copy_(st.sc[0])
        o[n + 4:n + 5].copy_(st.ints[3])
        m = self.max_rounds + 1
        o[n + 5:n + 5 + m].copy_(st.hist)
        o[n + 5 + m:].copy_(self.ctl.counts)

    # --- a solve: stage, launch, finish ----------------------------------
    def _io(self):
        """The staged solve's (input, result buffer, items, graph): the
        refinement's or the direct solve's."""
        if self._ir:
            return self.state.inp, self.out, self.items, self.graph
        return self.inp, self.out_direct, self.direct_items, \
            self.direct_graph

    def _span(self, name):
        if self.host_spans and self.ctl.trace is not None:
            self.ctl.trace.host_next(name)

    def stage(self, *arrays, ir=False):
        """The next solve's input, `arrays` one after another (the direct
        solve's F and x0, per part with parts; with ir the refinement's
        F64, then [rtol, n_rounds]), written into pinned host memory on
        CUDA, which launch copies in, and into the input itself on the
        CPU. A float64 array cast to float32 rounds as astype does."""
        self._ir = ir
        inp, out, _, _ = self._io()
        if self.device.type == "cpu":
            buf = inp.numpy()
        else:
            if ir not in self._pinned:
                self._pinned[ir] = tuple(
                    torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for t in (inp, out))
            buf = self._pinned[ir][0].numpy()
        off = 0
        for a in map(np.asarray, arrays):
            buf[off:off + a.size] = a
            off += a.size

    def launch(self):
        """The staged solve: on the CPU its items run here (run_plain); on
        CUDA the input's copy, the items (one graph launch under
        set_sync_debug_mode("error"), or run_plain) and the result's copy
        back are enqueued on the device's current stream. host_launches:
        the counts the host moved meanwhile (0 when the whole solve is the
        one graph launch)."""
        inp, out, items, graph = self._io()
        self._span("launch")
        if self.device.type == "cpu":
            graphs.run_plain(items, self.ctl)
            return
        pin_in, pin_out = self._pinned[self._ir]
        before = graphs._counters()
        mode = torch.cuda.get_sync_debug_mode()
        if graph is not None:
            torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.cuda.device(self.device):
                inp.copy_(pin_in, non_blocking=True)
                if graph is None:
                    graphs.run_plain(items, self.ctl)
                else:
                    graph.launch()
                pin_out.copy_(out, non_blocking=True)
                self._done = torch.cuda.Event()
                self._done.record()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        self.host_launches = sum(b - a for a, b in zip(before,
                                                       graphs._counters()))

    def finish(self):
        """Wait for the launched solve; its result buffer on the host
        (numpy float64), what a graph ran added to the launch counts."""
        _, out, _, graph = self._io()
        if self.device.type == "cpu":
            self._span("read_out")
            return out.numpy().copy()
        self._span("wait")
        self._done.synchronize()
        self._span("read_out")
        res = self._pinned[self._ir][1].numpy().copy()
        if graph is not None:
            nc = self.ctl.counts.numel()
            graph.account(res[-nc:] if self._ir else res[self.counts_at])
        return res

    def _run(self, *arrays, ir=False):
        """stage, launch and finish: the solve's result buffer."""
        self.stage(*arrays, ir=ir)
        self.launch()
        return self.finish()

    def unpack(self, out):
        """(x, its, rnorm, state, hist, counts) of a direct solve's result
        buffer, x and hist in the working dtype (x a list of parts with
        parts)."""
        npdt, m = treeops.NP_DTYPE[self.dtype], self.m
        x = out[:m].astype(npdt)
        return ((x if self.parts is None else list(x.reshape(self.parts,
                                                             self.n))),
                int(out[m]), npdt(out[m + 1]), int(out[m + 2]),
                out[m + 3:self.counts_at.start].astype(npdt),
                out[self.counts_at].astype(np.int64))

    def solve(self, F, x0):
        """F, x0: numpy vectors in the solver's layout (with parts, lists
        of one per part). Returns (x, its, rnorm, state, hist, counts)."""
        arrays = (F, x0) if self.parts is None else list(F) + list(x0)
        return self.unpack(self._run(*arrays))

    def solve_ir(self, F64, rtol, n_rounds):
        """F64: numpy float64 in the solver's layout. Returns (x64, rounds,
        inner_total, rnorm, rnorm0, history, stalled, counts)."""
        if n_rounds > self.max_rounds:
            raise ValueError(f"n_rounds {n_rounds} > max_rounds "
                             f"{self.max_rounds}")
        n, m = self.n, self.max_rounds + 1
        out = self._run(F64, [rtol, n_rounds], ir=True)
        hist = out[n + 5:n + 5 + m]
        return (out[:n], int(out[n]), int(out[n + 1]), float(out[n + 2]),
                float(out[n + 3]), [float(h) for h in hist if h >= 0.0],
                bool(out[n + 4]), out[n + 5 + m:].astype(np.int64))


class ABFSolver:
    """Host-facing wrapper: setup + solve + monitor history.

    device is required: nothing here probes for a GPU. loop picks who
    runs the Krylov loops:
    - "device" (the default on CUDA unless eager): DeviceLoopSolver over
      _plain_bodies (the class parallel/cart_abf runs over its sharded
      bodies, on one card and on each card). On
      CUDA the whole solve (with ir, the whole refinement) is one CUDA
      graph with conditional nodes, captured once at construction (setup
      stage "graph capture"); a solve is one graph launch and no host
      read. On the CPU, which has no graphs, it runs as "plain".
    - "plain": DeviceLoopSolver's steps driven from Python
      (graphs.run_plain), one host read of a loop predicate per test: the
      reference the graph is held against.
    - "host" (the default on the CPU, and with eager=True): make_abf_solver;
      GCR, FGMRES and the rounds read their residuals on the host; on CUDA
      the fixed-work bodies are captured graphs (graphs.Captured) unless
      eager=True launches every op from Python, and the Krylov arithmetic
      is the device loop's (window=True), so "host" gives "device"'s bits.
      eager applies to "host" only.
    The graphs read the tensors of `data` by address: the solver holds
    `data` for its lifetime and never rebinds it, and solvers built
    from_parts over one `data` each capture their own graphs. A failure to
    build or launch the device loop raises; nothing falls back.

    trace: a trace.Trace (of this device) or None (the default: nothing is
    traced and the captured graphs hold exactly the untraced nodes). With
    one, the constructor is a host span `build` over its set-up stages
    (each synchronised, _stage), each solve a host span `solve_call` over
    `stage_in`, `launch`, `wait` and `read_out`, and the device loop's
    solve, pieces and work sites device spans (DeviceLoopSolver); a traced
    solve gives the untraced bits. The device and plain loops only.
    Results of the device and plain loops carry "counts" (Control's loop
    counts by name); kernel_nodes(counts) counts what the graph ran."""

    def __init__(self, mesh, fes, coeff_qp, bc_idx, bc_vals, *, device,
                 lame=False, dtype=torch.float64, nlevels=3, ir=False,
                 eager=False, loop=None, trace=None, **cfg_kw):
        with _stage("build", trace, show=False):
            cfg, data, setup = build_abf(mesh, fes, coeff_qp, bc_idx,
                                         bc_vals, device=device, lame=lame,
                                         dtype=dtype, nlevels=nlevels,
                                         cfg_kw=cfg_kw, trace=trace)
            if ir:
                # the float64 residual operator's K1 node table: built
                # here, so its host-to-device copy does not fall into the
                # first solve
                with _stage("ir op64 build", trace):
                    op64 = setup["op64"]
                    if op64.Bs.device.type == "cuda":
                        op64.node_table
            self._init(cfg, data, setup, dtype, device, ir, eager, loop,
                       trace)

    @classmethod
    def from_parts(cls, cfg, data, setup, *, device, dtype, ir=False,
                   eager=False, loop=None, trace=None):
        """Solver over (cfg, data, setup) built elsewhere, e.g. by
        data_from_numpy; on CUDA it captures its graphs against these
        tensors."""
        self = cls.__new__(cls)
        with _stage("build", trace, show=False):
            self._init(cfg, data, setup, dtype, device, ir, eager, loop,
                       trace)
        return self

    def _init(self, cfg, data, setup, dtype, device, ir, eager, loop,
              trace):
        self.cfg, self.data, self.setup = cfg, data, setup
        self.mesh = setup["mesh"]
        self.dtype = dtype
        self.device = torch.device(device)
        self.capture_seconds = 0.0
        cuda = self.device.type == "cuda"
        if loop is None:
            loop = "device" if cuda and not eager else "host"
        if loop not in ("device", "plain", "host"):
            raise ValueError(f"loop {loop!r}: 'device', 'plain' or 'host'")
        if eager and loop != "host":
            raise ValueError(f"eager=True runs the host loop, not {loop!r}")
        if trace is not None and loop == "host":
            raise ValueError("trace= traces the device and plain loops, "
                             "not loop 'host'")
        self.loop = loop
        self.trace = trace
        self._dev = None
        self._solve_ir_fn = None
        if loop != "host":
            self._solve = None
            self._bodies = {}
            graph = cuda and loop == "device"
            ir_ops = (setup["op64"], setup["aux64"]) if ir else None
            with _stage("graph capture", trace) if graph else \
                    contextlib.nullcontext():
                op = data["op"]
                self._dev = DeviceLoopSolver(
                    cfg, _plain_bodies(cfg, data, trace), op.ndof, dtype,
                    op.Bs.device, graph, ir_ops=ir_ops, trace=trace,
                    host_spans=True)
            self.capture_seconds = self._dev.capture_seconds
            return
        if cuda and not eager:
            t0 = time.perf_counter()
            with _stage("graph capture"):
                self._solve, self._bodies = make_abf_solver(cfg, data)
            self.capture_seconds = time.perf_counter() - t0
        else:
            self._solve, self._bodies = make_abf_solver(cfg, data,
                                                        eager=eager)
        self._solve_ir_fn = make_ir_solver(self._solve, dtype) if ir \
            else None

    def bodies(self):
        """{name: callable}: the bodies the solve runs (make_abf_solver),
        graphs.Captured where captured."""
        return dict(self._bodies)

    def kernel_nodes(self, counts):
        """The kernel nodes the device loop's graph ran for one solve's
        "counts" (solve_ir's graph where counts has ir_solves, else
        solve's): graphs.ControlGraph.kernel_nodes, trace marks left out,
        computed from the captured graphs when called. None where the
        solve runs no graph (the CPU, loop "plain" or "host")."""
        dev = self._dev
        if dev is None or dev.graph is None:
            return None
        graph = dev.graph if counts.get("ir_solves") else dev.direct_graph
        return graph.kernel_nodes(dev.ctl.slots(counts))

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

    def _call_open(self):
        """With a trace: open solve_call (a new solve id) and stage_in."""
        if self.trace is not None:
            self.trace.host_open("solve_call", new_solve=True)
            self.trace.host_open("stage_in")

    def _call_close(self, res):
        """With a trace: close read_out and solve_call. Returns res."""
        if self.trace is not None:
            self.trace.host_close()
            self.trace.host_close()
        return res

    def solve(self, F_flat, x0_flat=None):
        """Solve A x = F. Returns dict with x (natural ordering), its,
        rnorm, reason, history (list of monitored residuals) and, on the
        device and plain loops, counts (the loops' counts by name)."""
        if self._dev is not None:
            self._call_open()
            perm = self.setup["perm"]
            F = np.asarray(F_flat)[perm]
            x0 = (np.asarray(x0_flat)[perm] if x0_flat is not None
                  else np.zeros_like(F))
            x, its, rnorm, state, hist, counts = self._dev.solve(F, x0)
            return self._call_close({
                "x": x[self.setup["iperm"]], "its": its,
                "rnorm": float(rnorm), "reason": treeops.reason_name(state),
                "history": [float(h) for h in hist[: its + 1] if h >= 0.0],
                "counts": self._dev.ctl.named(counts)})
        Ft = self.vec_to_tree(F_flat)
        x0 = (self.vec_to_tree(x0_flat) if x0_flat is not None
              else torch.zeros_like(Ft))
        x, its, rnorm, state, hist = self._solve(Ft, x0)
        history = [float(h) for h in hist[: its + 1] if h >= 0.0]
        return {"x": self.tree_to_vec(x), "its": int(its),
                "rnorm": float(rnorm), "reason": treeops.reason_name(state),
                "history": history}

    def solve_ir(self, F_flat, rtol=1e-8, max_rounds=10):
        """Mixed-precision iterative refinement (construct with ir=True):
        inner solves in the working dtype, float64 true residuals.

        Returns dict with x (natural ordering, float64), rounds, inner_its
        (total), rnorm (true float64 residual), rnorm0, history (true
        residual per accepted round), stalled, converged and, on the device
        and plain loops, counts (the loops' counts by name)."""
        if self._dev is not None:
            if self._dev.state is None:
                raise ValueError("construct with ir=True")
            self._call_open()
            F64 = np.asarray(F_flat, np.float64)[self.setup["perm"]]
            (x64, rounds, inner_total, rnorm, rnorm0, history, stalled,
             counts) = self._dev.solve_ir(F64, rtol, max_rounds)
            return self._call_close({
                "x": x64[self.setup["iperm"]], "rounds": rounds,
                "inner_its": inner_total, "rnorm": rnorm, "rnorm0": rnorm0,
                "history": history, "stalled": stalled,
                "converged": rnorm <= rtol * rnorm0,
                "counts": self._dev.ctl.named(counts)})
        if self._solve_ir_fn is None:
            raise ValueError("construct with ir=True")
        F64 = self.vec_to_tree(F_flat, dtype=torch.float64)
        x64, rounds, inner_total, rnorm, rnorm0, history, stalled = \
            self._solve_ir_fn(self.setup["op64"], self.setup["aux64"], F64,
                              rtol, max_rounds)
        return {"x": self.tree_to_vec(x64), "rounds": rounds,
                "inner_its": int(inner_total), "rnorm": rnorm,
                "rnorm0": rnorm0, "history": history, "stalled": stalled,
                "converged": rnorm <= rtol * rnorm0}
