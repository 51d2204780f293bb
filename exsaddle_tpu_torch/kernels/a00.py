"""K1: the fused velocity-block (A00) apply, hand-written for Hopper,
with the fine level's Dirichlet terms and Chebyshev update in its loads and
store.

    y_u = sum_e G_e^T Bs^T diag(s_e) Bs G_e x_u      (no Dirichlet masks)

Replaces exsaddle_tpu/pallas_apply.py:make_pallas_mult_u (the repo's one
Pallas kernel) and, on the single-device fine level, the keep/mask terms of
exsaddle_tpu/abf.py:56 mult_u_tree and the Chebyshev update of K6
(kernels/cheb.py). Source: csrc/a00_apply.cu; built by kernels/_build.py.

Entries, each on a CUDA tensor one apply of the kernel (or a raise), on a
CPU tensor its twin, any other device a raise; aux is matfree.tree_aux's
(ks, ms, ...):

    a00_apply(op, xu, keep=None)       A00 (xu keep): keep in the loads
    a00_masked(op, aux, xu)            A00 (xu ks) ks + ms xu
    a00_cheb_first(op, aux, b, x0, d, scale)
                                       cheb.cheb_first(b, a00_masked(x0), d,
                                       x0, scale)
    a00_cheb_step(op, aux, b, p_k, p_km1, d, scale, omega)
                                       cheb.cheb_step(b, a00_masked(p_k), d,
                                       p_k, p_km1, scale, omega)

The twins (TWINS) are the unfused apply (the kernel on CUDA,
`a00_apply_plain`, the same arithmetic in PyTorch ops, on the CPU) followed
by the ops the port issued before the fusion; each fused form is bitwise
its twin. `A00Op(op, aux)` is the fine-level operator the solvers hand to
treeops.cheb_smooth and GCR: called, the mask form; its cheb_first and
cheb_step the fused updates.

One apply is two launches: the element products into a scratch (nel, ncol)
array (the keep applied to each landed x tile), then a node gather that sums
each dof's element contributions in the order of `node_gather_table` (held
on the device by the operator, ParityMatFreeOperator.node_table) and, in the
fused forms, computes the epilogue in its store.

The 3D element products run by sum factorization, from the one-axis
factors of Bs that the operator holds (op.factors, matfree.strain_factors
of the float64 Bs it was built from): the nine gradient fields by one-axis
3x3 contractions and back (`a00_factored_plain` is that arithmetic in
PyTorch). 2D takes the dense products with Bs. LAUNCHES.factored counts
the applies that took the factored route."""

import ctypes

import numpy as np
import torch

from exsaddle_tpu_torch.grid_ops import (split_u_parity, gather_u_parity,
                                         scatter_u_parity)
from exsaddle_tpu_torch.kernels import _build, cheb

# the launch forms, by the name the kernels line and the counters use:
# the plain apply, the keep in the loads, and the three store epilogues
FORMS = ("a00_apply", "a00_apply_keep", "a00_masked", "a00_cheb_first",
         "a00_cheb_step")
_EPI = {"a00_apply": 0, "a00_apply_keep": 0, "a00_masked": 1,
        "a00_cheb_first": 2, "a00_cheb_step": 3}


class LaunchCount:
    """Device launches (`n`) and applies (`applies`) that a wrapper sent to
    its kernels, the applies of each form (`by`, FORMS) and those whose
    element products were factored (`factored`). Plain-version calls are
    not counted. Inside a CUDA graph capture the wrapper launches nothing;
    graphs.Captured takes its counts back out and adds them on every
    replay."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.n = 0
        self.applies = 0
        self.factored = 0
        self.by = dict.fromkeys(FORMS, 0)


LAUNCHES = LaunchCount()

# device launches of one apply: the element kernel and the node gather
KERNELS_PER_APPLY = 2

# (nqp * ncomp rows, 3^nd * nd columns) of Bs per dimension
_BS_SHAPE = {2: (27, 18), 3: (162, 81)}

_bound = False


def node_gather_table(m_el):
    """(nnodes_u, 2^nd) int32 ELL table of the node gather. Row n is velocity
    node n in the flat vector's parity order (dof nd*n + a); its entries are
    e * ncol + nd * li for every element e holding the node as its local node
    li (column nd * li + a of that element's row of Ye), ascending in li,
    padded with -1. Summing in this order repeats grid_ops.scatter_u_parity's
    slice adds (local node by local node) exactly."""
    m_el = tuple(int(m) for m in m_el)
    nd = len(m_el)
    nel = int(np.prod(m_el))
    ncol = 3 ** nd * nd
    if nel * ncol >= 2 ** 31:
        raise ValueError(f"node_gather_table: {nel} elements overflow int32")
    m = np.array(m_el)
    # class p: nodes (m + 1 - bit_a(p)) along axis a, classes one after another
    cls_n = [m + 1 - np.array([(p >> a) & 1 for a in range(nd)])
             for p in range(2 ** nd)]
    cls_off = np.concatenate([[0], np.cumsum([np.prod(c) for c in cls_n])])
    e = np.arange(nel)
    ec = [e % m[0], (e // m[0]) % m[1]] + ([e // (m[0] * m[1])]
                                           if nd == 3 else [])
    nodes, vals = [], []
    for li in range(3 ** nd):
        loc = [(li // 3 ** a) % 3 for a in range(nd)]
        p = sum((loc[a] & 1) << a for a in range(nd))
        idx = np.zeros(nel, dtype=np.int64)
        for a in reversed(range(nd)):
            idx = idx * cls_n[p][a] + ec[a] + (loc[a] >> 1)
        nodes.append(cls_off[p] + idx)
        vals.append(e * ncol + nd * li)
    nodes = np.concatenate(nodes)
    vals = np.concatenate(vals)
    order = np.argsort(nodes, kind="stable")   # keeps li ascending per node
    nodes, vals = nodes[order], vals[order]
    nnodes = int(cls_off[-1])
    start = np.searchsorted(nodes, np.arange(nnodes))
    slot = np.arange(nodes.size) - start[nodes]
    table = np.full((nnodes, 2 ** nd), -1, dtype=np.int32)
    table[nodes, slot] = vals
    return table


def keep_bit_table(op):
    """(nel, ceil(ncol / 32)) int32 table of op's Dirichlet keep vector
    (op.keep[:nu]) as K1's element kernel reads it: bit c % 32 of word
    c // 32 of row e is the keep of element e's column c (the x entry
    grid_ops.gather_u_parity puts there), on op's device. The keep must
    hold only 0.0 and 1.0: the kernel multiplies x by 1.0 or 0.0 from the
    bit, which rounds as xu * ks only then. Built with a host read, so
    before any capture (the solvers' warm-up runs build it, as
    node_table)."""
    nd = len(op.m_el)
    ks = op.keep[: op.nu].detach().cpu()
    if not bool(((ks == 0) | (ks == 1)).all()):
        raise ValueError("keep_bit_table: the keep vector holds values "
                         "other than 0.0 and 1.0")
    cols = gather_u_parity(split_u_parity(torch.arange(op.nu), op.cls_shapes,
                                          nd), op.m_el)
    bits = (ks[cols] != 0).numpy()
    nel, ncol = bits.shape
    nw = -(-ncol // 32)
    bits = np.concatenate([bits, np.zeros((nel, 32 * nw - ncol), bool)], 1)
    words = (bits.reshape(nel, nw, 32).astype(np.uint64)
             << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    return torch.as_tensor(words.view(np.int32), device=op.Bs.device)


def _fn(dtype, fused=False):
    """(library, the C entry): a00_apply_* (the plain apply) or
    a00_fused_* (keep and epilogue)."""
    global _bound
    lib = _build.load()
    if not _bound:
        for name in ("a00_apply_f32", "a00_apply_f64"):
            f = getattr(lib, name)
            f.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
            f.restype = ctypes.c_int
        for name in ("a00_fused_f32", "a00_fused_f64"):
            f = getattr(lib, name)
            f.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_double] * 2 + [
                ctypes.c_int] * 5 + [ctypes.c_void_p]
            f.restype = ctypes.c_int
        lib.a00_error_string.argtypes = [ctypes.c_int]
        lib.a00_error_string.restype = ctypes.c_char_p
        _bound = True
    kind = "a00_fused" if fused else "a00_apply"
    return lib, getattr(lib, kind + ("_f32" if dtype == torch.float32
                                     else "_f64"))


def a00_apply_plain(op, xu):
    """The plain PyTorch version: gather -> @Bs^T -> *scale_visc -> @Bs ->
    scatter."""
    nd = len(op.m_el)
    xe = gather_u_parity(split_u_parity(xu, op.cls_shapes, nd), op.m_el)
    yue = ((xe @ op.Bs.T) * op.scale_visc) @ op.Bs
    return scatter_u_parity(yue, op.m_el, op.cls_shapes)


def factored_products(F, xe, scale):
    """The factored element products, ((xe Bs^T) * scale) Bs for a Bs with
    one-axis factors F (matfree.strain_factors, (3, 2, 3, 3): N_b = F[b, 0],
    D_b = F[b, 1]), xe (nel, 81) and scale (nel, 162), in the contraction
    order of the kernel: x, y, z forward, the strains and their scaling at
    each Gauss point, then z, y, x transposed."""
    nel = xe.shape[0]
    # u[e, b, lz, ly, lx]: component b at local node lx + 3 ly + 9 lz
    u = xe.reshape(nel, 3, 3, 3, 3).permute(0, 4, 1, 2, 3)
    (Nx, Dx), (Ny, Dy), (Nz, Dz) = F[0], F[1], F[2]
    one = "ebzyl,ql->ebzyq"            # a contraction along x
    xN, xD = torch.einsum(one, u, Nx), torch.einsum(one, u, Dx)
    two = "ebzlx,ql->ebzqx"            # along y
    NN, ND = torch.einsum(two, xN, Ny), torch.einsum(two, xN, Dy)
    DN = torch.einsum(two, xD, Ny)
    three = "eblyx,ql->ebqyx"          # along z
    # g[e, b, a]: du_b / dx_a at the Gauss points (qz, qy, qx)
    g = torch.stack([torch.einsum(three, DN, Nz),
                     torch.einsum(three, ND, Nz),
                     torch.einsum(three, NN, Dz)], 2)
    s = scale.reshape(nel, 3, 3, 3, 6).permute(0, 4, 1, 2, 3)
    sig = [g[:, a, a] * s[:, a] for a in range(3)] + [
        (g[:, a, b] + g[:, b, a]) * s[:, 3 + r]
        for r, (a, b) in enumerate(((0, 1), (0, 2), (1, 2)))]
    shear = {(0, 1): sig[3], (0, 2): sig[4], (1, 2): sig[5]}
    # t[e, a, d]: the field that meets dN/dx_d in output component a
    t = torch.stack([torch.stack(
        [sig[a] if d == a else shear[min(a, d), max(a, d)]
         for d in range(3)], 1) for a in range(3)], 1)
    back = "ebqyx,ql->eblyx"           # transposed, along z
    t0, t1 = torch.einsum(back, t[:, :, 0], Nz), torch.einsum(
        back, t[:, :, 1], Nz)
    t2 = torch.einsum(back, t[:, :, 2], Dz)
    back = "ebzqx,ql->ebzlx"           # along y
    sy = torch.einsum(back, t2, Ny) + torch.einsum(back, t1, Dy)
    r = torch.einsum(back, t0, Ny)
    back = "ebzyq,ql->ebzyl"           # along x
    y = torch.einsum(back, sy, Nx) + torch.einsum(back, r, Dx)
    return y.permute(0, 2, 3, 4, 1).reshape(nel, 81)


def a00_factored_plain(op, xu):
    """The plain PyTorch version of the factored route: gather ->
    factored_products with op.factors -> scatter."""
    nd = len(op.m_el)
    xe = gather_u_parity(split_u_parity(xu, op.cls_shapes, nd), op.m_el)
    F = torch.as_tensor(op.factors, dtype=xe.dtype, device=xe.device)
    yue = factored_products(F, xe, op.scale_visc)
    return scatter_u_parity(yue, op.m_el, op.cls_shapes)


def _check(op, xu, **vecs):
    """Refuse what the kernel cannot take: ndim, dtype, int32 indices, a
    keep other than the operator's own (the kernel reads op.keep_bits),
    a 3D operator without its float64 factors, and the shape, dtype,
    device and layout of xu, Bs, scale_visc and the fused forms'
    nu-vectors (vecs: keep, ks, ms, b, d, p_km1)."""
    nd = len(op.m_el)
    if nd not in _BS_SHAPE:
        raise ValueError(f"a00_apply: ndim {nd} not supported")
    if xu.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"a00_apply: dtype {xu.dtype} not supported")
    nel = int(np.prod(op.m_el))
    if op.nu >= 2 ** 31 or nel * _BS_SHAPE[nd][1] >= 2 ** 31:
        raise ValueError(f"a00_apply: {op.nu} dofs overflow int32 indices")
    keep = vecs.get("keep")
    if keep is not None and keep.data_ptr() != op.keep.data_ptr():
        raise ValueError("a00_apply: keep must be the operator's own keep "
                         "vector op.keep[:nu] (the kernel reads it as "
                         "op.keep_bits)")
    F = op.factors
    if nd == 3 and not (isinstance(F, np.ndarray) and F.dtype == np.float64
                        and F.shape == (3, 2, 3, 3)
                        and F.flags.c_contiguous):
        raise ValueError("a00_apply: a 3D operator needs Bs's one-axis "
                         "factors, a (3, 2, 3, 3) float64 array "
                         "(op.factors: matfree.strain_factors of the "
                         "float64 Bs it was built from)")
    want = {"xu": (xu, (op.nu,)), "Bs": (op.Bs, _BS_SHAPE[nd]),
            "scale_visc": (op.scale_visc, (nel, _BS_SHAPE[nd][0])),
            **{k: (v, (op.nu,)) for k, v in vecs.items()}}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"a00_apply: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.dtype != xu.dtype or t.device != xu.device:
            raise ValueError(f"a00_apply: {name} is {t.dtype} on {t.device}"
                             f", x is {xu.dtype} on {xu.device}")
        if not t.is_contiguous():
            raise ValueError(f"a00_apply: {name} is not contiguous")


def _device(name, xu):
    """Whether xu calls for the kernel (CUDA) or the twin (CPU)."""
    if xu.device.type == "cpu":
        return False
    if xu.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {xu.device}")
    return True


def _launch(form, op, xu, keep=None, ks=None, ms=None, b=None, d=None,
            p_km1=None, scale=0.0, omega=0.0):
    vecs = {k: v for k, v in (("keep", keep), ("ks", ks), ("ms", ms),
                              ("b", b), ("d", d), ("p_km1", p_km1))
            if v is not None}
    _check(op, xu, **vecs)
    fused = form != "a00_apply"
    lib, fn = _fn(xu.dtype, fused)
    nd = len(op.m_el)
    mx, my = op.m_el[0], op.m_el[1]
    mz = op.m_el[2] if nd == 3 else 1
    table = op.node_table
    fac = op.factors.ctypes.data if nd == 3 else None

    def ptr(t):
        return ctypes.c_void_p(0 if t is None else t.data_ptr())

    with torch.cuda.device(xu.device):
        ye = torch.empty(op.scale_visc.shape[0], _BS_SHAPE[nd][1],
                         dtype=xu.dtype, device=xu.device)
        y = torch.empty_like(xu)
        stream = torch.cuda.current_stream(xu.device).cuda_stream
        if fused:
            err = fn(xu.data_ptr(),
                     ptr(None if keep is None else op.keep_bits),
                     op.scale_visc.data_ptr(), op.Bs.data_ptr(), fac,
                     table.data_ptr(), ye.data_ptr(),
                     y.data_ptr(), ptr(ks), ptr(ms), ptr(b), ptr(d),
                     ptr(p_km1), float(scale), float(omega), _EPI[form], nd,
                     mx, my, mz, stream)
        else:
            err = fn(xu.data_ptr(), op.scale_visc.data_ptr(),
                     op.Bs.data_ptr(), fac, table.data_ptr(), ye.data_ptr(),
                     y.data_ptr(), nd, mx, my, mz, stream)
    if err != 0:
        raise RuntimeError(f"{form} kernel launch failed: "
                           f"{lib.a00_error_string(err).decode()} ({err})")
    LAUNCHES.n += KERNELS_PER_APPLY
    LAUNCHES.applies += 1
    LAUNCHES.factored += int(fac is not None)
    LAUNCHES.by[form] += 1
    return y


def _k1(op, xu):
    """The unfused apply: the kernel on CUDA, the plain version on the
    CPU. The twins call this, never a module attribute, so swapping the
    entries for the twins cannot recurse."""
    if not _device("a00_apply", xu):
        return a00_apply_plain(op, xu)
    return _launch("a00_apply", op, xu)


# --- the twins: the unfused apply, then the ops the port issued before the
# fusion (the Chebyshev forms through K6's module entries, looked up at
# each call) ---------------------------------------------------------------

def a00_apply_twin(op, xu, keep=None):
    return _k1(op, xu if keep is None else xu * keep)


def a00_masked_twin(op, aux, xu):
    ks, ms = aux[0], aux[1]
    return _k1(op, xu * ks) * ks + ms * xu


def a00_cheb_first_twin(op, aux, b, x0, d, scale):
    return cheb.cheb_first(b, a00_masked_twin(op, aux, x0), d, x0, scale)


def a00_cheb_step_twin(op, aux, b, p_k, p_km1, d, scale, omega):
    return cheb.cheb_step(b, a00_masked_twin(op, aux, p_k), d, p_k, p_km1,
                          scale, omega)


# --- the entries -------------------------------------------------------------

def a00_apply(op, xu, keep=None):
    """A00 apply without BC masks of xu * keep (keep=None: of xu); xu: flat
    (nu,) parity-permuted. The keep is taken in the kernel's loads, from
    the operator's bit table: on CUDA keep must be op.keep[:nu]."""
    if keep is None:
        return _k1(op, xu)
    if not _device("a00_apply", xu):
        return a00_apply_twin(op, xu, keep)
    return _launch("a00_apply_keep", op, xu, keep=keep)


def a00_masked(op, aux, xu):
    """A00 x_u with the keep/mask Dirichlet elimination (unit diagonal on
    BC rows), abf.mult_u_tree's value: keep in the loads, mask terms in the
    node gather's store."""
    if not _device("a00_masked", xu):
        return a00_masked_twin(op, aux, xu)
    ks, ms = aux[0], aux[1]
    return _launch("a00_masked", op, xu, keep=ks, ks=ks, ms=ms)


def a00_cheb_first(op, aux, b, x0, d, scale):
    """The first Chebyshev iterate from a nonzero x0 on the fine level:
    scale (d (b - A00m x0)) + x0, A00m the masked apply."""
    if not _device("a00_cheb_first", x0):
        return a00_cheb_first_twin(op, aux, b, x0, d, scale)
    ks, ms = aux[0], aux[1]
    return _launch("a00_cheb_first", op, x0, keep=ks, ks=ks, ms=ms, b=b, d=d,
                   scale=scale)


def a00_cheb_step(op, aux, b, p_k, p_km1, d, scale, omega):
    """One Chebyshev step on the fine level:
    omega ((scale (d (b - A00m p_k)) + p_k) - p_km1) + p_km1."""
    if not _device("a00_cheb_step", p_k):
        return a00_cheb_step_twin(op, aux, b, p_k, p_km1, d, scale, omega)
    ks, ms = aux[0], aux[1]
    return _launch("a00_cheb_step", op, p_k, keep=ks, ks=ks, ms=ms, b=b, d=d,
                   p_km1=p_km1, scale=scale, omega=omega)


# every fused K1 entry and its twin, by the name the solvers call it by
TWINS = {"a00_apply": a00_apply_twin, "a00_masked": a00_masked_twin,
         "a00_cheb_first": a00_cheb_first_twin,
         "a00_cheb_step": a00_cheb_step_twin}


class A00Op:
    """The single-device fine-level operator as the V-cycle, the smoothers
    and GCR take it: called, A00 with the Dirichlet terms (a00_masked);
    cheb_first and cheb_step the fused Chebyshev updates
    (treeops.cheb_smooth calls them when it is given the Jacobi diagonal).
    The entries are looked up at each call, so a caller may swap them for
    their twins."""

    def __init__(self, op, aux):
        self.op, self.aux = op, aux

    def __call__(self, xu):
        return a00_masked(self.op, self.aux, xu)

    def cheb_first(self, b, x0, d, scale):
        return a00_cheb_first(self.op, self.aux, b, x0, d, scale)

    def cheb_step(self, b, p_k, p_km1, d, scale, omega):
        return a00_cheb_step(self.op, self.aux, b, p_k, p_km1, d, scale,
                             omega)
