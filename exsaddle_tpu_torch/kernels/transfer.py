"""K5: the multigrid transfers of the ABF V-cycle, hand-written for
Hopper, one launch per transfer.

    prolong_parity(xc, cls_shapes, m_el, add=None)
        coarse node grid (*rev(m + 1), nd) -> the flat parity-ordered fine
        u vector (+ add)
    restrict_parity(xu, cls_shapes, m_el)
        its transpose: flat fine u vector -> coarse node grid
    restrict_parity_residual(b, y, cls_shapes, m_el)
        restrict_parity(b - y, ...), b - y formed in the kernel's loads
    restrict_parity_residual_cheb_first(b, y, cls_shapes, m_el, d, scale)
        (b2, p1): b2 = restrict_parity_residual(b, y, ...), and L-2's
        zero-guess first Chebyshev iterate p1 = scale (d b2) + 0 computed in
        the same store (the K6 cheb_first launch that followed)
    restrict_parity_weighted_residual(b, y, w, cls_shapes, m_el)
        restrict_parity(w * (b - y), ...), formed in the kernel's loads
        (the cart V-cycle's ownership-weighted residual)
    prolong_grid(xc, fine_shape, add=None)
        separable multilinear interpolation between node grids (spatial
        dims leading, dof trailing) (+ add)
    restrict_grid(rf, coarse_shape)
        its transpose
    restrict_grid_cheb_first(rf, coarse_shape, d, scale)
        (b, p1): b = restrict_grid(rf, coarse_shape), and the coarse level's
        zero-guess first Chebyshev iterate p1 = scale (d b) + 0 computed in
        the same store (the K6 cheb_first launch that followed)

Replaces exsaddle_tpu/abf.py:110 prolong_parity, :132 restrict_parity,
:150 prolong_grid and :171 restrict_grid (XLA fusions on the TPU). Source:
csrc/transfer.cu; built by kernels/_build.py.

On a CUDA tensor each entry launches its kernel (or raises) and counts the
launch in LAUNCHES (`n`, and `by` form: the entry's name, with "_add" for
a prolongation given add=); on a CPU tensor it runs its plain twin (TWINS),
the slices, cats and in-place adds the solvers issued before the kernel;
any other device raises. Kernel and twin are bitwise equal: the kernel
evaluates the twin's operations in the twin's order with explicitly
rounded intrinsics, and the fused forms are the twin followed by the add
(or K6's first step) or preceded by the subtraction (and the
weighting)."""

import ctypes
import itertools

import numpy as np
import torch

from exsaddle_tpu_torch.kernels import _build, cheb

# the launch forms, by the name the kernels line and the counters use
FORMS = ("prolong_parity", "prolong_parity_add", "restrict_parity",
         "restrict_parity_residual", "restrict_parity_residual_cheb_first",
         "restrict_parity_weighted_residual", "prolong_grid",
         "prolong_grid_add", "restrict_grid", "restrict_grid_cheb_first")

_V = ctypes.c_void_p
_bound = False


class _Launches(_build.Launches):
    """`n`: every launch of a K5 kernel; `by`: the launches of each form
    (FORMS)."""

    def __init__(self):
        super().__init__()
        self.by = dict.fromkeys(FORMS, 0)

    def reset(self):
        super().reset()
        self.by = dict.fromkeys(FORMS, 0)


LAUNCHES = _Launches()


# --------------------------------------------------------------------------
# The plain twins
# --------------------------------------------------------------------------

def _class_bits(p, nd):
    return [(p >> a) & 1 for a in range(nd)]


def prolong_parity_plain(xc, cls_shapes, m_el, add=None):
    """Multilinear interpolation coarse grid -> fine parity layout.

    xc: (*rev(m+1 per axis), nd). Coarse nodes coincide with fine parity
    class 0; a fine node with parity bits b averages its 2^{popcount(b)}
    coarse neighbors -- every term a unit-stride slice. Returns a flat
    parity-permuted u vector, plus add when given."""
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
    out = torch.cat(subs)
    return out if add is None else out + add


def restrict_parity_plain(xu, cls_shapes, m_el):
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


def restrict_parity_residual_plain(b, y, cls_shapes, m_el):
    """restrict_parity of the residual b - y."""
    return restrict_parity_plain(b - y, cls_shapes, m_el)


def restrict_parity_residual_cheb_first_plain(b, y, cls_shapes, m_el, d,
                                               scale):
    """restrict_parity_residual, then K6's zero-guess first step on the
    result: (b2, scale (d b2) + 0)."""
    b2 = restrict_parity_residual_plain(b, y, cls_shapes, m_el)
    return b2, cheb.cheb_first_plain(b2, None, d, torch.zeros_like(b2), scale)


def restrict_parity_weighted_residual_plain(b, y, w, cls_shapes, m_el):
    """restrict_parity of the weighted residual w * (b - y)."""
    return restrict_parity_plain(w * (b - y), cls_shapes, m_el)


def prolong_grid_plain(xc, fine_shape, add=None):
    """Separable multilinear interpolation between plain node grids
    (spatial dims leading, dof trailing). fine_shape: spatial shape of the
    output. Matches precond_mg.Prolongation for (M+1)/2-coarsened grids.
    Plus add when given."""
    x = xc
    for dim in range(len(fine_shape)):
        x = _prolong_axis(x, dim, fine_shape[dim])
    return x if add is None else add + x


def _prolong_axis(x, axis, nf):
    x = torch.movedim(x, axis, 0)
    a = x                                     # even fine slots
    b = 0.5 * (x[:-1] + x[1:])                # odd fine slots
    inter = torch.stack([a[:-1], b], dim=1).reshape((-1,) + x.shape[1:])
    out = torch.cat([inter, a[-1:]], dim=0)
    if out.shape[0] != nf:
        raise ValueError(f"prolong_grid: {out.shape[0]} != {nf} nodes")
    return torch.movedim(out, 0, axis)


def restrict_grid_plain(rf, coarse_shape):
    """Transpose of prolong_grid."""
    x = rf
    for dim in range(len(coarse_shape)):
        x = _restrict_axis(x, dim, coarse_shape[dim])
    return x


def restrict_grid_cheb_first_plain(rf, coarse_shape, d, scale):
    """restrict_grid, then K6's zero-guess first step on the result: (b,
    scale (d b) + 0)."""
    b = restrict_grid_plain(rf, coarse_shape)
    return b, cheb.cheb_first_plain(b, None, d, torch.zeros_like(b), scale)


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
# The launch checks and the kernels
# --------------------------------------------------------------------------

def _device(name, x):
    """Whether x calls for the kernel (CUDA) or the twin (CPU)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return True


def _check(name, x, shape, **more):
    """Before a launch: x and every tensor in more (None skipped) of one
    float dtype and device, contiguous; x of `shape`, each of more of
    its (shape, tensor) pair's shape."""
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {x.dtype} not supported")
    tensors = [("input", x, shape)] + [(k, t, s) for k, (s, t) in
                                       more.items() if t is not None]
    for key, t, want in tensors:
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name}: {key} is {t.dtype} on {t.device}, "
                             f"the input {x.dtype} on {x.device}")
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {tuple(want)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")


def _dims(name, ndim, nd):
    if ndim not in (2, 3):
        raise ValueError(f"{name}: ndim {ndim} not supported")
    if nd not in (2, 3):
        raise ValueError(f"{name}: {nd} dofs per node not supported")


def parity_layout(cls_shapes, m_el, nd):
    """(coarse grid shape, flat fine length, the kernel's shape table) of
    a parity transfer, after the checks the kernel needs: one class per
    parity, each inside the coarse grid along every dim."""
    ndim = len(m_el)
    cshape = tuple(int(m_el[ndim - 1 - dim]) + 1 for dim in range(ndim))
    if len(cls_shapes) != 2 ** ndim:
        raise ValueError(f"parity transfer: {len(cls_shapes)} classes for "
                         f"ndim {ndim}")
    table = list(cshape)
    n = 0
    for p, shp in enumerate(cls_shapes):
        shp = tuple(int(s) for s in shp)
        bits = _class_bits(p, ndim)
        if len(shp) != ndim or any(
                s < 1 or s + bits[ndim - 1 - dim] > cshape[dim]
                for dim, s in enumerate(shp)):
            raise ValueError(f"parity transfer: class {p} shape {shp} does "
                             f"not fit the coarse grid {cshape}")
        table += shp
        n += int(np.prod(shp)) * nd
    return cshape, n, table


def _fn(kind, dtype):
    global _bound
    lib = _build.load()
    if not _bound:
        for name in ("k5_prolong_parity", "k5_restrict_parity",
                     "k5_prolong_grid"):
            for sfx in ("_f32", "_f64"):
                f = getattr(lib, name + sfx)
                f.argtypes = [_V] * 4 + [ctypes.c_int] * 2 + [_V]
                f.restype = ctypes.c_int
        for sfx in ("_f32", "_f64"):
            f = getattr(lib, "k5_restrict_grid" + sfx)
            f.argtypes = [_V] * 3 + [ctypes.c_int] * 2 + [_V]
            f.restype = ctypes.c_int
            f = getattr(lib, "k5_restrict_parity_weighted_residual" + sfx)
            f.argtypes = [_V] * 5 + [ctypes.c_int] * 2 + [_V]
            f.restype = ctypes.c_int
            f = getattr(lib, "k5_restrict_grid_cheb_first" + sfx)
            f.argtypes = [_V] * 2 + [ctypes.c_double] + [_V] * 3 + [
                ctypes.c_int] * 2 + [_V]
            f.restype = ctypes.c_int
            f = getattr(lib, "k5_restrict_parity_residual_cheb_first" + sfx)
            f.argtypes = [_V] * 3 + [ctypes.c_double] + [_V] * 3 + [
                ctypes.c_int] * 2 + [_V]
            f.restype = ctypes.c_int
        _bound = True
    return lib, getattr(lib, f"k5_{kind}_"
                        + ("f32" if dtype == torch.float32 else "f64"))


def _ptr(t):
    return _V(0) if t is None else _V(t.data_ptr())


def _launch(form, kind, x, out_shape, ptrs, table, ndim, nd, nout=1):
    """One launch into nout new outputs of out_shape (the last arguments
    before the table); returns the output, or the tuple of them."""
    lib, fn = _fn(kind, x.dtype)
    arr = (ctypes.c_int * len(table))(*table)
    with torch.cuda.device(x.device):
        outs = tuple(torch.empty(out_shape, dtype=x.dtype, device=x.device)
                     for _ in range(nout))
        args = ptrs + [_V(o.data_ptr()) for o in outs] + [
            arr, ndim, nd, _V(torch.cuda.current_stream(x.device).cuda_stream)]
        err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{form} kernel launch failed: "
                           f"{_build.error_string(lib, err)}")
    LAUNCHES.n += 1
    LAUNCHES.by[form] += 1
    return outs[0] if nout == 1 else outs


# --------------------------------------------------------------------------
# The entries
# --------------------------------------------------------------------------

def prolong_parity(xc, cls_shapes, m_el, add=None):
    """Coarse node grid -> flat parity-ordered fine u vector, plus add
    (a fine u vector) when given."""
    name = "prolong_parity"
    if not _device(name, xc):
        return prolong_parity_plain(xc, cls_shapes, m_el, add)
    ndim, nd = len(m_el), xc.shape[-1]
    _dims(name, ndim, nd)
    cshape, n, table = parity_layout(cls_shapes, m_el, nd)
    _check(name, xc, cshape + (nd,), add=((n,), add))
    return _launch(name if add is None else name + "_add", name, xc, (n,),
                   [_ptr(xc), _ptr(add)], table, ndim, nd)


def _restrict_parity(form, b, y, cls_shapes, m_el, w=None):
    ndim = nd = len(m_el)
    _dims(form, ndim, nd)
    cshape, n, table = parity_layout(cls_shapes, m_el, nd)
    _check(form, b, (n,), y=((n,), y), w=((n,), w))
    ptrs = [_ptr(b), _ptr(y)] + ([] if w is None else [_ptr(w)])
    return _launch(form, "restrict_parity" if w is None else form, b,
                   cshape + (nd,), ptrs, table, ndim, nd)


def restrict_parity(xu, cls_shapes, m_el):
    """Flat fine u vector -> coarse node grid (prolong_parity's
    transpose)."""
    if not _device("restrict_parity", xu):
        return restrict_parity_plain(xu, cls_shapes, m_el)
    return _restrict_parity("restrict_parity", xu, None, cls_shapes, m_el)


def restrict_parity_residual(b, y, cls_shapes, m_el):
    """restrict_parity(b - y, ...): the fine level's residual restricted,
    the subtraction in the kernel's loads."""
    name = "restrict_parity_residual"
    if not _device(name, b):
        return restrict_parity_residual_plain(b, y, cls_shapes, m_el)
    return _restrict_parity(name, b, y, cls_shapes, m_el)


def restrict_parity_residual_cheb_first(b, y, cls_shapes, m_el, d, scale):
    """(b2, p1): b2 = restrict_parity_residual(b, y, cls_shapes, m_el) and
    L-2's zero-guess first Chebyshev iterate p1 = scale (d b2) + 0 (K6's
    cheb_first with x0 = 0; d L-2's Jacobi inverse diagonal, of b2's
    shape), both from one launch."""
    name = "restrict_parity_residual_cheb_first"
    if not _device(name, b):
        return restrict_parity_residual_cheb_first_plain(b, y, cls_shapes,
                                                         m_el, d, scale)
    if y is None or d is None:
        raise ValueError(f"{name}: y and d are required")
    ndim = nd = len(m_el)
    _dims(name, ndim, nd)
    cshape, n, table = parity_layout(cls_shapes, m_el, nd)
    _check(name, b, (n,), y=((n,), y), d=(cshape + (nd,), d))
    return _launch(name, name, b, cshape + (nd,),
                   [_ptr(b), _ptr(y), _ptr(d), ctypes.c_double(float(scale))],
                   table, ndim, nd, nout=2)


def restrict_parity_weighted_residual(b, y, w, cls_shapes, m_el):
    """restrict_parity(w * (b - y), ...): the cart V-cycle's
    ownership-weighted fine residual restricted, w * (b - y) formed in the
    kernel's loads."""
    name = "restrict_parity_weighted_residual"
    if not _device(name, b):
        return restrict_parity_weighted_residual_plain(b, y, w, cls_shapes,
                                                       m_el)
    if y is None or w is None:
        raise ValueError(f"{name}: y and w are required")
    return _restrict_parity(name, b, y, cls_shapes, m_el, w=w)


def _grid_dims(name, x, shape):
    ndim, nd = len(shape), x.shape[-1]
    _dims(name, ndim, nd)
    if x.ndim != ndim + 1:
        raise ValueError(f"{name}: input of shape {tuple(x.shape)} for a "
                         f"{ndim}-D grid")
    return ndim, nd


def prolong_grid(xc, fine_shape, add=None):
    """Node grid (*coarse, nd) -> (*fine_shape, nd), fine = 2 coarse - 1
    nodes per dim, plus add when given."""
    name = "prolong_grid"
    if not _device(name, xc):
        return prolong_grid_plain(xc, fine_shape, add)
    ndim, nd = _grid_dims(name, xc, fine_shape)
    fine = tuple(int(n) for n in fine_shape)
    nc = [(n + 1) // 2 for n in fine]
    if any(n < 1 or n % 2 == 0 for n in fine):
        raise ValueError(f"prolong_grid: fine grid {fine} is not 2 n - 1 "
                         f"nodes per dim")
    _check(name, xc, tuple(nc) + (nd,), add=(fine + (nd,), add))
    return _launch(name if add is None else name + "_add", name, xc,
                   fine + (nd,), [_ptr(xc), _ptr(add)], nc, ndim, nd)


def restrict_grid(rf, coarse_shape):
    """Node grid (*fine, nd) -> (*coarse_shape, nd) (prolong_grid's
    transpose)."""
    name = "restrict_grid"
    if not _device(name, rf):
        return restrict_grid_plain(rf, coarse_shape)
    ndim, nd = _grid_dims(name, rf, coarse_shape)
    nc = [int(n) for n in coarse_shape]
    if min(nc) < 1:
        raise ValueError(f"restrict_grid: coarse grid {tuple(nc)}")
    _check(name, rf, tuple(2 * n - 1 for n in nc) + (nd,))
    return _launch(name, name, rf, tuple(nc) + (nd,), [_ptr(rf)], nc,
                   ndim, nd)


def restrict_grid_cheb_first(rf, coarse_shape, d, scale):
    """(b, p1): b = restrict_grid(rf, coarse_shape) and the coarse level's
    zero-guess first Chebyshev iterate p1 = scale (d b) + 0 (K6's
    cheb_first with x0 = 0; d that level's Jacobi inverse diagonal, of b's
    shape), both from one launch."""
    name = "restrict_grid_cheb_first"
    if not _device(name, rf):
        return restrict_grid_cheb_first_plain(rf, coarse_shape, d, scale)
    ndim, nd = _grid_dims(name, rf, coarse_shape)
    nc = [int(n) for n in coarse_shape]
    if min(nc) < 1:
        raise ValueError(f"{name}: coarse grid {tuple(nc)}")
    _check(name, rf, tuple(2 * n - 1 for n in nc) + (nd,),
           d=(tuple(nc) + (nd,), d))
    return _launch(name, name, rf, tuple(nc) + (nd,),
                   [_ptr(rf), _ptr(d), ctypes.c_double(float(scale))], nc,
                   ndim, nd, nout=2)


# every K5 entry and its plain twin, by the name the solvers call it by
TWINS = {"prolong_parity": prolong_parity_plain,
         "restrict_parity": restrict_parity_plain,
         "restrict_parity_residual": restrict_parity_residual_plain,
         "restrict_parity_residual_cheb_first":
             restrict_parity_residual_cheb_first_plain,
         "restrict_parity_weighted_residual":
             restrict_parity_weighted_residual_plain,
         "prolong_grid": prolong_grid_plain,
         "restrict_grid": restrict_grid_plain,
         "restrict_grid_cheb_first": restrict_grid_cheb_first_plain}
