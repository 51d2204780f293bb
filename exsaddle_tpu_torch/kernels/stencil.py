"""K4: the 3^ndim-point block stencil apply of the deep MG levels,
hand-written for Hopper, with the ops that follow it on those levels fused
into its store.

    y[n, i] = sum_s sum_j W[n, s, i, j] * x[n + off(s), j]

Replaces exsaddle_tpu/abf.py:240 stencil_accum (its TPU production form is
stencil_apply_merged, :295) and, on the stencil levels, the Chebyshev
update of K6 (kernels/cheb.py) and the V-cycle's residual. Source:
csrc/stencil_apply.cu; built by kernels/_build.py.

Entries, each on a CUDA tensor one launch of the kernel (or a raise), on a
CPU tensor its plain twin, the ops the solvers issued before the fusion:

    stencil_accum(W, xp)                          y
    stencil_apply(W, x)                           y
    stencil_residual(W, x, b)                     b - y
    stencil_cheb_first(W, x0, b, d, scale)        cheb.cheb_first(b, y, d,
                                                  x0, scale)
    stencil_cheb_step(W, p_k, b, d, p_km1, scale, omega)
                                                  cheb.cheb_step(b, y, d,
                                                  p_k, p_km1, scale, omega)

xp is the padded form (*grid + 2, nd), one ghost layer per side (the cart
path fills it with its neighbours' planes); x the zero-boundary form
(*grid, nd), whose ghosts the kernel reads as 0 by predicate. The fused
entries take either (padded=True: x is xp, and x0 / p_k its interior).
The kernel sums slot by slot in `stencil_offsets` order and within a slot
over j, as the JAX package does; the plain version sums in torch's order,
so the two agree to rounding, not bitwise. Each epilogue is bitwise the
kernel's y followed by K6's update or the subtraction.

`StencilOp(W)` is the operator object the solvers hand to
treeops.cheb_smooth: called, it applies W; its residual, cheb_first and
cheb_step are the fused entries."""

import ctypes
import itertools

import torch

from exsaddle_tpu_torch.kernels import _build, cheb

EPILOGUES = ("residual", "cheb_first", "cheb_step")
_EPI = {"none": 0, "residual": 1, "cheb_first": 2, "cheb_step": 3}

# (nodes per tile, warps per CTA, stages per warp, CTAs per SM), chosen by
# measurement on an H100 (python3 k4_tune.py; PERF.md section 6)
CONFIG = {torch.float32: (32, 1, 2, 3), torch.float64: (16, 1, 2, 3)}

_V = ctypes.c_void_p
_bound = False


class _Launches(_build.Launches):
    """`n`: every launch of the kernel (one stencil apply each); `fused`:
    by epilogue, the launches that computed it in their store."""

    def __init__(self):
        super().__init__()
        self.fused = dict.fromkeys(EPILOGUES, 0)

    def reset(self):
        super().reset()
        self.fused = dict.fromkeys(EPILOGUES, 0)


LAUNCHES = _Launches()


def stencil_offsets(ndim):
    """Neighbor offsets, x-fastest (off[0] is the x offset)."""
    return [tuple(reversed(o))
            for o in itertools.product(*[(-1, 0, 1)] * ndim)]


def stencil_accum_plain(W, xp):
    """The plain PyTorch version. The 3^nd shifted views are stacked and
    contracted with W as one elementwise product and one sum over (slot,
    column). A batched (nd x nd) matmul per slot ran as ~10^6 tiny cuBLAS
    gemvs on an H100 (~0.5 ms per mx=32 L-2 apply)."""
    ndim = xp.ndim - 1
    shape = tuple(W.shape[:ndim])
    views = []
    for off in stencil_offsets(ndim):
        idx = tuple(slice(1 + off[ndim - 1 - dim],
                          1 + off[ndim - 1 - dim] + shape[dim])
                    for dim in range(ndim))
        views.append(xp[idx])
    X = torch.stack(views, dim=ndim)                 # (*grid, 3^nd, nd)
    return (W * X.unsqueeze(-2)).sum(dim=(ndim, ndim + 2))


def _pad(x):
    """The zero ghost layer around a zero-boundary grid x."""
    return torch.nn.functional.pad(x, (0, 0) + (1, 1) * (x.ndim - 1))


def _interior(xp):
    return xp[tuple(slice(1, -1) for _ in range(xp.ndim - 1))]


def _forms(x, padded):
    """(xp, the grid values) of x in either form."""
    return (x, _interior(x)) if padded else (_pad(x), x)


def stencil_apply_plain(W, x):
    return stencil_accum_plain(W, _pad(x))


def stencil_residual_plain(W, x, b, padded=False):
    return b - stencil_accum_plain(W, _forms(x, padded)[0])


def stencil_cheb_first_plain(W, x0, b, d, scale, padded=False):
    xp, x0 = _forms(x0, padded)
    return cheb.cheb_first_plain(b, stencil_accum_plain(W, xp), d, x0, scale)


def stencil_cheb_step_plain(W, p_k, b, d, p_km1, scale, omega,
                            padded=False):
    xp, p_k = _forms(p_k, padded)
    return cheb.cheb_step_plain(b, stencil_accum_plain(W, xp), d, p_k, p_km1,
                                scale, omega)


def _fn(dtype):
    global _bound
    lib = _build.load()
    if not _bound:
        for name in ("stencil_k4_f32", "stencil_k4_f64"):
            f = getattr(lib, name)
            f.argtypes = [_V] * 6 + [ctypes.c_double] * 2 + [
                ctypes.c_int] * 11 + [_V]
            f.restype = ctypes.c_int
        _bound = True
    return lib, (lib.stencil_k4_f32 if dtype == torch.float32
                 else lib.stencil_k4_f64)


def _check(W, x, padded=True, **vecs):
    """(ndim, nd, grid) of a launch on W and x (xp when padded), after the
    checks the kernel needs: shapes, one float dtype and device,
    contiguity, W 16-byte aligned (its tiles arrive by bulk copies),
    int32 node counts. vecs: the epilogue's grid vectors (b, d, p_km1)."""
    ndim = x.ndim - 1
    if ndim not in (2, 3):
        raise ValueError(f"stencil_accum: ndim {ndim} not supported")
    nd = x.shape[-1]
    if nd not in (2, 3):
        raise ValueError(f"stencil_accum: {nd} dofs per node not supported")
    grid = tuple(s - (2 if padded else 0) for s in x.shape[:ndim])
    want = grid + (3 ** ndim, nd, nd)
    if min(grid) < 1 or tuple(W.shape) != want:
        raise ValueError(f"stencil_accum: W has shape {tuple(W.shape)}, x "
                         f"{tuple(x.shape)} (padded={padded}); expected W "
                         f"{want}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"stencil_accum: dtype {x.dtype} not supported")
    for name, t in (("W", W),) + tuple(vecs.items()):
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"stencil_accum: {name} is {t.dtype} on "
                             f"{t.device}, x is {x.dtype} on {x.device}")
        if name != "W" and tuple(t.shape) != grid + (nd,):
            raise ValueError(f"stencil_accum: {name} has shape "
                             f"{tuple(t.shape)}, expected {grid + (nd,)}")
    for name, t in (("W", W), ("x", x)) + tuple(vecs.items()):
        if not t.is_contiguous():
            raise ValueError(f"stencil_accum: {name} is not contiguous")
    if W.data_ptr() % 16:
        raise ValueError("stencil_accum: W is not 16-byte aligned (its "
                         "tiles arrive by bulk copies)")
    if W.numel() >= 2 ** 31:
        raise ValueError(f"stencil_accum: {W.numel()} stencil values "
                         f"overflow int32 indices")
    return ndim, nd, grid


def _device(name, x):
    """Whether x calls for the kernel (CUDA) or the twin (CPU)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return True


def _launch(epi, W, x, padded, b=None, d=None, p_km1=None, scale=0.0,
            omega=0.0):
    vecs = {k: v for k, v in (("b", b), ("d", d), ("p_km1", p_km1))
            if v is not None}
    ndim, nd, grid = _check(W, x, padded, **vecs)
    lib, fn = _fn(x.dtype)
    tn, warps, stages, ctas = CONFIG[x.dtype]
    nx, ny = grid[-1], grid[-2]
    nz = grid[0] if ndim == 3 else 1

    def ptr(t):
        return _V(0) if t is None else _V(t.data_ptr())

    with torch.cuda.device(x.device):
        out = torch.empty(grid + (nd,), dtype=x.dtype, device=x.device)
        err = fn(_V(W.data_ptr()), _V(x.data_ptr()), _V(out.data_ptr()),
                 ptr(b), ptr(d), ptr(p_km1), float(scale), float(omega),
                 _EPI[epi], int(padded), ndim, nd, nx, ny, nz, tn, warps,
                 stages, ctas,
                 _V(torch.cuda.current_stream(x.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"stencil {epi} kernel launch failed: "
                           f"{_build.error_string(lib, err)}")
    LAUNCHES.n += 1
    if epi != "none":
        LAUNCHES.fused[epi] += 1
    return out


def stencil_accum(W, xp):
    """y = A x for a block stencil operator, xp carrying one ghost layer
    on each side of every spatial dim."""
    if not _device("stencil_accum", xp):
        return stencil_accum_plain(W, xp)
    return _launch("none", W, xp, True)


def stencil_apply(W, x):
    """y = A x on a zero-boundary grid x (*grid, nd)."""
    if not _device("stencil_apply", x):
        return stencil_apply_plain(W, x)
    return _launch("none", W, x, False)


def stencil_residual(W, x, b, padded=False):
    """b - A x."""
    if not _device("stencil_residual", x):
        return stencil_residual_plain(W, x, b, padded)
    return _launch("residual", W, x, padded, b=b)


def stencil_cheb_first(W, x0, b, d, scale, padded=False):
    """The first Chebyshev iterate from a nonzero x0:
    scale (d (b - A x0)) + x0."""
    if not _device("stencil_cheb_first", x0):
        return stencil_cheb_first_plain(W, x0, b, d, scale, padded)
    return _launch("cheb_first", W, x0, padded, b=b, d=d, scale=scale)


def stencil_cheb_step(W, p_k, b, d, p_km1, scale, omega, padded=False):
    """One Chebyshev step:
    omega ((scale (d (b - A p_k)) + p_k) - p_km1) + p_km1."""
    if not _device("stencil_cheb_step", p_k):
        return stencil_cheb_step_plain(W, p_k, b, d, p_km1, scale, omega,
                                       padded)
    return _launch("cheb_step", W, p_k, padded, b=b, d=d, p_km1=p_km1,
                   scale=scale, omega=omega)


# every K4 entry and its plain twin, by the name the solvers call it by
TWINS = {"stencil_accum": stencil_accum_plain,
         "stencil_apply": stencil_apply_plain,
         "stencil_residual": stencil_residual_plain,
         "stencil_cheb_first": stencil_cheb_first_plain,
         "stencil_cheb_step": stencil_cheb_step_plain}


class StencilOp:
    """The block stencil operator W on zero-boundary grids, as the
    smoothers and the V-cycle take it: A x, and the fused b - A x and
    Chebyshev updates (treeops.cheb_smooth calls those when it is given
    the Jacobi diagonal). The entries are looked up at each call, so a
    caller may swap them for their twins."""

    def __init__(self, W):
        self.W = W

    def __call__(self, x):
        return stencil_apply(self.W, x)

    def residual(self, b, x):
        return stencil_residual(self.W, x, b)

    def cheb_first(self, b, x0, d, scale):
        return stencil_cheb_first(self.W, x0, b, d, scale)

    def cheb_step(self, b, p_k, p_km1, d, scale, omega):
        return stencil_cheb_step(self.W, p_k, b, d, p_km1, scale, omega)
