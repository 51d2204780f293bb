"""K4: the 3^ndim-point block stencil apply of the deep MG levels,
hand-written for Hopper.

    y[n, i] = sum_s sum_j W[n, s, i, j] * xp[n + off(s), j]

Replaces exsaddle_tpu/abf.py:240 stencil_accum (its TPU production form is
stencil_apply_merged, :295). Source: csrc/stencil_apply.cu; built by
kernels/_build.py.

`stencil_accum(W, xp)` takes W (*grid, 3^ndim, nd, nd) and xp (*grid + 2,
nd), one ghost layer per side (zeros at domain edges; the cart path fills
them with its neighbours' planes), and returns y (*grid, nd). On a CUDA
tensor it launches the kernel (or raises); on a CPU tensor it runs
`stencil_accum_plain`, the same function in PyTorch ops. The kernel sums
slot by slot in `stencil_offsets` order and within a slot over j, as the
JAX package does; the plain version sums in torch's order, so the two
agree to rounding, not bitwise."""

import ctypes
import itertools

import torch

from exsaddle_tpu_torch.kernels import _build

LAUNCHES = _build.Launches()

_bound = False


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


def _fn(dtype):
    global _bound
    lib = _build.load()
    if not _bound:
        for name in ("stencil_accum_f32", "stencil_accum_f64"):
            f = getattr(lib, name)
            f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
                ctypes.c_void_p]
            f.restype = ctypes.c_int
        _bound = True
    return lib, (lib.stencil_accum_f32 if dtype == torch.float32
                 else lib.stencil_accum_f64)


def _check(W, xp):
    ndim = xp.ndim - 1
    if ndim not in (2, 3):
        raise ValueError(f"stencil_accum: ndim {ndim} not supported")
    nd = xp.shape[-1]
    if nd not in (2, 3):
        raise ValueError(f"stencil_accum: {nd} dofs per node not supported")
    grid = tuple(s - 2 for s in xp.shape[:ndim])
    want = grid + (3 ** ndim, nd, nd)
    if min(grid) < 1 or tuple(W.shape) != want:
        raise ValueError(f"stencil_accum: W has shape {tuple(W.shape)}, xp "
                         f"{tuple(xp.shape)}; expected W {want}")
    if xp.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"stencil_accum: dtype {xp.dtype} not supported")
    if W.dtype != xp.dtype or W.device != xp.device:
        raise ValueError(f"stencil_accum: W is {W.dtype} on {W.device}, xp "
                         f"is {xp.dtype} on {xp.device}")
    for name, t in (("W", W), ("xp", xp)):
        if not t.is_contiguous():
            raise ValueError(f"stencil_accum: {name} is not contiguous")
    if W.numel() >= 2 ** 31:
        raise ValueError(f"stencil_accum: {W.numel()} stencil values "
                         f"overflow int32 indices")
    return ndim, nd, grid


def stencil_accum(W, xp):
    """y = A x for a block stencil operator, xp carrying one ghost layer
    on each side of every spatial dim."""
    if xp.device.type == "cpu":
        return stencil_accum_plain(W, xp)
    if xp.device.type != "cuda":
        raise ValueError(f"stencil_accum: unsupported device {xp.device}")
    ndim, nd, grid = _check(W, xp)
    lib, fn = _fn(xp.dtype)
    nx, ny = grid[-1], grid[-2]
    nz = grid[0] if ndim == 3 else 1
    with torch.cuda.device(xp.device):
        y = torch.empty(grid + (nd,), dtype=xp.dtype, device=xp.device)
        err = fn(W.data_ptr(), xp.data_ptr(), y.data_ptr(), ndim, nd, nx, ny,
                 nz, torch.cuda.current_stream(xp.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stencil_accum kernel launch failed: "
                           f"{_build.error_string(lib, err)}")
    LAUNCHES.n += 1
    return y
