"""K1: the fused velocity-block (A00) apply, hand-written for Hopper.

    y_u = sum_e G_e^T Bs^T diag(s_e) Bs G_e x_u      (no Dirichlet masks)

Replaces exsaddle_tpu/pallas_apply.py:make_pallas_mult_u (the repo's one
Pallas kernel). Source: csrc/a00_apply.cu; built by kernels/_build.py.

`a00_apply(op, xu)` takes the flat parity-permuted velocity vector and the
ParityMatFreeOperator holding Bs and scale_visc, and returns a new flat
vector. On a CUDA tensor it launches the kernel (or raises); on a CPU tensor
it runs `a00_apply_plain`, the same arithmetic in PyTorch ops. Callers apply
the keep/mask Dirichlet elimination around it (abf.mult_u_tree,
matfree.mult_tree)."""

import ctypes

import torch

from exsaddle_tpu_torch.grid_ops import (split_u_parity, gather_u_parity,
                                         scatter_u_parity)
from exsaddle_tpu_torch.kernels import _build


class LaunchCount:
    """Number of applies a wrapper sent to its kernel. Plain-version calls
    are not counted."""

    def __init__(self):
        self.n = 0

    def reset(self):
        self.n = 0


LAUNCHES = LaunchCount()

# (nqp * ncomp rows, 3^nd * nd columns) of Bs per dimension
_BS_SHAPE = {2: (27, 18), 3: (162, 81)}

_bound = False


def _fn(dtype):
    global _bound
    lib = _build.load()
    if not _bound:
        for name in ("a00_apply_f32", "a00_apply_f64"):
            f = getattr(lib, name)
            f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
            f.restype = ctypes.c_int
        lib.a00_error_string.argtypes = [ctypes.c_int]
        lib.a00_error_string.restype = ctypes.c_char_p
        _bound = True
    return lib, lib.a00_apply_f32 if dtype == torch.float32 \
        else lib.a00_apply_f64


def a00_apply_plain(op, xu):
    """The plain PyTorch version: gather -> @Bs^T -> *scale_visc -> @Bs ->
    scatter."""
    nd = len(op.m_el)
    xe = gather_u_parity(split_u_parity(xu, op.cls_shapes, nd), op.m_el)
    yue = ((xe @ op.Bs.T) * op.scale_visc) @ op.Bs
    return scatter_u_parity(yue, op.m_el, op.cls_shapes)


def _check(op, xu):
    nd = len(op.m_el)
    if nd not in _BS_SHAPE:
        raise ValueError(f"a00_apply: ndim {nd} not supported")
    if xu.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"a00_apply: dtype {xu.dtype} not supported")
    nel = 1
    for m in op.m_el:
        nel *= m
    want = {"xu": (xu, (op.nu,)), "Bs": (op.Bs, _BS_SHAPE[nd]),
            "scale_visc": (op.scale_visc, (nel, _BS_SHAPE[nd][0]))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"a00_apply: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.dtype != xu.dtype or t.device != xu.device:
            raise ValueError(f"a00_apply: {name} is {t.dtype} on {t.device}"
                             f", x is {xu.dtype} on {xu.device}")
        if not t.is_contiguous():
            raise ValueError(f"a00_apply: {name} is not contiguous")


def a00_apply(op, xu):
    """A00 apply without BC masks; xu: flat (nu,) parity-permuted."""
    if xu.device.type == "cpu":
        return a00_apply_plain(op, xu)
    if xu.device.type != "cuda":
        raise ValueError(f"a00_apply: unsupported device {xu.device}")
    _check(op, xu)
    lib, fn = _fn(xu.dtype)
    mx, my = op.m_el[0], op.m_el[1]
    mz = op.m_el[2] if len(op.m_el) == 3 else 1
    with torch.cuda.device(xu.device):
        y = torch.zeros_like(xu)
        err = fn(xu.data_ptr(), op.scale_visc.data_ptr(), op.Bs.data_ptr(),
                 y.data_ptr(), len(op.m_el), mx, my, mz,
                 torch.cuda.current_stream(xu.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"a00_apply kernel launch failed: "
                           f"{lib.a00_error_string(err).decode()} ({err})")
    LAUNCHES.n += 1
    return y
