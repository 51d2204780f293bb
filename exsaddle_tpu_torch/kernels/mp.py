"""K3: the p-block's Mpscaled apply (the viscosity-scaled pressure mass
matrix), hand-written for Hopper as its 3^ndim-point node stencil, with the
p-block's Chebyshev update in its store.

    y_p = Mp x_p = sum_e G_e^T Np^T diag(pscale_e) Np G_e x_p
        = sum_s W[s] x_p[. + off(s)]

Replaces exsaddle_tpu/abf.py:92 mp_apply (with exsaddle_tpu/grid_ops.py:86
_gather_q1 and :104 _scatter_q1, an XLA fusion on the TPU) and, on the
single-device p-block, the loop body of exsaddle_tpu/treeops.py:167
cheb_smooth (K6's update after each apply). Source: csrc/mp_apply.cu;
built by kernels/_build.py.

Mpscaled is fixed for a setup: the setup assembles it in float64 and keeps
its stencil W (abf.mp_stencil: (3^nd, *rev(nn_p)), slot-major, slots
x-fastest as kernels/stencil.py stencil_offsets, rounded once to the
working dtype) beside pscale. The kernel reads W, one thread per node,
and sums its 3^nd products in double before one rounding to the working
dtype; the plain version reads the factored form (op's Np and pscale).

Entries, each on a CUDA tensor one launch of the kernel (or a raise), on a
CPU tensor its plain version or twin, any other device a raise; op is a
ParityMatFreeOperator (its m_el, nn_p and Np), pscale its (nel, 3^nd)
weights, W the setup's stencil, every vector a pressure grid
(*rev(nn_p)):

    mp_apply(op, pscale, W, pg)        Mp pg (the cart path's form, one
                                       launch per shard)
    mp_cheb_step(op, pscale, W, b, p_k, p_km1, d, scale, omega)
                                       cheb.cheb_step(b, Mp p_k, d, p_k,
                                       p_km1, scale, omega)

The plain form is held against `mp_apply_plain` (the port's torch ops:
gather, two GEMMs and a multiply, scatter; the CPU's path) within a stated
tolerance: the stencil's coefficients are the element products summed
and rounded at setup. The step form is bitwise its twin (TWINS): the
unfused apply (the kernel on CUDA, `mp_apply_plain` on the CPU) followed
by K6. `MpOp(op, pscale, W)` is the single-device p-block's operator for
treeops.cheb_smooth: called, the plain form; its cheb_step the fused
update, its cheb_first (from a nonzero x0, which no path takes: the
p-block starts from zero) the plain form, then K6."""

import ctypes

import numpy as np
import torch

from exsaddle_tpu_torch.grid_ops import _gather_q1, _scatter_q1
from exsaddle_tpu_torch.kernels import _build, cheb

# the launch forms, by the name the kernels line and the counters use
FORMS = ("mp_apply", "mp_cheb_step")
_EPI = {"mp_apply": 0, "mp_cheb_step": 1}

_V = ctypes.c_void_p
_bound = False


class _Launches(_build.Launches):
    """`n`: every launch of K3; `by`: the launches of each form (FORMS)."""

    def __init__(self):
        super().__init__()
        self.by = dict.fromkeys(FORMS, 0)

    def reset(self):
        super().reset()
        self.by = dict.fromkeys(FORMS, 0)


LAUNCHES = _Launches()


def mp_apply_plain(op, pscale, pg):
    """The plain PyTorch version: gather the Q1 corners -> @ Np^T ->
    * pscale -> @ Np -> scatter (the CPU's path, bit for bit the port's
    earlier abf._mp_local)."""
    pe = _gather_q1(pg, op.m_el)
    ptmp = (pe @ op.Np.T) * pscale
    return _scatter_q1(ptmp @ op.Np, op.m_el, op.nn_p)


def _lib():
    global _bound
    lib = _build.load()
    if not _bound:
        for sfx in ("_f32", "_f64"):
            f = getattr(lib, "k3_mp_apply" + sfx)
            f.argtypes = [_V] * 5 + [ctypes.c_double] * 2 + [_V] + [
                ctypes.c_int] * 5 + [_V]
            f.restype = ctypes.c_int
        _bound = True
    return lib


def _device(name, pg):
    """Whether pg calls for the kernel (CUDA) or the plain version (CPU)."""
    if pg.device.type == "cpu":
        return False
    if pg.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {pg.device}")
    return True


def _check(name, op, W, pg, **vecs):
    """Refuse what the kernel cannot take: ndim, dtype, int32 indices, and
    the shape, dtype, device and layout of pg, the stencil W and the fused
    forms' grids (vecs: b, d, p_km1)."""
    nd = len(op.m_el)
    if nd not in (2, 3):
        raise ValueError(f"{name}: ndim {nd} not supported")
    if pg.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {pg.dtype} not supported")
    grid = tuple(int(n) for n in reversed(op.nn_p))
    if int(np.prod(grid)) * 3 ** nd >= 2 ** 31:
        raise ValueError(f"{name}: {int(np.prod(grid))} nodes overflow "
                         f"int32 indices")
    if W is None:
        raise ValueError(f"{name}: the kernel needs Mpscaled's stencil W "
                         f"(abf.mp_stencil)")
    want = {"pg": (pg, grid), "W": (W, (3 ** nd,) + grid),
            **{k: (v, grid) for k, v in vecs.items()}}
    for key, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != pg.dtype or t.device != pg.device:
            raise ValueError(f"{name}: {key} is {t.dtype} on {t.device}, "
                             f"pg is {pg.dtype} on {pg.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")


def _launch(form, op, W, pg, b=None, d=None, p_km1=None, scale=0.0,
            omega=0.0):
    vecs = {k: v for k, v in (("b", b), ("d", d), ("p_km1", p_km1))
            if v is not None}
    _check(form, op, W, pg, **vecs)
    lib = _lib()
    nx, ny = op.nn_p[0], op.nn_p[1]
    nz = op.nn_p[2] if len(op.nn_p) == 3 else 1

    def ptr(t):
        return _V(0 if t is None else t.data_ptr())

    with torch.cuda.device(pg.device):
        out = torch.empty_like(pg)
        err = getattr(lib, "k3_mp_apply" + ("_f32" if pg.dtype == torch.float32
                                            else "_f64"))(
            ptr(W), ptr(pg), ptr(b), ptr(d), ptr(p_km1), float(scale),
            float(omega), ptr(out), _EPI[form], len(op.nn_p), nx, ny, nz,
            _V(torch.cuda.current_stream(pg.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{form} kernel launch failed: "
                           f"{_build.error_string(lib, err)}")
    LAUNCHES.n += 1
    LAUNCHES.by[form] += 1
    return out


def _k3(op, pscale, W, pg):
    """The unfused apply: the kernel on CUDA, the plain version on the
    CPU. The twins call this, never a module attribute, so swapping the
    entries for the twins cannot recurse."""
    if not _device("mp_apply", pg):
        return mp_apply_plain(op, pscale, pg)
    return _launch("mp_apply", op, W, pg)


# --- the twins: the unfused apply, then K6's update (through its module
# entries, looked up at each call) -------------------------------------------

def mp_cheb_step_twin(op, pscale, W, b, p_k, p_km1, d, scale, omega):
    return cheb.cheb_step(b, _k3(op, pscale, W, p_k), d, p_k, p_km1, scale,
                          omega)


# --- the entries -------------------------------------------------------------

def mp_apply(op, pscale, W, pg):
    """Mpscaled pg, one launch (a pressure grid of op's shape)."""
    return _k3(op, pscale, W, pg)


def mp_cheb_step(op, pscale, W, b, p_k, p_km1, d, scale, omega):
    """One Chebyshev step of the p-block:
    omega ((scale (d (b - Mp p_k)) + p_k) - p_km1) + p_km1."""
    if not _device("mp_cheb_step", p_k):
        return mp_cheb_step_twin(op, pscale, W, b, p_k, p_km1, d, scale,
                                 omega)
    return _launch("mp_cheb_step", op, W, p_k, b=b, d=d, p_km1=p_km1,
                   scale=scale, omega=omega)


# every fused K3 entry and its twin, by the name the solvers call it by
TWINS = {"mp_cheb_step": mp_cheb_step_twin}


class MpOp:
    """The single-device p-block's operator as treeops.cheb_smooth takes
    it: called, Mpscaled (mp_apply); cheb_step the fused Chebyshev step
    (cheb_smooth calls it when it is given the Jacobi diagonal), cheb_first
    the apply, then K6's first iterate (no path starts the p-block from a
    nonzero guess, so it has no fused form). The entries are looked up at
    each call, so a caller may swap them for their twins."""

    def __init__(self, op, pscale, W):
        self.op, self.pscale, self.W = op, pscale, W

    def __call__(self, pg):
        return mp_apply(self.op, self.pscale, self.W, pg)

    def cheb_first(self, b, x0, d, scale):
        return cheb.cheb_first(b, mp_apply(self.op, self.pscale, self.W, x0),
                               d, x0, scale)

    def cheb_step(self, b, p_k, p_km1, d, scale, omega):
        return mp_cheb_step(self.op, self.pscale, self.W, b, p_k, p_km1, d,
                            scale, omega)
