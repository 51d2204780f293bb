"""K6: the Chebyshev smoother's vector update with a Jacobi preconditioner,
one kernel pass per step, hand-written for Hopper.

    cheb_first(b, ax0, d, x0, scale)
        p1 = scale (d (b - ax0)) + x0              (r = b when ax0 is None)
    cheb_step(b, ap, d, p_k, p_km1, scale, omega)
        p_{k+1} = omega ((scale (d (b - ap)) + p_k) - p_km1) + p_km1
    cheb_first_masked(b, y, ks, ms, d, x0, scale)
    cheb_step_masked(b, y, ks, ms, d, p_k, p_km1, scale, omega)
        the same with ax0 = y ks + ms x0 (ap = y ks + ms p_k) formed in the
        loads from a raw apply y and the Dirichlet keep / mask vectors: the
        cart path's fine level, whose halo exchange sits between K1's raw
        output and the mask terms

ax0 = A x0 and ap = A p_k are the operator applies, made by the caller.
Replaces the loop body of exsaddle_tpu/treeops.py:167 cheb_smooth (fused by
XLA on the TPU). Source: csrc/cheb_update.cu; built by kernels/_build.py.

On a CUDA tensor a wrapper launches its kernel (or raises) and adds one to
LAUNCHES.n and to LAUNCHES.by[its name]; on a CPU tensor it runs its plain
twin (TWINS), the ops
treeops.cheb_smooth issues with a callable Jacobi preconditioner. Kernel
and twin are bitwise equal: the kernel rounds every operation explicitly
in the twin's order, and the Python scalars scale and omega are rounded to
the working dtype as torch rounds them."""

import ctypes

import torch

from exsaddle_tpu_torch.kernels import _build

FORMS = ("cheb_first", "cheb_step", "cheb_first_masked", "cheb_step_masked")


class _Launches(_build.Launches):
    """`n`: every launch of K6; `by`: the launches of each form (FORMS)."""

    def __init__(self):
        super().__init__()
        self.by = dict.fromkeys(FORMS, 0)

    def reset(self):
        super().reset()
        self.by = dict.fromkeys(FORMS, 0)


LAUNCHES = _Launches()

_V = ctypes.c_void_p
_bound = False


def cheb_first_plain(b, ax0, d, x0, scale):
    """The twin of cheb_first."""
    r = b if ax0 is None else b - ax0
    return scale * (d * r) + x0


def cheb_step_plain(b, ap, d, p_k, p_km1, scale, omega):
    """The twin of cheb_step."""
    t = scale * (d * (b - ap)) + p_k
    return omega * (t - p_km1) + p_km1


def cheb_first_masked_plain(b, y, ks, ms, d, x0, scale):
    """The twin of cheb_first_masked."""
    return cheb_first_plain(b, y * ks + ms * x0, d, x0, scale)


def cheb_step_masked_plain(b, y, ks, ms, d, p_k, p_km1, scale, omega):
    """The twin of cheb_step_masked."""
    return cheb_step_plain(b, y * ks + ms * p_k, d, p_k, p_km1, scale, omega)


def _lib():
    global _bound
    lib = _build.load()
    if not _bound:
        for sfx in ("_f32", "_f64"):
            f = getattr(lib, "cheb_first" + sfx)
            f.argtypes = [_V] * 4 + [ctypes.c_double, _V, ctypes.c_longlong,
                                     _V]
            f.restype = ctypes.c_int
            f = getattr(lib, "cheb_step" + sfx)
            f.argtypes = [_V] * 5 + [ctypes.c_double] * 2 + [
                _V, ctypes.c_longlong, _V]
            f.restype = ctypes.c_int
            f = getattr(lib, "cheb_first_masked" + sfx)
            f.argtypes = [_V] * 6 + [ctypes.c_double, _V, ctypes.c_longlong,
                                     _V]
            f.restype = ctypes.c_int
            f = getattr(lib, "cheb_step_masked" + sfx)
            f.argtypes = [_V] * 7 + [ctypes.c_double] * 2 + [
                _V, ctypes.c_longlong, _V]
            f.restype = ctypes.c_int
        _bound = True
    return lib


def _cuda(name, b):
    if b.device.type == "cpu":
        return False
    if b.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {b.device}")
    return True


def _check(name, b, vecs):
    if b.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {b.dtype} not supported")
    for key, t in vecs.items():
        if t.shape != b.shape or t.dtype != b.dtype or t.device != b.device:
            raise ValueError(f"{name}: {key} is {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}, b is {tuple(b.shape)} "
                             f"{b.dtype} on {b.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")


def _launch(name, fn, b, *args):
    lib = _lib()
    with torch.cuda.device(b.device):
        out = torch.empty_like(b, memory_format=torch.contiguous_format)
        err = getattr(lib, fn + ("_f32" if b.dtype == torch.float32
                                 else "_f64"))(
            *args, _V(out.data_ptr()), b.numel(),
            _V(torch.cuda.current_stream(b.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{_build.error_string(lib, err)}")
    LAUNCHES.n += 1
    LAUNCHES.by[fn] += 1
    return out


def _p(t):
    return _V(t.data_ptr())


def cheb_first(b, ax0, d, x0, scale):
    """The first Chebyshev iterate p1 (ax0 None: x0 is zero, r = b)."""
    name = "cheb_first"
    if not _cuda(name, b):
        return cheb_first_plain(b, ax0, d, x0, scale)
    vecs = {"b": b, "d": d, "x0": x0}
    if ax0 is not None:
        vecs["ax0"] = ax0
    _check(name, b, vecs)
    return _launch(name, "cheb_first", b, _p(b),
                   _V(0) if ax0 is None else _p(ax0), _p(d), _p(x0),
                   float(scale))


def cheb_step(b, ap, d, p_k, p_km1, scale, omega):
    """One Chebyshev step p_{k+1} from ap = A p_k."""
    name = "cheb_step"
    if not _cuda(name, b):
        return cheb_step_plain(b, ap, d, p_k, p_km1, scale, omega)
    _check(name, b, {"b": b, "ap": ap, "d": d, "p_k": p_k, "p_km1": p_km1})
    return _launch(name, "cheb_step", b, _p(b), _p(ap), _p(d), _p(p_k),
                   _p(p_km1), float(scale), float(omega))


def cheb_first_masked(b, y, ks, ms, d, x0, scale):
    """The first Chebyshev iterate from the raw apply y of x0:
    scale (d (b - (y ks + ms x0))) + x0."""
    name = "cheb_first_masked"
    if not _cuda(name, b):
        return cheb_first_masked_plain(b, y, ks, ms, d, x0, scale)
    _check(name, b, {"b": b, "y": y, "ks": ks, "ms": ms, "d": d, "x0": x0})
    return _launch(name, name, b, _p(b), _p(y), _p(ks), _p(ms), _p(d),
                   _p(x0), float(scale))


def cheb_step_masked(b, y, ks, ms, d, p_k, p_km1, scale, omega):
    """One Chebyshev step from the raw apply y of p_k (ap = y ks + ms p_k)."""
    name = "cheb_step_masked"
    if not _cuda(name, b):
        return cheb_step_masked_plain(b, y, ks, ms, d, p_k, p_km1, scale,
                                      omega)
    _check(name, b, {"b": b, "y": y, "ks": ks, "ms": ms, "d": d, "p_k": p_k,
                     "p_km1": p_km1})
    return _launch(name, name, b, _p(b), _p(y), _p(ks), _p(ms), _p(d),
                   _p(p_k), _p(p_km1), float(scale), float(omega))


# every K6 entry and its plain twin, by the name the solvers call it by
TWINS = {"cheb_first": cheb_first_plain, "cheb_step": cheb_step_plain,
         "cheb_first_masked": cheb_first_masked_plain,
         "cheb_step_masked": cheb_step_masked_plain}
