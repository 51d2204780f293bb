"""K7: classical Gram-Schmidt against the live rows of a Krylov window,
hand-written for Hopper (source csrc/gram_schmidt.cu, built by
kernels/_build.py), three launches per orthogonalisation:

    dots(V, t, live, plus, scratch, weight, count)
        h[j] = sum_i V[j, i] (w_i t_i) for j < L, h[j] = 0 for L <= j < rows
    combine(V, h, v, live, plus, scratch, S, s, weight)
        v' = v - sum_{j<L} h_j V_j (and s' = s - sum_{j<L} h_j S_j), and
        sumsq = sum_i (w_i v'_i) v'_i, from one pass
    normalize(v, sumsq, V, ix, S, s, in_place)
        alpha = sqrt(sumsq); v' (and s') times 1 / alpha (1 where alpha is 0)
        into the window row V[ix] (S[ix]) and, with in_place, into v (s)

L = live + plus clamped to [0, rows] is read on the device (`live` a
one-entry int32 tensor: GCR's nv with plus 0, FGMRES's it with plus 1), so a
CUDA graph holds the launches at one shape and reads nothing back. weight:
the sharded layouts' ownership weight (treeops.make_dots), None on one
device; a sharded solver sums the dots and sumsq over its shards between
the launches. count (an int64 one-entry tensor, e.g. a Control.counts slot)
gets L added by the dots. Replaces exsaddle_tpu/treeops.py:106 buf_dots and
:128 buf_comb, the masked whole-window products; the kernels read only the
live rows, which bound them (see the source).

On a CUDA tensor a wrapper launches its kernel (or raises) and adds one to
LAUNCHES.n and LAUNCHES.by[its name]; on a CPU tensor it runs its plain twin
(TWINS). The twins repeat the kernels' arithmetic: the same partition of the
entries into blocks of CHUNK and threads, the same fold of each block and
of the per-block partials, every product and sum rounded alone, so kernel
and twin are bitwise equal. They form every row's dots and terms and mask
those past L, which changes no bit (a zero term added to a sum that starts
from +0 leaves it as it is) and reads nothing back to the host."""

import ctypes

import torch
import torch.nn.functional as F

from exsaddle_tpu_torch.kernels import _build

FORMS = ("dots", "combine", "normalize")

# csrc/gram_schmidt.cu's partition and its largest window
THREADS = 256
ITEMS = 4
CHUNK = THREADS * ITEMS
WARPS = THREADS // 32
MAX_ROWS = 64


class _Launches(_build.Launches):
    """`n`: every launch of K7; `by`: the launches of each form (FORMS)."""

    def __init__(self):
        super().__init__()
        self.by = dict.fromkeys(FORMS, 0)

    def reset(self):
        super().reset()
        self.by = dict.fromkeys(FORMS, 0)


LAUNCHES = _Launches()


def blocks(n):
    """The kernels' blocks (and per-block partials) for n entries."""
    return -(-n // CHUNK)


class Scratch:
    """The device scratch of one window's orthogonalisations: the per-block
    partials of dots and combine, and the ticket by which their last block
    is found (zero between launches; each launch leaves it zero). Made once
    by the caller, outside any graph capture, and passed to every call; on
    the CPU the twins need none and it holds nothing."""

    def __init__(self, n, rows, dtype, device):
        device = torch.device(device)
        self.part = self.ticket = None
        if device.type == "cuda":
            self.part = torch.zeros(rows * blocks(n), dtype=dtype,
                                    device=device)
            self.ticket = torch.zeros(1, dtype=torch.int32, device=device)


# --- twins -------------------------------------------------------------------

def _fold32(x):
    """The warp's shuffle fold over the last axis (32 lanes): x_l +
    x_{l + off} for off = 16, 8, 4, 2, 1; the lane-0 value."""
    for off in (16, 8, 4, 2, 1):
        x = x[..., :off] + x[..., off:2 * off]
    return x[..., 0]


def _block_sums(x):
    """(..., n) -> (..., blocks(n)): each block's partial, as the kernels
    sum it: per thread over its ITEMS entries in order from 0, the warp's
    fold, the warps in order from 0."""
    n = x.shape[-1]
    nb = blocks(n)
    x = F.pad(x, (0, nb * CHUNK - n)).reshape(*x.shape[:-1], nb, ITEMS,
                                               THREADS)
    acc = torch.zeros_like(x[..., 0, :])
    for k in range(ITEMS):
        acc = acc + x[..., k, :]
    acc = _fold32(acc.reshape(*acc.shape[:-1], WARPS, 32))
    s = torch.zeros_like(acc[..., 0])
    for q in range(WARPS):
        s = s + acc[..., q]
    return s


def _fold_partials(p):
    """(..., nb) -> (...): the last block's fold of the partials: lane l
    adds l, l + 32, ... in order from 0, then the warp's fold."""
    nb = p.shape[-1]
    m = -(-nb // 32)
    p = F.pad(p, (0, 32 * m - nb)).reshape(*p.shape[:-1], m, 32)
    acc = torch.zeros_like(p[..., 0, :])
    for i in range(m):
        acc = acc + p[..., i, :]
    return _fold32(acc)


def _live(live, plus, rows):
    """L on live's device: live + plus clamped to [0, rows] (one entry)."""
    return (live.reshape(1) + plus).clamp(0, rows)


def _below(live, plus, rows, like):
    """The rows j < L, as a bool vector on like's device."""
    return torch.arange(rows, device=like.device) < _live(live, plus, rows)


def dots_plain(V, t, live, plus, scratch=None, weight=None, count=None):
    """The twin of dots."""
    rows = V.shape[0]
    tw = t if weight is None else weight * t
    h = _fold_partials(_block_sums(V * tw))
    h = torch.where(_below(live, plus, rows, h), h, torch.zeros_like(h))
    if count is not None:
        count.add_(_live(live, plus, rows))
    return h


def combine_plain(V, h, v, live, plus, scratch=None, S=None, s=None,
                  weight=None):
    """The twin of combine: (v', s' or None, sumsq)."""
    rows = V.shape[0]
    hm = torch.where(_below(live, plus, rows, h), h, torch.zeros_like(h))
    av = torch.zeros_like(v)
    as_ = None if S is None else torch.zeros_like(s)
    for j in range(rows):
        av = av + hm[j] * V[j]
        if S is not None:
            as_ = as_ + hm[j] * S[j]
    vo = v - av
    so = None if S is None else s - as_
    terms = vo * vo if weight is None else (weight * vo) * vo
    return vo, so, _fold_partials(_block_sums(terms))


def normalize_plain(v, sumsq, V, ix, S=None, s=None, in_place=True):
    """The twin of normalize: alpha."""
    alpha = torch.sqrt(sumsq)
    inv = 1.0 / torch.where(alpha == 0.0, torch.ones_like(alpha), alpha)
    vn = inv * v
    V.index_copy_(0, ix, vn[None])
    if in_place:
        v.copy_(vn)
    if S is not None:
        sn = inv * s
        S.index_copy_(0, ix, sn[None])
        if in_place:
            s.copy_(sn)
    return alpha


# --- wrappers ----------------------------------------------------------------

_V = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = {
    "gs_dots": [_V, _V, _V, _L, _I, _V, _I, _V, _V, _V, _V, _V],
    "gs_combine": [_V] * 6 + [_L, _I, _V, _I] + [_V] * 6,
    "gs_normalize": [_V, _V, _V, _L, _I, _V, _V, _V, _V, _I, _V],
}
_bound = False


def _lib():
    global _bound
    lib = _build.load()
    if not _bound:
        for base, args in _ARGTYPES.items():
            for sfx in ("_f32", "_f64"):
                f = getattr(lib, base + sfx)
                f.argtypes = args
                f.restype = ctypes.c_int
        _bound = True
    return lib


def _cuda(name, t):
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def _check(name, like, tensors):
    """Every tensor on like's device, contiguous, of its dtype (None: the
    working dtype) and, where given, its shape."""
    if like.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {like.dtype} not supported")
    for key, (t, dtype, shape) in tensors.items():
        if t is None:
            continue
        if t.device != like.device:
            raise ValueError(f"{name}: {key} on {t.device}, not "
                             f"{like.device}")
        if t.dtype != (like.dtype if dtype is None else dtype):
            raise TypeError(f"{name}: {key} is {t.dtype}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {key} is {tuple(t.shape)}, not "
                             f"{tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")


def _window(name, V, scratch):
    rows, n = V.shape
    if not 0 < rows <= MAX_ROWS or n == 0:
        raise ValueError(f"{name}: window {tuple(V.shape)}: 1 to {MAX_ROWS} "
                         f"rows of at least one entry")
    if scratch is None or scratch.part is None or \
            scratch.part.numel() < rows * blocks(n):
        raise ValueError(f"{name}: needs a Scratch for {rows} rows of {n}")
    return rows, n


def _ptr(t):
    return _V(0) if t is None else _V(t.data_ptr())


def _launch(name, form, like, *args):
    lib = _lib()
    sfx = "_f32" if like.dtype == torch.float32 else "_f64"
    with torch.cuda.device(like.device):
        err = getattr(lib, "gs_" + form + sfx)(
            *args, _V(torch.cuda.current_stream(like.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{_build.error_string(lib, err)}")
    LAUNCHES.n += 1
    LAUNCHES.by[form] += 1


def dots(V, t, live, plus, scratch=None, weight=None, count=None):
    """h (rows entries): the dots of V's first L rows with t (times the
    weight), zero past them; count gets L added."""
    name = "gram_schmidt.dots"
    if not _cuda(name, V):
        return dots_plain(V, t, live, plus, scratch, weight, count)
    rows, n = _window(name, V, scratch)
    _check(name, V, {"V": (V, None, None), "t": (t, None, (n,)),
                     "weight": (weight, None, (n,)),
                     "live": (live, torch.int32, (1,)),
                     "count": (count, torch.int64, (1,)),
                     "part": (scratch.part, None, None),
                     "ticket": (scratch.ticket, torch.int32, None)})
    with torch.cuda.device(V.device):
        h = torch.empty(rows, dtype=V.dtype, device=V.device)
    _launch(name, "dots", V, _ptr(V), _ptr(t), _ptr(weight), n, rows,
            _ptr(live), plus, _ptr(scratch.part), _ptr(scratch.ticket),
            _ptr(h), _ptr(count))
    return h


def combine(V, h, v, live, plus, scratch=None, S=None, s=None, weight=None):
    """(v', s' or None, sumsq): v less h's first L rows' combination of V
    (s of S), and the (weighted) sum of squares of v'."""
    name = "gram_schmidt.combine"
    if not _cuda(name, V):
        return combine_plain(V, h, v, live, plus, scratch, S, s, weight)
    rows, n = _window(name, V, scratch)
    if (S is None) != (s is None):
        raise ValueError(f"{name}: S and s come together")
    _check(name, V, {"V": (V, None, None), "S": (S, None, (rows, n)),
                     "h": (h, None, (rows,)), "v": (v, None, (n,)),
                     "s": (s, None, (n,)), "weight": (weight, None, (n,)),
                     "live": (live, torch.int32, (1,)),
                     "part": (scratch.part, None, None),
                     "ticket": (scratch.ticket, torch.int32, None)})
    with torch.cuda.device(V.device):
        vo = torch.empty_like(v)
        so = None if s is None else torch.empty_like(s)
        sumsq = torch.empty((), dtype=V.dtype, device=V.device)
    _launch(name, "combine", V, _ptr(V), _ptr(S), _ptr(h), _ptr(v), _ptr(s),
            _ptr(weight), n, rows, _ptr(live), plus, _ptr(vo), _ptr(so),
            _ptr(scratch.part), _ptr(scratch.ticket), _ptr(sumsq))
    return vo, so, sumsq


def normalize(v, sumsq, V, ix, S=None, s=None, in_place=True):
    """alpha = sqrt(sumsq): v (and s) times 1 / alpha (1 where alpha is 0)
    into row ix of V (S) and, with in_place, into v (s)."""
    name = "gram_schmidt.normalize"
    if not _cuda(name, V):
        return normalize_plain(v, sumsq, V, ix, S, s, in_place)
    rows, n = V.shape
    if (S is None) != (s is None):
        raise ValueError(f"{name}: S and s come together")
    _check(name, V, {"V": (V, None, None), "S": (S, None, (rows, n)),
                     "v": (v, None, (n,)), "s": (s, None, (n,)),
                     "sumsq": (sumsq, None, None),
                     "ix": (ix, torch.int64, (1,))})
    if sumsq.numel() != 1 or n == 0:
        raise ValueError(f"{name}: sumsq of {sumsq.numel()} entries, "
                         f"window {tuple(V.shape)}")
    with torch.cuda.device(V.device):
        alpha = torch.empty((), dtype=V.dtype, device=V.device)
    _launch(name, "normalize", V, _ptr(v), _ptr(s), _ptr(sumsq), n, rows,
            _ptr(ix), _ptr(V), _ptr(S), _ptr(alpha), int(in_place))
    return alpha


# every K7 entry and its plain twin
TWINS = {"dots": dots_plain, "combine": combine_plain,
         "normalize": normalize_plain}
