"""K1: the fused velocity-block (A00) apply, hand-written for Hopper.

    y_u = sum_e G_e^T Bs^T diag(s_e) Bs G_e x_u      (no Dirichlet masks)

Replaces exsaddle_tpu/pallas_apply.py:make_pallas_mult_u (the repo's one
Pallas kernel). Source: csrc/a00_apply.cu; built by kernels/_build.py.

`a00_apply(op, xu)` takes the flat parity-permuted velocity vector and the
ParityMatFreeOperator holding Bs and scale_visc, and returns a new flat
vector. On a CUDA tensor it launches the kernel (or raises); on a CPU tensor
it runs `a00_apply_plain`, the same arithmetic in PyTorch ops. Callers apply
the keep/mask Dirichlet elimination around it (abf.mult_u_tree,
matfree.mult_tree).

One apply is two launches: the element products into a scratch (nel, ncol)
array, then a node gather that sums each dof's element contributions in the
order of `node_gather_table` (held on the device by the operator,
ParityMatFreeOperator.node_table)."""

import ctypes

import numpy as np
import torch

from exsaddle_tpu_torch.grid_ops import (split_u_parity, gather_u_parity,
                                         scatter_u_parity)
from exsaddle_tpu_torch.kernels import _build


class LaunchCount:
    """Device launches (`n`) and applies (`applies`) that a wrapper sent to
    its kernels. Plain-version calls are not counted. Inside a CUDA graph
    capture the wrapper launches nothing; graphs.Captured takes its counts
    back out and adds them on every replay."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.n = 0
        self.applies = 0


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


def _fn(dtype):
    global _bound
    lib = _build.load()
    if not _bound:
        for name in ("a00_apply_f32", "a00_apply_f64"):
            f = getattr(lib, name)
            f.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
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
    nel = int(np.prod(op.m_el))
    if op.nu >= 2 ** 31 or nel * _BS_SHAPE[nd][1] >= 2 ** 31:
        raise ValueError(f"a00_apply: {op.nu} dofs overflow int32 indices")
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
    nd = len(op.m_el)
    mx, my = op.m_el[0], op.m_el[1]
    mz = op.m_el[2] if nd == 3 else 1
    table = op.node_table
    with torch.cuda.device(xu.device):
        ye = torch.empty(op.scale_visc.shape[0], _BS_SHAPE[nd][1],
                         dtype=xu.dtype, device=xu.device)
        y = torch.empty_like(xu)
        err = fn(xu.data_ptr(), op.scale_visc.data_ptr(), op.Bs.data_ptr(),
                 table.data_ptr(), ye.data_ptr(), y.data_ptr(), nd, mx, my,
                 mz, torch.cuda.current_stream(xu.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"a00_apply kernel launch failed: "
                           f"{lib.a00_error_string(err).decode()} ({err})")
    LAUNCHES.n += KERNELS_PER_APPLY
    LAUNCHES.applies += 1
    return y
