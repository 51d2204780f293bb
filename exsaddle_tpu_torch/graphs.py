"""Device bodies captured once as CUDA graphs and replayed: the port's
counterpart of jax.jit for a fixed-work body (exsaddle_tpu/abf.py:1227-1229
jits the whole solve once per solver).

A fixed-work body is a function of tensors that reads nothing back to the
host and takes no branch on a device value: the V-cycle, the p-block's
Chebyshev polynomial, the fieldsplit PC with fixed V-cycles (abf.py
`make_abf_solver`). `Captured` records such a body once and replays it, so
the host makes one graph launch where it launched every kernel of the body.
Under `loop="host"` the loops that read a residual (GCR, FGMRES, the
refinement rounds) stay on the host and call the captured bodies.

`ControlGraph` takes the loops onto the card as well (`loop="device"`, the
default on CUDA): the solve is written as Pieces (fixed-work stretches of
the loop bodies) and Loops (WHILE / IF over a predicate that a Krylov
control kernel writes, kernels/krylov_ctl.py), and the whole of it becomes
one CUDA graph whose loops are conditional nodes (csrc/graph_ctl.cu), the
counterpart of the JAX package's lax.while_loop. `run_plain` runs the same
items from Python, one host read per loop test: the reference the graph is
held against, and the CPU's path.

There is no CPU mode for a graph: the CPU runs the bodies eagerly, and
`Captured` and `ControlGraph` refuse CPU tensors."""

import collections
import contextlib
import ctypes
import gc
import os
import time

import torch

from exsaddle_tpu_torch.kernels import (_build, a00, cheb, krylov_ctl, mp,
                                       stencil, transfer)


def _check_inputs(inputs, what):
    for x in inputs:
        if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
            where = x.device if isinstance(x, torch.Tensor) else type(x)
            raise ValueError(f"{what}: CUDA tensors only, got {where}")
    if len({x.device for x in inputs}) > 1:
        raise ValueError(f"{what}: inputs on more than one device")


@contextlib.contextmanager
def collector_held():
    """Python's cyclic garbage collector held off while a CUDA graph is
    captured. torch.cuda.graph no longer collects before a capture, so a
    collection could start inside one and finalize a dead graph
    (cudaGraphExecDestroy, the frees of its private pool), which
    invalidates the capture in progress. Dead cycles wait for the next
    collection outside a capture."""
    held = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if held:
            gc.enable()


class Captured:
    """fn(*inputs) captured as one CUDA graph; every call replays it.

    inputs: example tensors, on one CUDA device, that fix the shapes and
    dtypes of the body's arguments; their values are copied into static
    input tensors. fn must be fixed-work (no host read, no data-dependent
    branch) and return one tensor. It runs once on a side stream first
    (lazy state such as cuBLAS handles, K1's node table and the kernel
    library comes into being there), then once under capture with
    torch.cuda.set_sync_debug_mode("error"), so a hidden host
    synchronisation raises at capture. Every tensor fn reads besides
    its arguments is captured by address: the caller keeps them alive and
    unchanged for as long as it replays. Each Captured has a private memory
    pool, so bodies may be replayed in any order.

    A call copies its arguments into the static inputs, replays, and returns
    a clone of the static output (the next replay overwrites it). Each
    replay adds to the kernels' launch counts (K1's launches and applies,
    K4's, K6's) what the capture recorded, since the graph launches them
    again; the capture itself launches nothing and is not counted.
    `replays` counts the calls. A capture or replay error raises; nothing
    falls back to eager launches."""

    def __init__(self, fn, *inputs):
        if not inputs:
            raise ValueError("Captured: a body needs at least one input")
        _check_inputs(inputs, "Captured")
        self._static = tuple(x.detach().clone() for x in inputs)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(inputs[0].device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn(*self._static)
            torch.cuda.current_stream().wait_stream(side)
            before = _counters()
            mode = torch.cuda.get_sync_debug_mode()
            try:
                # inside the block: entering and leaving it synchronise
                with collector_held(), torch.cuda.graph(self.graph):
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        out = fn(*self._static)
                    finally:
                        torch.cuda.set_sync_debug_mode(mode)
            finally:
                self.deltas = tuple(b - a for a, b in zip(before,
                                                          _counters()))
                _set_counters(before)
        if not isinstance(out, torch.Tensor):
            raise TypeError(f"Captured: the body returned {type(out)}, not "
                            f"a tensor")
        self._out = out
        self.replays = 0

    def __call__(self, *inputs):
        _check_inputs(inputs, "Captured call")
        if len(inputs) != len(self._static):
            raise ValueError(f"Captured call: {len(inputs)} inputs, captured "
                             f"with {len(self._static)}")
        for s, x in zip(self._static, inputs):
            if x.shape != s.shape or x.dtype != s.dtype or \
                    x.device != s.device:
                raise ValueError(f"Captured call: {tuple(x.shape)} {x.dtype} "
                                 f"on {x.device}, captured with "
                                 f"{tuple(s.shape)} {s.dtype} on {s.device}")
            s.copy_(x)
        self.graph.replay()
        self.replays += 1
        _set_counters([c + d for c, d in zip(_counters(), self.deltas)])
        return self._out.clone()


def replays(bodies):
    """Replays so far of the Captured among `bodies` ({name: callable})."""
    return sum(b.replays for b in bodies.values() if isinstance(b, Captured))


# --- loops on the device: one graph with conditional nodes -----------------

class Control:
    """The loop control of one device-loop solve: `pred` (int32), each
    loop's predicate as its control kernel last wrote it; `handles` (the
    conditional nodes' handles, by predicate slot); `counts` (int64), the
    executions of each loop body as its control kernel counts them, each
    slot named (count_names). Slots are handed out by pred_slots /
    count_slots at construction. The control kernels set the handles only
    while `armed`, i.e. while ControlGraph captures the pieces that launch
    them. trace: the solve's trace.Trace, or None; run_plain and
    ControlGraph mark the solve and its pieces in it."""

    def __init__(self, device, n_pred=16, n_count=32, trace=None):
        self.pred = torch.zeros(n_pred, dtype=torch.int32, device=device)
        self.handles = torch.zeros(n_pred, dtype=torch.int64, device=device)
        self.counts = torch.zeros(n_count, dtype=torch.int64, device=device)
        self.armed = False
        self.trace = trace
        self.count_names = []
        self._n_pred = 0

    def pred_slots(self, n):
        """The first of n new consecutive predicate slots."""
        first = self._n_pred
        self._n_pred += n
        if self._n_pred > self.pred.numel():
            raise ValueError("Control: out of predicate slots")
        return first

    def count_slots(self, *names):
        """The first of len(names) new consecutive counter slots, named in
        order."""
        first = len(self.count_names)
        if first + len(names) > self.counts.numel():
            raise ValueError("Control: out of counter slots")
        self.count_names.extend(names)
        return first

    def named(self, counts):
        """{slot name: int} of counts (Control.counts on the host)."""
        return {name: int(counts[i])
                for i, name in enumerate(self.count_names)}

    def slots(self, named):
        """The counts by slot of a named() dict."""
        return [named[name] for name in self.count_names]

    def handles_ptr(self):
        return self.handles.data_ptr() if self.armed else 0

    def read(self, slot):
        """Predicate `slot` on the host: the plain driver's one read per
        loop test."""
        return bool(self.pred[slot])


class Piece:
    """A fixed-work stretch of a loop body: fn() reads and writes the
    solver's static tensors and reads nothing back to the host."""

    def __init__(self, fn, name, parts=None):
        self.fn, self.name = fn, name
        # the Pieces it joins (merged): ControlGraph captures a run once
        self.parts = parts or (self,)


class Loop:
    """A WHILE ("while") or IF ("if") over `body` (Pieces and Loops),
    guarded by predicate slot `pred`. count: the counter slot a control
    kernel in the body adds one to per execution of the body (None where
    the body holds no Piece of its own)."""

    def __init__(self, kind, pred, body, count=None):
        if kind not in ("while", "if"):
            raise ValueError(f"Loop: kind {kind!r}")
        self.kind, self.pred, self.body, self.count = kind, pred, body, count


def merged(items):
    """items with each run of consecutive Pieces joined into one Piece."""
    out = []
    for item in items:
        if isinstance(item, Piece) and out and isinstance(out[-1], Piece):
            out[-1] = Piece(_chain(out[-1].fn, item.fn),
                            f"{out[-1].name} + {item.name}",
                            out[-1].parts + item.parts)
        else:
            out.append(item)
    return out


def _chain(f, g):
    def both():
        f()
        g()
    return both


def run_plain(items, ctl):
    """The plain driver: items in order from Python, each loop test one
    host read of its predicate (Control.read) and nothing else. This is
    the reference ControlGraph is held against, and the CPU's path. With
    ctl.trace, the solve and each merged Piece are device spans of it (a
    graph captures merged Pieces), the solve's entry counting a solve."""
    tr = ctl.trace
    if tr is None:
        _plain(items, ctl, None)
        return
    with tr.marking(), tr.span("solve", entry=True):
        _plain(items, ctl, tr)


def _plain(items, ctl, tr):
    for item in (items if tr is None else merged(items)):
        if isinstance(item, Piece):
            if tr is None:
                item.fn()
            else:
                with tr.span(item.name):
                    item.fn()
        elif item.kind == "while":
            while ctl.read(item.pred):
                _plain(item.body, ctl, tr)
        elif ctl.read(item.pred):
            _plain(item.body, ctl, tr)


_V = ctypes.c_void_p
_SHIM = {"gc_versions": [_V, _V], "gc_graph_create": [_V],
         "gc_handle_create": [_V, _V, ctypes.c_uint],
         "gc_add_conditional": [_V, ctypes.c_ulonglong, ctypes.c_int, _V, _V],
         "gc_add_child": [_V, _V, _V], "gc_add_edge": [_V, _V, _V],
         "gc_instantiate": [_V, ctypes.c_int, _V], "gc_launch": [_V, _V],
         "gc_exec_destroy": [_V], "gc_graph_destroy": [_V],
         "gc_kernel_nodes": [_V, _V]}


def _shim():
    lib = _build.load()
    for name, args in _SHIM.items():
        f = getattr(lib, name)
        f.argtypes = args
        f.restype = ctypes.c_int
    lib.gc_error_string.argtypes = [ctypes.c_int]
    lib.gc_error_string.restype = ctypes.c_char_p
    return lib


def kernels_per_call(fn):
    """The kernel launches one call of fn makes on CUDA: the kernel nodes
    of the graph one call is captured into (after a warm-up call). The
    counts fn's wrappers keep are left as they were."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    before = _counters()
    try:
        with collector_held(), torch.cuda.graph(g):
            fn()
    finally:
        _set_counters(before)
    lib = _shim()
    n = ctypes.c_ulonglong()
    err = lib.gc_kernel_nodes(_V(g.raw_cuda_graph()), ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"gc_kernel_nodes failed: "
                           f"{lib.gc_error_string(err).decode()} ({err})")
    return n.value


# counters besides the kernels' that a body or piece moves (track)
_TRACKED = []


def track(counter):
    """Count `counter` (an object with an int `n`, bumped by the Python code
    whose work it counts) as the kernels' launches are counted: a capture
    records what it moved and takes that back out, and each replay or
    counted execution adds it again (e.g. the cartesian solve's halo
    exchanges, parallel/cart_abf.py). Register at import, before any
    capture."""
    _TRACKED.append(counter)


def _counters():
    """Every count a body or piece can move: K1's launches and applies,
    K4's, K6's, K4's by fused epilogue, each control kernel's, K5's and
    K5's by form, K1's by form and its factored applies, K6's by form,
    K3's and K3's by form, then the tracked counters."""
    return ((a00.LAUNCHES.n, a00.LAUNCHES.applies, stencil.LAUNCHES.n,
             cheb.LAUNCHES.n)
            + tuple(stencil.LAUNCHES.fused[e] for e in stencil.EPILOGUES)
            + tuple(krylov_ctl.LAUNCHES.n[k] for k in krylov_ctl.NAMES)
            + (transfer.LAUNCHES.n,)
            + tuple(transfer.LAUNCHES.by[f] for f in transfer.FORMS)
            + tuple(a00.LAUNCHES.by[f] for f in a00.FORMS)
            + (a00.LAUNCHES.factored,)
            + tuple(cheb.LAUNCHES.by[f] for f in cheb.FORMS)
            + (mp.LAUNCHES.n,) + tuple(mp.LAUNCHES.by[f] for f in mp.FORMS)
            + tuple(c.n for c in _TRACKED))


def _counter_names():
    """Names of _counters()' entries, in its order: <module>.n (launches),
    a00.applies, stencil.fused.<epilogue>, krylov_ctl.<kernel>,
    <module>.<form>, a00.factored, tracked.<i>."""
    return (("a00.n", "a00.applies", "stencil.n", "cheb.n")
            + tuple(f"stencil.fused.{e}" for e in stencil.EPILOGUES)
            + tuple(f"krylov_ctl.{k}" for k in krylov_ctl.NAMES)
            + ("transfer.n",)
            + tuple(f"transfer.{f}" for f in transfer.FORMS)
            + tuple(f"a00.{f}" for f in a00.FORMS) + ("a00.factored",)
            + tuple(f"cheb.{f}" for f in cheb.FORMS)
            + ("mp.n",) + tuple(f"mp.{f}" for f in mp.FORMS)
            + tuple(f"tracked.{i}" for i in range(len(_TRACKED))))


def _set_counters(vals):
    (a00.LAUNCHES.n, a00.LAUNCHES.applies, stencil.LAUNCHES.n,
     cheb.LAUNCHES.n) = vals[:4]
    vals = list(vals[4:])
    for e in stencil.EPILOGUES:
        stencil.LAUNCHES.fused[e] = vals.pop(0)
    for k in krylov_ctl.NAMES:
        krylov_ctl.LAUNCHES.n[k] = vals.pop(0)
    transfer.LAUNCHES.n = vals.pop(0)
    for f in transfer.FORMS:
        transfer.LAUNCHES.by[f] = vals.pop(0)
    for f in a00.FORMS:
        a00.LAUNCHES.by[f] = vals.pop(0)
    a00.LAUNCHES.factored = vals.pop(0)
    for f in cheb.FORMS:
        cheb.LAUNCHES.by[f] = vals.pop(0)
    mp.LAUNCHES.n = vals.pop(0)
    for f in mp.FORMS:
        mp.LAUNCHES.by[f] = vals.pop(0)
    for c, v in zip(_TRACKED, vals):
        c.n = v


_CAPTURE_STREAMS = {}


def capture_stream(device):
    """The stream to capture on for `device`, or None for torch's default:
    torch.cuda.graph's default capture stream is made once, on the device
    current at its first use, so a capture on any other card is given a
    stream of its own (else its work would run eagerly, uncaptured)."""
    default = torch.cuda.graph.default_capture_stream
    if default is None or default.device == device:
        return None
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device]


# a run of Pieces as ControlGraph holds it: its name, captured torch graph,
# the count slot of its executions (None: once per launch), the counter
# deltas its capture recorded, the trace marks in it, and the Piece
CapturedPiece = collections.namedtuple(
    "CapturedPiece", "name graph slot deltas marks piece")


class ControlGraph:
    """`items` (Pieces and Loops) as ONE instantiated CUDA graph: every
    Loop a conditional node (WHILE or IF) whose handle the loop's control
    kernel sets, every run of Pieces one captured child graph, chained in
    order inside its loop's body graph. launch() runs a whole solve as one
    cudaGraphLaunch; the loops test their predicates on the device.

    Built in three passes: the conditional nodes top down (each handle
    must exist before the pieces that set it are captured; its value
    resets to 0 at each launch, and the control kernels set every handle
    before its node runs); each piece run once eagerly on a side stream
    (lazy state: cuBLAS, K1's node table) and then captured with
    torch.cuda.CUDAGraph(keep_graph=True) under
    torch.cuda.set_sync_debug_mode("error") in a private memory pool, its
    raw graph added as a child-graph node; then the edges, and
    instantiation. Any CUDA error raises: there is no fallback.

    A piece's kernel launches (K1, K4, K5, K6, control) are recorded at
    capture and not counted; account(counts) adds them times the
    executions the device counted (Control.counts, brought back with the
    result), and kernel_nodes(counts) counts the kernel nodes that ran.
    The capture keeps the pieces' tensors by address: the caller keeps
    them alive and never rebinds them.

    With ctl.trace (trace.Trace), each captured piece is a device span
    named by Piece.name (a mark kernel first and last in its child graph;
    the warm-up run marks nothing) and the root graph's first and last
    nodes are marks of the span `solve`, the first counting a solve on
    the device. Without it the graph holds no mark.

    share: an earlier ControlGraph over the same Control; a run of Pieces
    it captured is added here as the same child graph, not captured
    again (a direct solve and a refinement over one FGMRES loop). Each
    graph keeps its own handles and writes them into Control.handles at
    launch, so graphs over one Control take turns, never run at once."""

    def __init__(self, items, ctl, share=None):
        self.ctl = ctl
        dev = ctl.pred.device
        if dev.type != "cuda":
            raise ValueError(f"ControlGraph: CUDA only, got {dev}")
        self._lib = _shim()
        alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF", "")
        if "cudaMallocAsync" in alloc:
            raise RuntimeError("ControlGraph: the cudaMallocAsync allocator "
                               "puts memory nodes into captured graphs, "
                               "which a conditional body cannot hold")
        self.device = dev
        # a conditional node, its handle and its body's nodes belong to the
        # context current when they are made: the graph's own card
        with torch.cuda.device(dev):
            self._build(items, ctl, share)
        self.launches = 0
        self._nodes = {}

    def _build(self, items, ctl, share):
        """The three passes of the constructor, on the graph's card."""
        dev = self.device
        self.root = self._out("gc_graph_create")
        handles = {}
        chains = []     # (graph, [node or (piece, count)] in order)

        def skeleton(graph, body, count):
            chain = []
            for item in merged(body):
                if isinstance(item, Piece):
                    chain.append((item, count))
                    continue
                h = ctypes.c_ulonglong()
                self._call("gc_handle_create", _V(graph), ctypes.byref(h), 0)
                handles[item.pred] = h.value
                node, sub = _V(), _V()
                self._call("gc_add_conditional", _V(graph), h.value,
                           int(item.kind == "while"), ctypes.byref(node),
                           ctypes.byref(sub))
                chain.append(node.value)
                skeleton(sub.value, item.body, item.count)
            chains.append((graph, chain))

        t0 = time.perf_counter()
        skeleton(self.root, items, None)
        hv = torch.zeros_like(ctl.handles, device="cpu")
        for slot, h in handles.items():
            hv[slot] = h
        self.handles = hv.to(dev)
        tr = ctl.trace
        if tr is not None:
            # the solve span: the root graph's first and last nodes
            root_chain = chains[-1][1]
            root_chain.insert(0, self._mark_node(
                lambda: tr.mark("solve", False, entry=True)))
            root_chain.append(self._mark_node(
                lambda: tr.mark("solve", True)))
        # (torch graph, counter deltas, marks) by the Pieces a run joins
        self.captured = dict(share.captured) if share is not None else {}
        self.pieces = []    # CapturedPiece, in the order of the chains
        for graph, chain in chains:
            for i, entry in enumerate(chain):
                if isinstance(entry, tuple):
                    piece, count = entry
                    if piece.parts not in self.captured:
                        self.captured[piece.parts] = self._capture(
                            self._spanned(piece), warm=piece.fn)
                    g, deltas, marks = self.captured[piece.parts]
                    self.pieces.append(CapturedPiece(piece.name, g, count,
                                                     deltas, marks, piece))
                    node = _V()
                    self._call("gc_add_child", _V(graph),
                               _V(g.raw_cuda_graph()), ctypes.byref(node))
                    chain[i] = node.value
            for a, b in zip(chain, chain[1:]):
                self._call("gc_add_edge", _V(graph), _V(a), _V(b))
        self.exec = self._out("gc_instantiate", _V(self.root),
                              dev.index or 0)
        self.capture_seconds = time.perf_counter() - t0

    def _call(self, name, *args):
        err = getattr(self._lib, name)(*args)
        if err != 0:
            raise RuntimeError(f"ControlGraph: {name} failed: "
                               f"{self._lib.gc_error_string(err).decode()} "
                               f"({err})")

    def _out(self, name, *args):
        p = _V()
        self._call(name, *args, ctypes.byref(p))
        return p.value

    def _spanned(self, piece):
        """piece.fn, inside the device span piece.name with a trace."""
        tr = self.ctl.trace
        if tr is None:
            return piece.fn

        def spanned():
            with tr.marking(), tr.span(piece.name):
                piece.fn()
        return spanned

    def _mark_node(self, mark):
        """A child node of the root graph (a clone of the captured graph):
        `mark` (one trace mark) captured alone; returns the node."""
        g, _, _ = self._capture(mark)
        node = _V()
        self._call("gc_add_child", _V(self.root), _V(g.raw_cuda_graph()),
                   ctypes.byref(node))
        return node.value

    def _capture(self, fn, warm=None):
        """(torch graph, counter deltas, trace marks) of fn captured, after
        one run of `warm` on a side stream."""
        tr = self.ctl.trace
        marks = tr.marks if tr is not None else 0
        with torch.cuda.device(self.device):
            if warm is not None:
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    warm()
                torch.cuda.current_stream().wait_stream(side)
            g = torch.cuda.CUDAGraph(keep_graph=True)
            before = _counters()
            mode = torch.cuda.get_sync_debug_mode()
            self.ctl.armed = True
            try:
                with collector_held(), torch.cuda.graph(
                        g, stream=capture_stream(self.device)):
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        fn()
                    finally:
                        torch.cuda.set_sync_debug_mode(mode)
            finally:
                self.ctl.armed = False
                after = _counters()
                _set_counters(before)
        if tr is not None:
            marks = tr.marks - marks
        return g, tuple(b - a for a, b in zip(before, after)), marks

    def launch(self):
        """One launch of the whole graph on the current stream, after its
        handles (a device copy into Control.handles)."""
        with torch.cuda.device(self.device):
            self.ctl.handles.copy_(self.handles)
            self._call("gc_launch", _V(self.exec), _V(
                torch.cuda.current_stream(self.device).cuda_stream))
        self.launches += 1

    def account(self, counts):
        """Add to the launch counts what the last launch ran: each piece's
        captured launches times its executions (counts: Control.counts on
        the host; a piece outside any loop ran once)."""
        total = list(_counters())
        for p in self.pieces:
            n = 1 if p.slot is None else int(counts[p.slot])
            total = [t + n * d for t, d in zip(total, p.deltas)]
        _set_counters(total)

    def counted(self, counts, counter):
        """What one launch for `counts` added to `counter` (a tracked
        counter, track()): each captured piece's delta times its
        executions."""
        k = len(_counters()) - len(_TRACKED) + _TRACKED.index(counter)
        return sum((1 if p.slot is None else int(counts[p.slot]))
                   * p.deltas[k] for p in self.pieces)

    def kernel_nodes(self, counts):
        """The kernel nodes one launch ran for `counts` (Control.counts on
        the host, by slot), counted from the captured graphs only when
        called: {"total", "pieces": {piece name: each captured piece's
        kernel nodes, its trace marks left out, times its executions},
        "launches": {_counter_names(): the hand-written kernels' launches
        and applies, from the deltas account() adds}}."""
        pieces, launches = {}, [0] * len(_counters())
        for i, p in enumerate(self.pieces):
            if i not in self._nodes:
                n = ctypes.c_ulonglong()
                self._call("gc_kernel_nodes", _V(p.graph.raw_cuda_graph()),
                           ctypes.byref(n))
                self._nodes[i] = n.value - p.marks
            n = 1 if p.slot is None else int(counts[p.slot])
            pieces[p.name] = pieces.get(p.name, 0) + n * self._nodes[i]
            launches = [t + n * d for t, d in zip(launches, p.deltas)]
        return {"total": sum(pieces.values()), "pieces": pieces,
                "launches": dict(zip(_counter_names(), launches))}

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is None:
            return
        if getattr(self, "exec", None):
            lib.gc_exec_destroy(_V(self.exec))
        if getattr(self, "root", None):
            lib.gc_graph_destroy(_V(self.root))
