"""Collectives between the cards of one process, for the sharded solve with
one shard on each card (source csrc/peer_collective.cu, built by
kernels/_build.py; parallel/shard_mesh.CardMesh calls them).

A group holds, per card, a send buffer of SLOTS slots, a mailbox (one
entry per card, written by that card), an epoch counter, an error word and
a wait counter. A collective on one card waits until every peer has read
the slot it is about to reuse (epoch % SLOTS: every peer has posted
epoch - SLOTS + 1), packs its outgoing values into it, posts its epoch
into every peer's mailbox, waits until each card it reads from has posted
the same epoch (at most TIMEOUT_S), then reads what it needs from those
cards' slots and adds it into its planes (ADD), copies it out (COPY) or
folds every card's partial in global card order (FOLD). A psum and a
gather read from every peer; a halo or ghost exchange only from the
cards whose planes it takes, so a card runs at most SLOTS - 1
collectives ahead of the slowest. The source states why a slot is never
overwritten before every peer read it.

A collective's `ins` are destinations (dst, sources), each source (card,
offset in its slot, strides over dst's dims or None: packed in dst's
order). COPY and FOLD take one source per destination; ADD 1, 3 or 7,
summed with dst's own value pairwise in the order listed ((dst + s0) +
(s1 + s2) for 3): a halo over every split axis at once gives the
axis-by-axis sequence's bits that way (parallel/shard_mesh.py
CardMesh.halo_add_merged).

Two groups share that protocol:
  CudaGroup    distinct CUDA cards with peer access between every pair:
               one kernel launch per collective on the card's current
               stream, so a CUDA graph captures it (graphs.ControlGraph);
  ThreadGroup  its twin on the CPU, one Python thread per card, the
               mailboxes under a threading.Condition: the bookkeeping and
               the arithmetic (torch ops in the kernel's order) checked
               where no card is.

Both record each collective (its card and what it is) as a site, and
each card's time in its waits (wait_seconds); a wait that times out sets
the card's error word (site, epoch, the peer waited for), after which
that card's collectives skip their waits and FOLD and COPY give zeros,
so its loops end; check() raises naming card and
collective. A group whose error words are set is out of step: reset()
before it is used again.

The counters below count the collectives and the partials they reduce
(every cross-card collective, whatever the group): tracked by graphs
(parallel/shard_mesh.py registers them), so a graph's executions count
what its capture recorded."""

import ctypes
import threading
import time

import torch

from exsaddle_tpu_torch.kernels import _build
from exsaddle_tpu_torch.kernels._build import Launches

MAX_CARDS = 8
# per collective: packed views, destinations and their sources (an ADD
# destination sums its own value and 1, 3 or 7 sources)
MAX_OUT, MAX_IN, MAX_SOURCES = 16, 24, 48
THREADS = 256
MAX_BLOCKS = 32
SLOTS = 4
# the bounded wait of every collective (read when a group is made)
TIMEOUT_S = 10.0
ADD, COPY, FOLD = 0, 1, 2

# per card: cross-card reductions (psums and the L-2 gather) and halo and
# ghost exchanges issued, the values the psums reduce (Sigma of the
# partials' lengths), and the halos among those exchanges done as one
# collective over two or more axes
PSUMS = Launches()
HALOS = Launches()
PSUM_VALUES = Launches()
MERGED_HALOS = Launches()
COUNTERS = (PSUMS, HALOS, PSUM_VALUES, MERGED_HALOS)


def slot_of(epoch):
    """The send slot a collective of this epoch packs into."""
    return epoch % SLOTS


def waits_of(card, n, mode, ins):
    """The cards a collective on `card` waits for (a bit mask): every peer
    for FOLD, else the cards its destinations' sources come from."""
    if mode == FOLD:
        return ((1 << n) - 1) & ~(1 << card)
    mask = 0
    for _, srcs in ins:
        for c, _, _ in srcs:
            mask |= 1 << c
    return mask


def source_strides(dst, strides):
    """A source's strides over the dims of dst (strides None: packed in
    dst's row-major order)."""
    if strides is not None:
        return list(strides)
    out, step = [], 1
    for s in reversed(dst.shape):
        out.append(step)
        step *= s
    return out[::-1]


def plan(sizes):
    """Offsets of moves in their senders' slots: sizes[m] = (sender,
    values) in the order every card lists the moves; each sender's values
    are packed one after another in that order."""
    used, offs = {}, []
    for src, n in sizes:
        offs.append(used.get(src, 0))
        used[src] = offs[-1] + n
    return offs


def fold(parts):
    """Every card's partial summed in global card order: s = p0; s = s +
    p1; ... (ShardMesh.psum's fold)."""
    s = parts[0]
    for p in parts[1:]:
        s = s + p
    return s


def _site_text(sites, site):
    card, what = sites[site] if 0 <= site < len(sites) else (None, "?")
    return f"{what} (site {site}, card {card})"


class _Group:
    """What both groups keep: the cards, capacity, sites and error
    reports."""

    def __init__(self, devices, capacity):
        self.devices = tuple(torch.device(d) for d in devices)
        self.n = len(self.devices)
        if not 1 < self.n <= MAX_CARDS:
            raise ValueError(f"a peer group holds 2 to {MAX_CARDS} cards, "
                             f"not {self.n}")
        self.capacity = int(capacity)
        if not 0 < self.capacity < 2 ** 31:
            raise ValueError(f"a send slot holds 1 to 2**31 - 1 values, not "
                             f"{self.capacity}")
        self.timeout_s = TIMEOUT_S
        self.sites = []
        self.rehearse = False

    def _site(self, card, what):
        self.sites.append((card, what))
        return len(self.sites) - 1

    def _check_items(self, mode, outs, ins):
        nsrc = sum(len(srcs) for _, srcs in ins)
        if (len(outs) > MAX_OUT or len(ins) > MAX_IN
                or nsrc > MAX_SOURCES):
            raise ValueError(f"a collective packs at most {MAX_OUT} views "
                             f"and fills {MAX_IN} from {MAX_SOURCES} "
                             f"sources, not {len(outs)}, {len(ins)} and "
                             f"{nsrc}")
        counts = (1, 3, 7) if mode == ADD else (1,)
        if any(len(srcs) not in counts for _, srcs in ins):
            raise ValueError(f"a destination of mode {mode} takes "
                             f"{' or '.join(map(str, counts))} sources")
        if sum(t.numel() for t, _ in outs) > self.capacity:
            raise ValueError(f"outgoing values exceed the slot's "
                             f"{self.capacity}")
        for t in [t for t, _ in outs] + [t for t, _ in ins]:
            if t.dtype != torch.float64:
                raise TypeError(f"peer collectives move float64, not "
                                f"{t.dtype}")

    def rehearsal(self):
        """True in a warm-up run before a capture (rehearse set, no capture
        on the current stream): the collective meets no peer and must
        launch nothing."""
        return False

    def check(self):
        """Raise where some card's error word is set: the card, the
        collective and the peer its wait timed out on."""
        bad = [(c, w) for c, w in enumerate(self.errors()) if w[0]]
        if bad:
            self.reset()
            raise RuntimeError("peer wait timed out (" + "; ".join(
                f"{self.devices[c]} in {_site_text(self.sites, w[1])} at "
                f"epoch {w[2]}, waiting for {self.devices[w[3]]}"
                for c, w in bad) + f", timeout {self.timeout_s} s); the "
                "group was reset")


class CudaGroup(_Group):
    """Distinct CUDA cards, peer access enabled between every pair (raises
    where some pair has none): the collectives are peer_kernel launches.
    capacity: values per send slot (float64)."""

    def __init__(self, devices, capacity):
        super().__init__(devices, capacity)
        if (any(d.type != "cuda" for d in self.devices)
                or len(set(self.devices)) != self.n):
            raise ValueError(f"CudaGroup: distinct CUDA cards, not "
                             f"{list(self.devices)}")
        lib = _lib()
        idx = (ctypes.c_int * self.n)(*[d.index for d in self.devices])
        missing = ctypes.c_int()
        _raise(lib, "peer_enable", lib.peer_enable(self.n, idx,
                                                   ctypes.byref(missing)))
        if missing.value:
            raise RuntimeError(f"no peer access between every pair of "
                               f"{list(self.devices)}")
        self.state = []
        for d in self.devices:
            i64 = dict(dtype=torch.int64, device=d)
            self.state.append({
                "epoch": torch.zeros(1, **i64),
                "mail": torch.zeros(self.n, **i64),
                "err": torch.zeros(4, **i64),
                "wait": torch.zeros(1, **i64),
                "arrive": torch.zeros(1, dtype=torch.int32, device=d),
                "send": torch.zeros(SLOTS * self.capacity,
                                    dtype=torch.float64, device=d)})

    def rehearsal(self):
        return self.rehearse and not torch.cuda.is_current_stream_capturing()

    def collective(self, card, what, mode, outs, ins):
        """One collective on `card` (an index into devices), on its current
        stream: outs [(tensor, offset in the slot)], ins [(destination,
        [(source card, offset in its slot, strides or None)])] (FOLD: one
        destination, one source of card None)."""
        self._check_items(mode, outs, ins)
        site = self._site(card, what)
        p = _Params()
        st = self.state[card]
        p.epoch, p.mail = st["epoch"].data_ptr(), st["mail"].data_ptr()
        for c, s in enumerate(self.state):
            p.peer_mail[c] = s["mail"].data_ptr()
            p.send[c] = s["send"].data_ptr()
        p.err, p.timeout_ns = st["err"].data_ptr(), int(self.timeout_s * 1e9)
        p.arrive, p.wait_ns = st["arrive"].data_ptr(), st["wait"].data_ptr()
        p.cap, p.ncards, p.me, p.site, p.mode = (self.capacity, self.n, card,
                                                 site, mode)
        p.waits = waits_of(card, self.n, mode, ins)
        fill_items(p, outs, ins)
        most = max([t.numel() for t, _ in outs] + [sum(t.numel() for t, _
                                                       in ins)] + [1])
        blocks = max(1, min(MAX_BLOCKS, -(-most // (4 * THREADS))))
        dev = self.devices[card]
        lib = _lib()
        with torch.cuda.device(dev):
            err = lib.peer_collective_f64(
                ctypes.byref(p), blocks,
                _V(torch.cuda.current_stream(dev).cuda_stream))
        _raise(lib, "peer_collective_f64", err)

    def errors(self):
        """Each card's error word [code, site, epoch, peer] (a read)."""
        return [[int(v) for v in st["err"].tolist()] for st in self.state]

    def wait_seconds(self):
        """Each card's time in its collectives' waits so far (a read)."""
        return [1e-9 * int(st["wait"]) for st in self.state]

    def reset(self):
        """Every card synchronised, epochs, mailboxes, error words and wait
        counters zeroed: the group in step again."""
        for d in self.devices:
            torch.cuda.synchronize(d)
        for st in self.state:
            for key in ("epoch", "mail", "err", "arrive", "wait"):
                st[key].zero_()
        for d in self.devices:
            torch.cuda.synchronize(d)


class ThreadGroup(_Group):
    """The protocol on the CPU: card c is the Python thread that calls
    collective(c, ...); its slots are CPU tensors, its mailbox a list
    under one Condition. Arithmetic in the kernel's order with torch ops."""

    def __init__(self, n, capacity):
        super().__init__(["cpu"] * n, capacity)
        self.send = [torch.zeros(SLOTS * self.capacity, dtype=torch.float64)
                     for _ in range(self.n)]
        self.cond = threading.Condition()
        self.reset()

    def reset(self):
        with self.cond:
            self.epoch = [0] * self.n
            self.mail = [[0] * self.n for _ in range(self.n)]
            self.err = [[0] * 4 for _ in range(self.n)]
            self.waited = [0.0] * self.n

    def errors(self):
        with self.cond:
            return [list(w) for w in self.err]

    def wait_seconds(self):
        with self.cond:
            return list(self.waited)

    def _wait(self, card, cards, least, site, e):
        """Under the condition: until every card of `cards` has posted at
        least `least` to `card`, for at most the timeout; False (the error
        word set) where it timed out."""
        t0 = time.perf_counter()
        ok = self.cond.wait_for(
            lambda: all(self.mail[card][c] >= least for c in cards),
            timeout=self.timeout_s)
        self.waited[card] += time.perf_counter() - t0
        if not ok:
            late = next(c for c in cards if self.mail[card][c] < least)
            self.err[card] = [1, site, e, late]
        return ok

    def collective(self, card, what, mode, outs, ins):
        """As CudaGroup.collective, card being the calling thread's."""
        self._check_items(mode, outs, ins)
        with self.cond:
            site = self._site(card, what)
        e = self.epoch[card] + 1
        base = slot_of(e) * self.capacity
        buf = self.send[card]
        others = [c for c in range(self.n) if c != card]
        waits = waits_of(card, self.n, mode, ins)
        with self.cond:
            abort = self.err[card][0] != 0
            if not abort and e > SLOTS:
                abort = not self._wait(card, others, e - SLOTS + 1, site, e)
        if not abort:
            for t, off in outs:
                buf[base + off:base + off + t.numel()].copy_(t.reshape(-1))
        with self.cond:
            self.epoch[card] = e
            for c in others:
                self.mail[c][card] = e
            self.cond.notify_all()
            if not abort:
                abort = not self._wait(card, [c for c in others
                                              if (waits >> c) & 1], e, site, e)

        def src(c, off, strides, like):
            return self.send[c].as_strided(
                like.shape, source_strides(like, strides), base + off)
        if mode == FOLD:
            dst, [(_, off, strides)] = ins[0]
            if abort:
                dst.zero_()
            else:
                dst.copy_(fold([outs[0][0] if c == card else
                                src(c, off, strides, dst)
                                for c in range(self.n)]))
            return
        for dst, srcs in ins:
            if abort:
                if mode == COPY:
                    dst.zero_()
            elif mode == COPY:
                dst.copy_(src(*srcs[0], dst))
            else:
                terms = [dst.clone()] + [src(*s, dst) for s in srcs]
                while len(terms) > 1:
                    terms = [a + b for a, b in zip(terms[::2], terms[1::2])]
                dst.copy_(terms[0])


# --- the C interface ---------------------------------------------------------

_V = ctypes.c_void_p


class _View(ctypes.Structure):
    _fields_ = [("ptr", _V), ("n", ctypes.c_int), ("ndim", ctypes.c_int),
                ("size", ctypes.c_int * 4), ("stride", ctypes.c_int * 4)]


class _Src(ctypes.Structure):
    _fields_ = [("card", ctypes.c_int), ("off", ctypes.c_int),
                ("stride", ctypes.c_int * 4)]


class _Params(ctypes.Structure):
    _fields_ = [("epoch", _V), ("mail", _V),
                ("peer_mail", _V * MAX_CARDS), ("send", _V * MAX_CARDS),
                ("err", _V), ("arrive", _V), ("wait_ns", _V),
                ("cap", ctypes.c_longlong), ("timeout_ns", ctypes.c_longlong),
                ("ncards", ctypes.c_int), ("me", ctypes.c_int),
                ("site", ctypes.c_int), ("mode", ctypes.c_int),
                ("waits", ctypes.c_int),
                ("nout", ctypes.c_int), ("nin", ctypes.c_int),
                ("out", _View * MAX_OUT),
                ("out_off", ctypes.c_int * MAX_OUT),
                ("in_", _View * MAX_IN),
                ("in_src", ctypes.c_int * MAX_IN),
                ("in_nsrc", ctypes.c_int * MAX_IN),
                ("src", _Src * MAX_SOURCES)]


def view_dims(t):
    """(sizes, strides) in elements of a tensor view, its unit dims left
    out (a 0-d tensor or one value: one dim of 1); at most 4 dims."""
    dims = [(s, st) for s, st in zip(t.shape, t.stride()) if s != 1]
    if not dims:
        dims = [(1, 1)]
    if len(dims) > 4:
        raise ValueError(f"a peer view has at most 4 dims, not "
                         f"{tuple(t.shape)}")
    return [s for s, _ in dims], [st for _, st in dims]


def _fill(v, t):
    sizes, strides = view_dims(t)
    v.ptr, v.n, v.ndim = t.data_ptr(), t.numel(), len(sizes)
    for k, (s, st) in enumerate(zip(sizes, strides)):
        v.size[k], v.stride[k] = s, st


def fill_items(p, outs, ins):
    """A collective's views and sources into its _Params `p`: each view
    and each source's strides over the view's dims without its unit dims
    (view_dims), as the kernel indexes them."""
    p.nout, p.nin = len(outs), len(ins)
    for k, (t, off) in enumerate(outs):
        _fill(p.out[k], t)
        p.out_off[k] = off
    ns = 0
    for k, (t, srcs) in enumerate(ins):
        _fill(p.in_[k], t)
        p.in_src[k], p.in_nsrc[k] = ns, len(srcs)
        for c, off, strides in srcs:
            src = p.src[ns]
            src.card, src.off = -1 if c is None else c, off
            kept = [x for x, s in zip(source_strides(t, strides), t.shape)
                    if s != 1] or [1]
            for d, x in enumerate(kept):
                src.stride[d] = x
            ns += 1


_bound = False


def _lib():
    global _bound
    lib = _build.load()
    if not _bound:
        lib.peer_collective_f64.argtypes = [ctypes.POINTER(_Params),
                                            ctypes.c_int, _V]
        lib.peer_enable.argtypes = [ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_int)]
        lib.peer_params_size.argtypes = []
        lib.peer_slots.argtypes = []
        for f in (lib.peer_collective_f64, lib.peer_enable,
                  lib.peer_params_size, lib.peer_slots):
            f.restype = ctypes.c_int
        size = lib.peer_params_size()
        if size != ctypes.sizeof(_Params) or lib.peer_slots() != SLOTS:
            raise RuntimeError(
                f"peer_collective.cu's PeerParams is {size} bytes and "
                f"{lib.peer_slots()} slots, the wrapper's "
                f"{ctypes.sizeof(_Params)} and {SLOTS}")
        _bound = True
    return lib


def _raise(lib, name, err):
    if err != 0:
        raise RuntimeError(f"{name} failed: {_build.error_string(lib, err)}")


def peer_access(devices):
    """(True, "") where every pair of the distinct CUDA cards `devices` has
    peer access, else (False, why). Reads the cards' attributes only."""
    devices = [torch.device(d) for d in devices]
    for a in devices:
        for b in devices:
            if a != b and not torch.cuda.can_device_access_peer(a, b):
                return False, f"{a} has no peer access to {b}"
    return True, ""
