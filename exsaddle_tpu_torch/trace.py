"""The port's tracer: host spans and device marks on one clock, kept in
memory and read when the caller asks (Trace.collect).

A solver is traced when it is built with one (abf.ABFSolver(...,
trace=Trace(device))); with trace=None nothing here runs and the captured
graphs hold no mark.

- Host spans (host_open / host_close / host_next): name, start, end,
  parent span and solve id, on time.perf_counter_ns (CLOCK_MONOTONIC).
  ABFSolver records `solve_call` around each solve with its children
  `stage_in`, `launch`, `wait` and `read_out`, and its set-up stages
  under `build` (abf._stage).
- Device spans (`with span(trace, name)` at the work site, begin / end):
  each a pair of marks. On CUDA a mark is one launch of the trace_mark
  kernel (csrc/trace_mark.cu), which appends (word, %globaltimer) to a
  preallocated device buffer; captured into a graph it is one kernel node,
  so the marks time the work inside the device loop's conditional bodies.
  On the CPU, where the plain driver runs the same items from Python, a
  mark is the host clock read into a list. span() emits marks only while
  the trace is marking (graphs.ControlGraph's captures, graphs.run_plain),
  so a warm-up run records nothing.
- One clock: device times map onto the host's by an offset taken at the
  trace's start and again at collect() (calibrate: the host time around
  one mark and a synchronisation, the round with the least round trip;
  the error is half of it), interpolated between the two.

A full buffer drops marks and counts them; it never wraps, so the records
kept are the first ones, and collect() reports the drops."""

import contextlib
import ctypes
import time
from dataclasses import dataclass

import torch

from exsaddle_tpu_torch.kernels import _build

CAPACITY = 1 << 20      # records of 16 bytes: 16 MiB of device memory
CAL_ROUNDS = 16
TIMER_READS = 1 << 16

_V = ctypes.c_void_p
_ARGTYPES = {"trace_mark": [_V, _V, ctypes.c_longlong, ctypes.c_longlong,
                            ctypes.c_int, _V],
             "trace_now": [_V, _V],
             "trace_timer_step": [_V, ctypes.c_int, _V]}
_bound = False
_NULL = contextlib.nullcontext()


def _lib():
    global _bound
    lib = _build.load()
    if not _bound:
        for name, args in _ARGTYPES.items():
            f = getattr(lib, name)
            f.argtypes = args
            f.restype = ctypes.c_int
        _bound = True
    return lib


def _check(lib, name, err):
    if err != 0:
        raise RuntimeError(f"{name} failed: {_build.error_string(lib, err)}")


@dataclass
class Span:
    """One span: start and end in ns on the host clock (end None where
    dropped marks left it open), parent the index of the enclosing span in
    the same list (None at the top), solve the solve id (None in set-up).
    device: a span of the device's work (from marks); else a host span."""
    name: str
    start: int
    end: int | None
    parent: int | None
    solve: int | None
    device: bool


def span(trace, name):
    """`with span(trace, name):` the device span `name` around the block
    while `trace` is marking; a no-op where trace is None or not marking."""
    if trace is None or not trace._marking:
        return _NULL
    return trace.span(name)


class Trace:
    """Spans and marks of one traced solver, on `device`'s clock mapped to
    the host's. capacity: the device buffer's records (the CPU keeps as
    many)."""

    def __init__(self, device, capacity=CAPACITY):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.capacity = capacity
        self.names = []             # tag -> span name
        self._tags = {}
        self.host_spans = []
        self._open = []             # indices of the open host spans
        self.solve = 0              # solve_call's id (the last one opened)
        self.marks = 0              # marks emitted or captured so far
        self._marking = False
        self.timer_step = None
        self.calibrations = []
        if self.cuda:
            i64 = dict(dtype=torch.int64, device=self.device)
            self._buf = torch.zeros((capacity, 2), **i64)
            self._state = torch.zeros(3, **i64)   # cursor, drops, seq
            self._now = torch.zeros(3, **i64)
            self.timer_step = self._timer_step()
            self.calibrations.append(self.calibrate())
        else:
            self._records = []
            self._seq = self._drops = 0

    # --- host spans ----------------------------------------------------------
    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def host_open(self, name, sync=False, new_solve=False):
        """Open a host span under the innermost open one (the device
        synchronised first with sync); new_solve: it starts a new solve id,
        which its children carry. Returns its index."""
        if sync:
            self._sync()
        parent = self._open[-1] if self._open else None
        if new_solve:
            self.solve += 1
            solve = self.solve
        else:
            solve = None if parent is None else self.host_spans[parent].solve
        self.host_spans.append(Span(name, time.perf_counter_ns(), None,
                                    parent, solve, False))
        self._open.append(len(self.host_spans) - 1)
        return self._open[-1]

    def host_close(self, sync=False):
        """Close the innermost open host span; returns it."""
        if sync:
            self._sync()
        s = self.host_spans[self._open.pop()]
        s.end = time.perf_counter_ns()
        return s

    def host_next(self, name):
        """Close the innermost open host span and open `name` beside it."""
        self.host_close()
        return self.host_open(name)

    # --- device marks --------------------------------------------------------
    def _tag(self, name):
        t = self._tags.get(name)
        if t is None:
            t = self._tags[name] = len(self.names)
            self.names.append(name)
        return t

    def mark(self, name, end, entry=False):
        """One mark: the begin (end False) or end of span `name`; entry
        counts a new solve first. On CUDA a trace_mark launch on the
        current stream (a kernel node under capture), on the CPU the host
        clock."""
        code = 2 * self._tag(name) + int(end)
        self.marks += 1
        if not self.cuda:
            self._seq += int(entry)
            if len(self._records) < self.capacity:
                self._records.append(((self._seq << 32) | code,
                                      time.perf_counter_ns()))
            else:
                self._drops += 1
            return
        lib = _lib()
        _check(lib, "trace_mark", lib.trace_mark(
            _V(self._buf.data_ptr()), _V(self._state.data_ptr()),
            self.capacity, code, int(entry), _V(self._stream())))

    @contextlib.contextmanager
    def span(self, name, entry=False):
        """The device span `name` around the block (see span())."""
        self.mark(name, False, entry)
        yield
        self.mark(name, True)

    @contextlib.contextmanager
    def marking(self):
        """span() emits marks inside the block."""
        was, self._marking = self._marking, True
        try:
            yield
        finally:
            self._marking = was

    # --- the clock -----------------------------------------------------------
    def _stream(self):
        return torch.cuda.current_stream(self.device).cuda_stream

    def calibrate(self):
        """{"offset_ns", "error_ns", "at_ns"}: device time minus host time,
        from the round of CAL_ROUNDS (host time, one mark, synchronise,
        host time) with the least round trip: offset = the mark minus the
        round's midpoint, error = half the round trip; at_ns the mark."""
        lib = _lib()
        stream = torch.cuda.current_stream(self.device)
        stream.synchronize()
        best = None
        with torch.cuda.device(self.device):
            for _ in range(CAL_ROUNDS):
                t0 = time.perf_counter_ns()
                _check(lib, "trace_now", lib.trace_now(
                    _V(self._now.data_ptr()), _V(stream.cuda_stream)))
                stream.synchronize()
                t1 = time.perf_counter_ns()
                g = int(self._now[0])
                if best is None or t1 - t0 < best[0]:
                    best = (t1 - t0, g - (t0 + t1) // 2, g)
        return {"offset_ns": best[1], "error_ns": best[0] / 2,
                "at_ns": best[2]}

    def _timer_step(self):
        lib = _lib()
        with torch.cuda.device(self.device):
            _check(lib, "trace_timer_step", lib.trace_timer_step(
                _V(self._now.data_ptr()), TIMER_READS, _V(self._stream())))
        least, changes, span_ns = self._now.tolist()
        return {"least_ns": least,
                "mean_ns": span_ns / changes if changes else None}

    # --- read-out ------------------------------------------------------------
    def collect(self):
        """Everything recorded so far: {"spans": the host spans, then the
        device spans paired from the marks (parents by index into this
        list; a device span's solve is the device's count of solves, which
        is solve_call's id where every solve went through the traced
        ABFSolver), "marks": the records read, "drops", "calibration":
        [the start's, now's] (CUDA), "timer_step": %globaltimer's step
        (CUDA)}."""
        if self.cuda:
            torch.cuda.synchronize(self.device)
            cursor, drops, _ = self._state.tolist()
            records = self._buf[:min(cursor, self.capacity)].tolist()
            cals = [self.calibrations[0], self.calibrate()]
            to_host = _mapping(*cals)
        else:
            records, drops, cals = list(self._records), self._drops, []
            to_host = int
        spans = [Span(**vars(s)) for s in self.host_spans]
        stack = []
        for word, t in records:
            seq, code = word >> 32, word & 0xFFFFFFFF
            name = self.names[code >> 1]
            if code & 1:
                s = spans[stack.pop()] if stack else None
                if s is None or s.name != name:
                    raise RuntimeError(f"Trace: end of {name!r} does not "
                                       f"close the open span")
                s.end = to_host(t)
            else:
                spans.append(Span(name, to_host(t), None,
                                  stack[-1] if stack else None, seq, True))
                stack.append(len(spans) - 1)
        return {"spans": spans, "marks": len(records), "drops": drops,
                "calibration": cals, "timer_step": self.timer_step}


def _mapping(c0, c1):
    """Device ns -> host ns, the offset interpolated between calibrations
    c0 and c1 by device time."""
    g0, g1 = c0["at_ns"], c1["at_ns"]
    o0, o1 = c0["offset_ns"], c1["offset_ns"]
    if g1 == g0:
        return lambda t: int(t) - o0
    return lambda t: int(t) - round(o0 + (o1 - o0) * (int(t) - g0) / (g1 - g0))
