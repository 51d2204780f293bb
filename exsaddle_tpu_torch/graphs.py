"""Device bodies captured once as CUDA graphs and replayed: the port's
counterpart of jax.jit for a fixed-work body (exsaddle_tpu/abf.py:1227-1229
jits the whole solve once per solver).

A fixed-work body is a function of tensors that reads nothing back to the
host and takes no branch on a device value: the V-cycle, the p-block's
Chebyshev polynomial, the fieldsplit PC with fixed V-cycles (abf.py
`make_abf_solver`). `Captured` records such a body once and replays it, so
the host makes one graph launch where it launched every kernel of the body.
The loops that read a residual (GCR, FGMRES, the refinement rounds) stay on
the host and call the captured bodies.

There is no CPU mode: the CPU runs the bodies eagerly, and `Captured`
refuses CPU tensors."""

import torch

from exsaddle_tpu_torch.kernels import a00


def _check_inputs(inputs, what):
    for x in inputs:
        if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
            where = x.device if isinstance(x, torch.Tensor) else type(x)
            raise ValueError(f"{what}: CUDA tensors only, got {where}")
    if len({x.device for x in inputs}) > 1:
        raise ValueError(f"{what}: inputs on more than one device")


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
    replay adds to a00.LAUNCHES the K1 launches and applies that the capture
    recorded, since the graph launches them again; the capture itself
    launches nothing and is not counted. `replays` counts the calls. A
    capture or replay error raises; nothing falls back to eager launches."""

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
            n0, a0 = a00.LAUNCHES.n, a00.LAUNCHES.applies
            mode = torch.cuda.get_sync_debug_mode()
            try:
                # inside the block: entering and leaving it synchronise
                with torch.cuda.graph(self.graph):
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        out = fn(*self._static)
                    finally:
                        torch.cuda.set_sync_debug_mode(mode)
            finally:
                self.k1_launches = a00.LAUNCHES.n - n0
                self.k1_applies = a00.LAUNCHES.applies - a0
                a00.LAUNCHES.n, a00.LAUNCHES.applies = n0, a0
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
        a00.LAUNCHES.n += self.k1_launches
        a00.LAUNCHES.applies += self.k1_applies
        return self._out.clone()


def replays(bodies):
    """Replays so far of the Captured among `bodies` ({name: callable})."""
    return sum(b.replays for b in bodies.values() if isinstance(b, Captured))
