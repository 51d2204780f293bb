"""The benchmark's yardstick: the card's data-sheet peaks, the operation and
byte counts of the kernels whose roofline share it reports, the statistics
of its metrics, and the device timing of a kernel.

Kept here so that a change to the program cannot change how it is
measured. Nothing here imports the program.
"""

import gc
import statistics

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W limit: FP32 on
# the CUDA cores and FP64 on the tensor cores (67 TFLOP/s each), HBM3
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
PEAK_BYTES_PER_S = 3.35e12
# the card's L2: a cold timing cycles its inputs through copies that move
# more than three times this between two uses of one copy
L2_BYTES = 50e6


def p90(values):
    """The 90th percentile, interpolated between order statistics
    (statistics.quantiles, inclusive method)."""
    if len(values) < 2:
        return float(values[0])
    return float(statistics.quantiles(values, n=10, method="inclusive")[8])


def k1_count(nel, nrow, ncol, nu, itemsize):
    """(operations, bytes) of one fine-level A00 element apply
    y = sum_e G_e^T Bs^T diag(s_e) Bs G_e x on nel elements, Bs (nrow,
    ncol), nu velocity dofs: the two element products (2 nel nrow ncol
    multiply-adds each) and the scaling (nel nrow multiplies); x, s, Bs
    read once and y written once (the node tables and any intermediate
    not counted). The A00 terms of bench._apply_flops_bytes."""
    ops = 2 * 2 * nel * nrow * ncol + nel * nrow
    nbytes = itemsize * (2 * nu + nel * nrow + nrow * ncol)
    return ops, nbytes


def k4_count(w_numel, x_numel, itemsize):
    """(operations, bytes) of one block stencil apply y = W x: a
    multiply-add per coefficient of W; W and x read once, y (x's size)
    written once."""
    return 2 * w_numel, itemsize * (w_numel + 2 * x_numel)


def roofline(ops, nbytes, dtype_name, seconds):
    """(share of the bound in %, bound seconds, what binds): the bound is
    the larger of operations at the peak rate and bytes at the HBM rate."""
    t_ops = ops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    bound = max(t_ops, t_bytes)
    return (100.0 * bound / seconds, bound,
            "operations" if t_ops >= t_bytes else "bytes")


def cold_copies(tensors, nbytes):
    """Copies of `tensors`, at least 2, so many that cycling through them
    moves more than 3x the L2 between two uses of one copy (nbytes: what
    one call moves)."""
    n = max(2, -(-int(3 * L2_BYTES) // int(nbytes)) + 1)
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def graph_seconds(fns, reps=5):
    """Device seconds per call of the calls in fns, captured back to back
    as one CUDA graph and replayed between two CUDA events; the median of
    `reps` replays after one warm-up replay."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    # a collection inside the capture would free memory the graph holds
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(g):
            for fn in fns:
                fn()
    finally:
        if enabled:
            gc.enable()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        g.replay()
        e1.record()
        e1.synchronize()
        times.append(1e-3 * e0.elapsed_time(e1) / len(fns))
    del g
    return float(np.median(times))


def card():
    """(name, power limit in W) of card 0, as nvidia-smi reads them; None
    where it cannot."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    name, power = out.strip().splitlines()[0].rsplit(",", 1)
    return name.strip(), power.strip()
