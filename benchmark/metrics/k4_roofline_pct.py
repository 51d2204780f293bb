"""k4_roofline_pct: K4, the block stencil (kernels.stencil.stencil_apply),
on the cell's own L-2 stencil in its working precision, as a share of its
roofline bound, cold: W and x cycle through copies that move more than 3x
the card's L2 (hot, W stays in the L2 and the bytes bound would be beaten).
Timed by CUDA events over a replayed graph of back-to-back applies; the
bound is the larger of yardstick.k4_count's operations at the peak rate
and its bytes at the HBM rate. Moves solve_s."""

from benchmark import yardstick


def read(run):
    import torch
    if run.device.type != "cuda" or not run.solver.data.get("stencils"):
        return None
    from exsaddle_tpu_torch.kernels import stencil
    W = run.solver.data["stencils"][-1]
    nd = W.shape[-1]
    gen = torch.Generator(device=run.device)
    gen.manual_seed(abs(run.seed))
    x = torch.randn(tuple(W.shape[:-3]) + (nd,), generator=gen,
                    dtype=W.dtype, device=run.device)
    ops, nbytes = yardstick.k4_count(W.numel(), x.numel(), W.element_size())
    copies = yardstick.cold_copies((W, x), nbytes)
    fns = [lambda c=c: stencil.stencil_apply(c[0], c[1]) for c in copies]
    fns = fns * -(-48 // len(fns))
    t = yardstick.graph_seconds(fns)
    share, bound, by = yardstick.roofline(ops, nbytes,
                                          str(W.dtype)[6:], t)
    run.log(f"k4_roofline_pct {share:.3f}: {1e6 * t:.3f} us per apply on "
            f"L-2 {tuple(W.shape)} ({len(copies)} copies of W and x "
            f"cycled), bound {1e6 * bound:.3f} us by {by} ({ops} "
            f"operations, {nbytes} bytes), card {yardstick.card()}")
    return share
