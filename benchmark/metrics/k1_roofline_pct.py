"""k1_roofline_pct: K1, the fine-level A00 apply (kernels.a00.a00_apply),
at the cell's fine-level operator and working precision, as a share of
its roofline bound. Timed by CUDA events over a replayed graph of
back-to-back applies whose x cycles through copies that move more than 3x
the card's L2 (the operator's scale and Bs shared, as consecutive applies
in a solve share them); the bound is the larger of yardstick.k1_count's
operations at the peak rate and its bytes at the HBM rate. Moves
solve_s."""

from benchmark import yardstick


def read(run):
    import torch
    if run.device.type != "cuda":
        return None
    from exsaddle_tpu_torch.kernels import a00
    op = run.solver.data["op"]
    nel, nrow = op.scale_visc.shape
    item = op.scale_visc.element_size()
    ops, nbytes = yardstick.k1_count(nel, nrow, op.Bs.shape[1], op.nu,
                                     item)
    gen = torch.Generator(device=run.device)
    gen.manual_seed(abs(run.seed))
    x = torch.randn(op.nu, generator=gen, dtype=op.scale_visc.dtype,
                    device=run.device)
    copies = yardstick.cold_copies((x,), 2 * op.nu * item)
    fns = [lambda c=c: a00.a00_apply(op, c[0]) for c in copies]
    fns = fns * -(-48 // len(fns))
    t = yardstick.graph_seconds(fns)
    share, bound, by = yardstick.roofline(
        ops, nbytes, str(op.scale_visc.dtype)[6:], t)
    run.log(f"k1_roofline_pct {share:.3f}: {1e6 * t:.3f} us per apply "
            f"({len(copies)} copies of x cycled), bound {1e6 * bound:.3f} "
            f"us by {by} ({ops} operations, {nbytes} bytes), card "
            f"{yardstick.card()}")
    return share
