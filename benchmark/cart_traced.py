"""The cards' traced pass: the program's spans and counters of the sharded
solve with one shard on each card, read by metrics/cart_psum_ms.py,
cart_halo_ms.py and peer_roofline_pct.py.

After the window, a traced twin of the run's sharded solver over the same
placed data (CartABFSolver.with_loop("device", trace=...), one
exsaddle_tpu_torch.trace.Trace per card) captures its own graphs, solves
one warm-up load, then the run's first N_SOLVES loads; each card's trace
is collected and the twin freed. Per solve and card: the device time in
the card's `psum` spans (every cross-card reduction, its wait included)
and `halo` spans (every cross-card halo or ghost exchange, its wait
included), and the bytes the card had to read from its peers
(benchmark/peer_count.py: the configuration's shapes times what the solve
asked its mesh to exchange, the solve's "collectives" counts). Each metric
is the mean over the cards of its mean per solve. The log adds each
card's time in the collectives' waits, where the program counts it.

None on the CPU, where the program's sharded solver takes no trace, where
it has no cross-card collective (every shard on one card), and where a
mark was dropped."""

from benchmark import peer_count

N_SOLVES = 8


def reading(run, name):
    """The pass's value `name` for `run` (made once per run and kept on
    it), or None."""
    out = getattr(run, "cart_traced", False)
    if out is False:
        out = run.cart_traced = (measure(run) if run.device.type == "cuda"
                                 else None)
    return None if out is None else out.get(name)


def measure(run, n=N_SOLVES):
    from benchmark import harness
    slv = run.solver
    smesh = getattr(slv, "smesh", None)
    if smesh is None:
        return None
    try:
        from exsaddle_tpu_torch.trace import Trace
        traces = [Trace(d) for d in smesh.distinct]
        tslv = slv.with_loop("device", trace=traces)
    except (ImportError, TypeError, ValueError) as e:
        run.log(f"cards' traced pass: the program's sharded solver takes no "
                f"trace here ({type(e).__name__}: {e}): nothing read")
        return None
    tslv.solve(run.loads[0])                              # warm-up
    group = getattr(tslv._dev, "group", None)
    waits = getattr(group, "wait_seconds", None)
    w0 = waits() if waits else None
    results = [tslv.solve(F) for F in run.loads[:n]]
    if waits:
        run.log("cards' traced pass: waits per solve by card " + ", ".join(
            f"{1e3 * (b - a) / n:.4f} ms" for a, b in zip(w0, waits())))
    cols = [tr.collect() for tr in traces]
    m_el = tuple(int(run.config["flags"][k]) for k in ("mx", "my", "mz"))
    grid = tuple(slv.part.dev_shape)
    del tslv
    harness.free(run.device)
    return summarise(cols, results, len(traces), run.log, m_el, grid)


def summarise(cols, results, cards, log, m_el, grid):
    """The readings of the cards' collected traces (Trace.collect, one per
    card) over the solves after the warm-up (device solve ids 2 .. 1 +
    len(results)) and the solves' result dicts, for the element grid m_el
    cut into the grid of cards `grid`."""
    n = len(results)
    ids = set(range(2, 2 + n))
    if any(c["drops"] for c in cols):
        log("cards' traced pass: marks dropped: nothing read")
        return None
    psum, halo = [], []
    for col in cols:
        spans = [s for s in col["spans"] if s.device and s.solve in ids
                 and s.end is not None]
        psum.append(sum(s.end - s.start for s in spans
                        if s.name == "psum") / n)
        halo.append(sum(s.end - s.start for s in spans
                        if s.name == "halo") / n)
    out = {"solves": n}
    if not any(psum) and not any(halo):
        log("cards' traced pass: no psum or halo span (no cross-card "
            "collective): nothing read")
        return None
    out["cart_psum_ms"] = 1e-6 * sum(psum) / cards
    out["cart_halo_ms"] = 1e-6 * sum(halo) / cards
    col = [r.get("collectives") for r in results]
    keys = ("halo_u", "halo_p", "halo_r", "ghosts", "l2_gathers",
            "psum_values")
    if all(c is not None and all(k in c for k in keys) for c in col):
        per_card = []
        for k, box in enumerate(peer_count.boxes(grid)):
            nbytes = sum(peer_count.bytes_per_card(
                m_el, grid, box, {key: c[key][k] for key in keys})
                for c in col) / n
            secs = 1e-9 * (psum[k] + halo[k])
            per_card.append(peer_count.share(nbytes, secs))
            log(f"cards' traced pass, card {k}: psum {1e-6 * psum[k]:.4f} "
                f"ms, halo {1e-6 * halo[k]:.4f} ms per solve; "
                f"{nbytes:.0f} B to read from its peers per solve, "
                f"{per_card[-1]:.4f}% of {peer_count.NVLINK_BYTES_PER_S:.3g}"
                f" B/s")
        out["peer_roofline_pct"] = sum(per_card) / cards
        c0 = col[0]
        log(f"cards' traced pass, {n} solves: per solve and card "
            f"{c0['psums'][0]} psums, {c0['halo_exchanges'][0]} halo and "
            f"ghost exchanges, asked for " + ", ".join(
                f"{c0[key][0]} {key}" for key in keys)
            + f"; {c0['graph_launches']} graph launches a solve")
    return out
