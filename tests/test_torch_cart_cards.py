"""The sharded solve with one shard on each card (parallel/cart_abf.py
CartCardsSolver over shard_mesh.CardMesh views, the collectives of
kernels/peer.py).

On the CPU, where kernels/peer.ThreadGroup runs the peer protocol with one
thread per card:
- its bookkeeping: the fold order of a psum, the slot offsets of the
  moves, the order of the halo adds per destination, each card's epochs
  and the slot each epoch packs into; its collectives bitwise the one-card
  mesh's (ShardMesh psum, all_parts, halo_add_axes, ghost_extend_axis, and
  ghost_extend's every axis at once against the axis-by-axis sequence);
- a halo waits only for the cards it reads from, and a card runs at most
  SLOTS - 1 collectives ahead of the slowest;
- a wait that cannot complete raises, naming card and collective, within
  its timeout;
- the cards' solve bitwise the same shards' plain device loop on one
  device (x, its, rnorm, history, counts);
- the host loop's window masks, now formed on each part's device, give the
  bits the single expression gave;
- the sharded solve of the benchmark's flagship at mx=8 over 4 CPU shards
  meets the plain reference's float64 residual (benchmark/reference) on
  loads of the benchmark's generator.

On the card (marked gpu; skip below 2 or 4 cards): the device loop across
2 and 4 cards bitwise the same shards' device loop on one card at mx=8,
and a peer wait that cannot complete (one card's graph launched alone)
raising within its timeout. This file imports nothing of JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cart_cards.py
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from exsaddle_tpu_torch import driver as tdriver
from exsaddle_tpu_torch import models as tmodels
from exsaddle_tpu_torch import treeops
from exsaddle_tpu_torch.assembly import FESpace, assemble_rhs, scatter_vector
from exsaddle_tpu_torch.kernels import peer
from exsaddle_tpu_torch.mesh import SaddleMesh
from exsaddle_tpu_torch.options import Options
from exsaddle_tpu_torch.parallel import cart_abf, shard_mesh
from exsaddle_tpu_torch.parallel.cart import CartPartition
from exsaddle_tpu_torch.parallel.shard_mesh import CardMesh, ShardMesh
from exsaddle_tpu_torch.treeops import ShardVec

CPU = torch.device("cpu")


@pytest.fixture
def one_thread():
    """The CPU shards' many small ops run fastest on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _solver(devices, model="2", mx=4, dev_shape=(1, 2, 2), **kw):
    """The cartesian ABF solver of a mx^3 problem over `devices` and its
    right-hand side (Dirichlet values in, rhs_diri added)."""
    size = (0.1, 1.0, 1.0) if model == "11" else (1.0, 1.0, 1.0)
    opts = Options.from_args(["-model", model, "-size_x", str(size[0])])
    ctx = tmodels.ModelContext(opts, 3, log=lambda *a, **k: None)
    mesh = SaddleMesh(3, (mx, mx, mx), size)
    fes = FESpace(mesh)
    bci, bcv = tmodels.create_bc_list(ctx, mesh)
    slv = cart_abf.CartABFSolver(CartPartition(mesh, dev_shape), ctx, bci,
                                 bcv, devices, nlevels=3, **kw)
    coeff = tdriver.fine_coefficients(ctx, fes)
    f1, f2 = assemble_rhs(fes, coeff["Fu"], coeff["Fp"])
    F = scatter_vector(mesh, f1, f2)
    F[:mesh.nu][bci] = bcv
    return slv, F + slv.setup["rhs_diri"]


def _on_cards(n, fn):
    """fn(card) for every card of a group, each in its own thread (the
    cards run concurrently); the results in card order."""
    out, errs = [None] * n, []

    def run(c):
        try:
            out[c] = fn(c)
        except BaseException as e:           # raised after the join
            errs.append(e)
    threads = [threading.Thread(target=run, args=(c,)) for c in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    if errs:
        raise errs[0]
    return out


# --- the bookkeeping -------------------------------------------------------

def test_fold_is_the_meshs_psum_in_shard_order():
    """peer.fold sums in global shard order, as ShardMesh.psum: values
    chosen so that another order rounds to other bits."""
    vals = [torch.tensor([1.0, 1e16]), torch.tensor([1e16, -1e16]),
            torch.tensor([-1e16, 1.0]), torch.tensor([1.0, 3.0])]
    smesh = ShardMesh((1, 2, 2), [CPU] * 4)
    want = smesh.psum(ShardVec(vals)).parts[0]
    assert torch.equal(peer.fold(vals), want)
    assert torch.equal(want, torch.tensor([1.0, 4.0]))
    assert not torch.equal(peer.fold(vals[::-1]), want)


def test_plan_packs_each_senders_moves_in_order():
    """Each sender's values sit one after another in the order of the
    moves, whoever else sends in between."""
    assert peer.plan([(0, 5), (1, 3), (0, 2), (2, 7), (1, 4), (0, 1)]) == \
        [0, 0, 5, 0, 3, 7]
    assert peer.SLOTS == 4
    assert [peer.slot_of(e) for e in range(1, 6)] == [1, 2, 3, 0, 1]
    # a psum waits for every peer, a halo for the cards it reads from
    assert peer.waits_of(2, 4, peer.FOLD, [(None, None, 0)]) == 0b1011
    assert peer.waits_of(2, 4, peer.ADD, [(None, 0, 0), (None, 0, 9),
                                          (None, 3, 0)]) == 0b1001


def _grids(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape) for _ in range(4)]


def test_thread_group_collectives_equal_the_one_device_mesh():
    """Over a 1 x 2 x 2 grid, each card's view through a ThreadGroup gives
    ShardMesh's bits for psum, the L-2 gather (all_parts), halo_add_axes of
    two grids on both decomposed axes and ghost_extend_axis; an axis of
    one shard moves nothing, so every card runs 5 collectives and ends at
    epoch 5, its last values (the gathered part) in slot 1."""
    smesh = ShardMesh((1, 2, 2), [CPU] * 4)
    a, b = _grids(1, (3, 4, 5, 3)), _grids(2, (3, 4, 5, 3))
    parts = _grids(3, (7,))
    # the one-device mesh's results
    ga, gb = smesh.shard(a), smesh.shard(b)
    for d in (1, 2):
        shard_mesh.halo_add_axes(smesh, [ga, gb], d)
    ghost = shard_mesh.ghost_extend_axis(smesh, smesh.shard(a), 1)
    psum = smesh.psum(smesh.shard(parts)).parts[0]
    gathered = smesh.all_parts(smesh.shard(a))
    group = peer.ThreadGroup(4, 1000)

    def card(c):
        cm = CardMesh(smesh, c, group)
        ca, cb = cm.shard(a), cm.shard(b)
        for d in (0, 1, 2):
            shard_mesh.halo_add_axes(cm, [ca, cb], d)
        gh = shard_mesh.ghost_extend_axis(cm, cm.shard(a), 0)
        gh = shard_mesh.ghost_extend_axis(cm, cm.shard(a), 1)
        ps = cm.psum(cm.shard(parts)).parts[0]
        ga_ = cm.all_parts(cm.shard(a))
        return ca.parts[0], cb.parts[0], gh.parts[0], ps, ga_
    got = _on_cards(4, card)
    for c, (ca, cb, gh, ps, gath) in enumerate(got):
        assert torch.equal(ca, ga.parts[c]) and torch.equal(cb, gb.parts[c])
        assert torch.equal(gh, ghost.parts[c])
        assert torch.equal(ps, psum)
        assert all(torch.equal(x, y) for x, y in zip(gath, gathered))
    # axis 0 has one shard (no collective) and ghost_extend_axis along it
    # moves nothing: 2 halos + 1 ghost + psum + gather = 5 collectives
    assert group.epoch == [5] * 4
    assert group.mail == [[0 if c == d else 5 for d in range(4)]
                          for c in range(4)]
    assert len(group.sites) == 20
    # the gather, each card's fifth collective, packed into slot 1: the
    # card's own part at the slot's start
    for c in range(4):
        n = a[c].size
        assert np.array_equal(group.send[c][1000:1000 + n].numpy(),
                              a[c].reshape(-1))


def test_halo_adds_in_the_order_of_the_moves():
    """The moves into one plane are added in the order halo_add_axes lists
    them: a shard with neighbours on both sides of an axis (a 1 x 1 x 4
    grid) takes its lower neighbour's plane into its bottom and its upper
    one's into its top, each added once, as on one device."""
    smesh = ShardMesh((1, 1, 4), [CPU] * 4)
    a = _grids(4, (6, 3, 2))
    want = smesh.shard(a)
    shard_mesh.halo_add_axes(smesh, [want], 2)
    group = peer.ThreadGroup(4, 100)
    got = _on_cards(4, lambda c: shard_mesh.halo_add_axes(
        CardMesh(smesh, c, group), [CardMesh(smesh, c, group).shard(a)],
        2)[0].parts[0])
    assert all(torch.equal(g, w) for g, w in zip(got, want.parts))
    # shard 1 receives from 0 (into its bottom plane) and from 2 (its top)
    cm = CardMesh(smesh, 1, group)
    mine = ShardVec([want.parts[1]])
    moves = []
    for lo, hi in smesh.pairs(2):
        moves += [(mine, lo, hi, lambda t: t.select(0, -1)),
                  (mine, hi, lo, lambda t: t.select(0, 0))]
    outs, into, _ = cm._moves(moves)
    assert [(m[1], m[2]) for _, m, _ in into] == [(0, 1), (2, 1)]
    assert len(outs) == 2


def test_ghost_extend_in_one_exchange_equals_axis_by_axis():
    """Over 1 x 2 x 2 and 2 x 2 x 2 grids, each card's view extends its
    grid along every axis in one exchange (its face neighbours' planes,
    its edge and corner neighbours' lines and nodes): bitwise the one-card
    mesh's axis-by-axis ghost_extend_axis, zeros at the domain's edges;
    one collective per card."""
    for shape in ((1, 2, 2), (2, 2, 2)):
        n = int(np.prod(shape))
        smesh = ShardMesh(shape, [CPU] * n)
        a = [np.random.default_rng(20 + i).standard_normal((4, 5, 6, 3))
             for i in range(n)]
        want = shard_mesh.ghost_extend(smesh, smesh.shard(a))
        seq = smesh.shard(a)
        for d in (2, 1, 0):
            seq = shard_mesh.ghost_extend_axis(smesh, seq, d)
        assert all(torch.equal(x, y) for x, y in zip(want.parts, seq.parts))
        group = peer.ThreadGroup(n, 1000)
        got = _on_cards(n, lambda c: shard_mesh.ghost_extend(
            CardMesh(smesh, c, group),
            CardMesh(smesh, c, group).shard(a)).parts[0])
        assert all(torch.equal(g, w) for g, w in zip(got, want.parts))
        assert group.epoch == [1] * n
        assert all(g.shape == (6, 7, 8, 3) for g in got)


def test_halos_wait_only_for_their_neighbours(monkeypatch):
    """Over a 1 x 2 x 2 grid, cards 0 and 1 exchange halos along axis 1
    (their own pair) while cards 2 and 3 do nothing: the first SLOTS
    exchanges need no other card and give the one-card bits; the next
    would reuse a slot cards 2 and 3 have not posted past, so it waits
    for them, times out and names one of them."""
    monkeypatch.setattr(peer, "TIMEOUT_S", 0.3)
    smesh = ShardMesh((1, 2, 2), [CPU] * 4)
    a = _grids(5, (3, 4, 5, 3))
    want = smesh.shard(a)
    group = peer.ThreadGroup(4, 1000)
    assert group.timeout_s == 0.3
    views = [CardMesh(smesh, c, group) for c in range(2)]
    grids = [v.shard(a) for v in views]

    def halos(c, k):
        for _ in range(k):
            shard_mesh.halo_add_axes(views[c], [grids[c]], 1)
    for _ in range(peer.SLOTS):
        shard_mesh.halo_add_axes(smesh, [want], 1)
    t0 = time.perf_counter()
    _on_cards(2, lambda c: halos(c, peer.SLOTS))
    assert time.perf_counter() - t0 < 0.25
    assert group.epoch == [peer.SLOTS] * 2 + [0, 0]
    assert all(torch.equal(grids[c].parts[0], want.parts[c])
               for c in range(2))
    assert group.errors() == [[0] * 4] * 4
    halos(0, 1)
    code, site, epoch, late = group.errors()[0]
    assert (code, epoch) == (1, peer.SLOTS + 1) and late in (2, 3)
    assert group.wait_seconds()[0] >= 0.3
    with pytest.raises(RuntimeError, match=r"halo axis 1 .* waiting for"):
        group.check()


def test_a_wait_that_cannot_complete_raises(monkeypatch):
    """One card alone: its first collective waits out the timeout, then
    that card's collectives give zeros and skip their waits; check()
    names the card and the collective, and resets the group."""
    monkeypatch.setattr(peer, "TIMEOUT_S", 0.2)
    smesh = ShardMesh((1, 2, 2), [CPU] * 4)
    group = peer.ThreadGroup(4, 10)
    cm = CardMesh(smesh, 2, group)
    t0 = time.perf_counter()
    one = torch.ones(3, dtype=torch.float64)
    s1 = cm.psum(ShardVec([one])).parts[0]
    s2 = cm.psum(ShardVec([one])).parts[0]
    assert time.perf_counter() - t0 < 2.0
    assert torch.equal(s1, 0 * one) and torch.equal(s2, s1)
    assert group.errors()[2][:3] == [1, 0, 1]
    with pytest.raises(RuntimeError, match=r"cpu in psum of 3 \(site 0, "
                       r"card 2\) at epoch 1, waiting for cpu"):
        group.check()
    assert group.errors() == [[0] * 4] * 4 and group.epoch == [0] * 4


def test_cards_solve_equals_the_one_device_plain_loop(one_thread):
    """The sinker at mx=4 over 1 x 2 x 2 shards: each shard on its own
    card (CPU threads of a ThreadGroup, each card's plain driver) against
    the same shards' plain device loop on one device: x, its, rnorm,
    state, history and counts bit for bit; every card ends at the same
    epoch."""
    slv, F = _solver([CPU] * 4)
    plain = slv.with_loop("plain")
    Fp = plain._saddle_parts(F)
    x0p = [np.zeros_like(f) for f in Fp]
    ref = plain._dev.solve(Fp, x0p)
    ops = slv.blocks.ops.parts[0]
    group = peer.ThreadGroup(4, ops.nu + ops.np_)
    cards = cart_abf.CartCardsSolver(slv.dcfg, slv.smesh, slv.ddata,
                                     slv.blocks, group, graph=False)
    got = cards.solve(Fp, x0p)
    assert all(np.array_equal(a, b) for a, b in zip(got[0], ref[0]))
    assert got[1:4] == ref[1:4]
    assert np.array_equal(got[4], ref[4]) and np.array_equal(got[5], ref[5])
    assert ref[3] == treeops.CONVERGED_RTOL
    assert len(set(group.epoch)) == 1 and group.epoch[0] > 0
    # a card's input as the cards' graphs are given it: its F, then its x0,
    # staged into one host buffer (pinned on CUDA)
    v = cards.views[2]
    v._pinned = (torch.empty(v.inp.shape, dtype=torch.float64),
                 torch.empty(v.out.shape, dtype=torch.float64))
    v._stage(Fp[2], x0p[2] + 1.0)
    assert np.array_equal(v._pinned[0].numpy(),
                          np.concatenate([Fp[2], x0p[2] + 1.0]))


def test_host_loop_masks_keep_their_bits(one_thread, monkeypatch):
    """The host loop (make_cart_abf_solver, window arithmetic) with each
    window mask formed on its part's device against the single expression
    it replaced (bdots(...) * mask.to(dtype), right where every part shares
    the mask's device): the same its, history and x, bit for bit."""
    slv, F = _solver([CPU] * 4)
    new = slv.solve(F)
    monkeypatch.setattr(treeops, "_masked",
                        lambda h, mask: h * mask.to(h.dtype))
    old = slv.with_loop("host").solve(F)
    assert new["loop"] == old["loop"] == "host"
    assert (new["its"], new["history"]) == (old["its"], old["history"])
    assert np.array_equal(new["x"], old["x"])


def test_host_vectors_shard_and_gather_by_index():
    """CartABFSolver's host conversions through its precomputed indices:
    a vector's shard parts are the box-by-box slices of the natural
    ordering, and parts whose shared planes differ between boxes gather
    as the box-by-box assembly did, a later box's values winning."""
    slv, F = _solver([CPU] * 4)
    parts = slv._saddle_parts(F)
    assert all(np.array_equal(a, b) for a, b in
               zip(parts, slv._box_slices(F)))
    assert np.array_equal(slv._unshard_parts(parts), F)
    rng = np.random.default_rng(11)
    parts = [rng.standard_normal(p.size) for p in parts]
    mesh, part, nd = slv.mesh, slv.part, slv.mesh.ndim
    g = np.zeros(tuple(reversed(mesh.nn_u)) + (nd,))
    gp = np.zeros(tuple(reversed(mesh.nn_p)))
    for box, v in zip(shard_mesh.stack_boxes(part.dev_shape), parts):
        loc = np.zeros(tuple(reversed(part.nn_u_loc)) + (nd,))
        off = 0
        for p, s in enumerate(slv.dcfg.cls_shapes_loc):
            n = int(np.prod(s)) * nd
            loc[tuple(slice((p >> (nd - 1 - k)) & 1, None, 2)
                      for k in range(nd))] = v[off:off + n].reshape(
                          tuple(s) + (nd,))
            off += n
        g[part._grid_slices(box, 2, (slice(None),))] = loc
        gp[part._grid_slices(box, 1, ())] = v[off:].reshape(
            tuple(reversed(part.nn_p_loc)))
    want = np.concatenate([g.reshape(-1), gp.reshape(-1)])
    assert np.array_equal(slv._unshard_parts(parts), want)


def test_one_per_card_and_loop_defaults():
    """ShardMesh.one_per_card holds for one process with one shard on each
    CUDA card only (nothing touches a device); on the CPU the default loop
    stays the host's."""
    cuda = [torch.device("cuda", i) for i in range(4)]
    assert ShardMesh((1, 2, 2), cuda).one_per_card
    assert not ShardMesh((1, 2, 2), cuda).capturable
    assert not ShardMesh((1, 2, 2), [cuda[0]] * 4).one_per_card
    assert not ShardMesh((1, 2, 2), cuda[:2] * 2).one_per_card
    assert not ShardMesh((1, 2, 2), [CPU] * 4).one_per_card
    assert not ShardMesh((1, 2, 2), cuda[:2], shards=(0, 1)).one_per_card
    slv, _ = _solver([CPU] * 4)
    assert slv.loop == "host" and slv._dev is None
    with pytest.raises(ValueError, match="one shard on each CUDA card"):
        slv.with_loop("device")


def test_sharded_flagship_meets_the_reference(one_thread):
    """The benchmark's flagship (pseudoice_mx32's configuration) at
    mx = my = mz = 8 over 4 CPU shards (grid 1 x 2 x 2), the harness's
    sharded build, solved for two loads of the benchmark's generator: the
    plain float64 reference (benchmark/reference, no port kernel) reads
    each relative residual at or under the guarantee, 1e-8."""
    from benchmark import harness
    from benchmark import loads as bloads
    config = harness.read_json(os.path.join(harness.HERE, "configs",
                                            "pseudoice_mx32.json"))
    config = dict(config, shards=4, mg_levels=3,
                  flags=dict(config["flags"], mx=8, my=8, mz=8))
    traffic = dict(harness.read_json(os.path.join(
        harness.HERE, "traffic", "rhs_stream_f64.json")), loads=2)
    problem = harness.reference_problem(config)
    loads = bloads.make_loads(traffic, 2 ** 31 + 77, problem,
                              harness.saddle(problem, CPU))
    slv, _ = harness.build_solver(config, harness.system_problem(config),
                                  CPU, "float64", chips=4)
    assert slv.part.dev_shape == (1, 2, 2) and slv.loop == "host"
    entry = harness.Entry(slv, config, "float64")
    rhs_diri = np.asarray(slv.setup["rhs_diri"])
    xs = [entry(F + rhs_diri)[0] for F in loads]
    res, checks = harness.judge(config, problem, loads, xs, len(xs), CPU)
    assert checks["resid_max"]["value"] <= 1e-8
    assert min(res) > 0.0


# --- on the cards ----------------------------------------------------------

def _need_cards(n):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA cards")
    ok, why = peer.peer_access([torch.device("cuda", i) for i in range(n)])
    if not ok:
        pytest.skip(why)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 4])
def test_cards_device_loop_equals_one_card(n):
    """Pseudoice at mx=8 with one shard on each of n cards (the default
    loop: each card one conditional graph, the collectives peer kernels)
    against the same shards' device loop on cuda:0: x, its, rnorm,
    history and counts bit for bit, over two solves; a solve is one graph
    launch per card and launches nothing from the host."""
    _need_cards(n)
    shape = (1, 1, 2) if n == 2 else (1, 2, 2)
    cards, F = _solver([torch.device("cuda", i) for i in range(n)],
                       model="11", mx=8, dev_shape=shape)
    one, _ = _solver([torch.device("cuda", 0)] * n, model="11", mx=8,
                     dev_shape=shape)
    assert cards.loop == one.loop == "device"
    assert isinstance(cards._dev, cart_abf.CartCardsSolver)
    for k in range(2):
        Fk = F * (1.0 + 0.1 * k)
        launches = [g.launches for g in cards._dev.graphs]
        a, b = cards.solve(Fk), one.solve(Fk)
        assert [g.launches - n0 for g, n0 in
                zip(cards._dev.graphs, launches)] == [1] * n
        assert cards._dev.host_launches == 0
        assert (a["its"], a["rnorm"], a["state"]) == \
            (b["its"], b["rnorm"], b["state"])
        assert a["history"] == b["history"] and a["counts"] == b["counts"]
        assert np.array_equal(a["x"], b["x"])
        assert a["halo_exchanges"] == b["halo_exchanges"] > 0
        col = a["collectives"]
        assert col["graph_launches"] == n
        assert len(set(col["psums"])) == 1 and col["psums"][0] > 0
        assert min(col["halo_u"]) > 0 and min(col["ghosts"]) > 0


@pytest.mark.gpu
def test_a_lone_cards_wait_raises_on_cuda(monkeypatch):
    """One card's graph launched alone, the others not: its first
    collective waits out the group's timeout (0.5 s), the card's solve
    ends, and the check raises naming the card and the collective; the
    group, reset, then solves in step again."""
    _need_cards(2)
    monkeypatch.setattr(peer, "TIMEOUT_S", 0.5)
    slv, F = _solver([torch.device("cuda", i) for i in range(2)],
                     model="2", mx=4, dev_shape=(1, 1, 2))
    dev = slv._dev
    assert dev.group.timeout_s == 0.5
    Fp = slv._saddle_parts(F)
    v = dev.views[0]
    v._stage(np.concatenate([Fp[0], np.zeros_like(Fp[0])]))
    t0 = time.perf_counter()
    v._launch()
    res = v._finish()
    assert time.perf_counter() - t0 < 30.0
    assert res[v.counts_at.stop] == 1
    with pytest.raises(RuntimeError, match=r"cuda:0 in .* waiting for "
                       r"cuda:1"):
        dev.group.check()
    r = slv.solve(F)
    assert r["reason"] == "CONVERGED_RTOL"
