"""Smoke test of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py              # every phase below
    python3 chip_smoke.py --peer       # device, build, then phase peer
                                       # alone, and its kernels line
    python3 chip_smoke.py --profile    # device, build, then profiled
                                       # mx=32 IR solves under the bench's
                                       # tuned schedule: eager, the host
                                       # loop over captured bodies and the
                                       # device loop; then phase cart's
                                       # flagship and its single-device
                                       # solve, each plain driver profiled
                                       # beside the device loop's span
                                       # (PERF.md section 5)

Phases, in order; any failure raises and the script exits nonzero (a
schedule's counts outside BENCH_BANDS in phase bench are raised at the end,
after the kernels line):

1. device  -- a CUDA device must be present; prints nvidia-smi's name and
              power limit.
2. build   -- compiles the port's CUDA kernels from exsaddle_tpu_torch/csrc/
              into exsaddle_tpu_torch/_build/ (skipped when built already).
3. K1      -- the A00 kernel against its plain PyTorch version at the
              main path's shapes (mx=32 pseudoice, 3D) and on 2D SolCx at
              mx=my=64, in float32 and float64: agreement, bitwise-equal
              repeated applies, 2 kernel launches per apply (the kernel
              nodes of one apply captured as a CUDA graph), its products
              factored in 3D and dense in 2D (a00.LAUNCHES.factored);
              each kernel's device time per launch (torch.profiler); median
              per-apply times (CUDA
              events over 20 back-to-back calls) of the kernel, the plain
              version and one library call for the same function (SpMV of
              the raw A00 as an int32 CSR tensor, built here only), beside
              the bound (data-sheet peaks) and the kernel's share of it.
              At the 3D flagship's fine level, in both precisions, the
              factored apply and its element kernel, cold and hot (graphs
              of 50 calls, twice; the kernel's time from torch.profiler
              over a replay), the kernel and the factored plain version
              within the tolerance of the dense plain one (k1_tune.py
              --parent times the parent's dense kernel beside it). Then
              K1's
              fused forms (the keep in its loads: a00_apply(keep=); the
              mask terms, and K6's first step and step on the masked
              value, in its node gather's store: a00_masked,
              a00_cheb_first, a00_cheb_step) and K6's masked forms
              (cheb_first_masked, cheb_step_masked: the cart path's), each
              bitwise the launches it replaces (K1 without keep, the torch
              mask ops, K6) and its twin; each form, the launches it
              replaces and the plain version timed (graphs of 50 calls,
              cold and hot; the plain version eager), beside the bound;
              K1 with and without the keep alternated, with the bound by
              bytes of each.
              The build phase prints every kernel's registers and spills.
3b. ctl    -- the four Krylov control kernels (csrc/krylov_ctl.cu:
              fgmres_start_ctl, fgmres_arnoldi_ctl, gcr_ctl, ir_ctl)
              against their plain twins at the main path's sizes (restart
              30, history 256; float32 and float64, the refinement's in
              float64), on recorded states that reach every state branch:
              bit for bit; each kernel's device us per launch (50
              launches captured as one CUDA graph and replayed) beside its
              twin's and the bound of one launch's bytes and operations.
3c. mg_kernels -- K4, the block stencil (csrc/stencil_apply.cu), on the
              mx=32 flagship's own L-2 (33^3 nodes) and L-3 (17^3) stencils
              in the zero-boundary form and on a cart shard's L-2 slab
              (17 x 17 x 33) in the padded form, and K6, the Chebyshev
              update (csrc/cheb_update.cu), at the flagship's fine
              (823,875), L-2 (107,811) and p (35,937) sizes with its
              Jacobi diagonals, in float32 and float64, against their
              plain twins: K4 within 1e-5 / 1e-13 of max sum |W||x|,
              bitwise repeatable, its two forms bitwise equal, each fused
              epilogue (residual, Chebyshev first step and step) bitwise
              K4 followed by K6 or the subtraction; K6 bit for bit (both
              entry points); device us per call of kernel and twin (50
              calls captured as one CUDA graph and replayed) cold (the
              inputs cycled through copies that move 3x the 50 MB L2
              between two uses: the kernels line's ms) and hot (one
              input), the kernel's issued from Python, K4's library
              yardstick (cuSPARSE CSR SpMV of csr_from_stencil(W); CUDA
              events, cold and hot) and the HBM bound (bytes); the fused
              entries against their twins and the fused Chebyshev step
              against the K4 + K6 pair it replaces. Then K3, the p-block's
              Mpscaled apply (csrc/mp_apply.cu: Mpscaled's 27-point node
              stencil, built at setup), at the flagship's p size
              (33^3 nodes) on its own pscale, Np, diagonal and bounds, in
              float32 and float64: its plain form within 1e-5 / 1e-13 of
              the plain apply over absolute values (mp_apply_plain),
              bitwise repeatable, its step form (mp_cheb_step: K6's
              update in its store) bitwise its twin (the plain kernel,
              then K6); each form, its twin and
              the parent's launches it replaces (mp_apply_plain, then
              K6) timed cold and hot as K4; the library yardstick
              (cuSPARSE CSR SpMV of the assembled Mpscaled) and the bound.
              Then K5, the MG transfers
              (csrc/transfer.cu), at the flagship's own shapes: the
              parity pair fine <-> L-2, the grid pair L-2 <-> L-3 and
              L-3 <-> coarse, and the parity pair on one cart shard's box
              of the 1x2x2 grid, in float32 and float64: every entry and
              fused form (prolongation + add, restriction of b - y and of
              the cart V-cycle's w * (b - y), the grid restriction with
              the next level's first Chebyshev step in its store:
              restrict_grid_cheb_first, with L-3's own diagonal and bounds
              at L-2 -> L-3, also against the restrict_grid + K6
              cheb_first pair it replaces; the fine residual's restriction
              with L-2's first Chebyshev step in its store,
              restrict_parity_residual_cheb_first, likewise at fine ->
              L-2 with L-2's diagonal and bounds) bit for bit its twin;
              kernel and twin timed cold and hot as K4;
              the grid pair's library yardstick (F.conv3d /
              F.conv_transpose3d with the [0.5, 1, 0.5] tensor-product
              weights, stride 2, groups nd, TF32 off) against the twin to
              TOL and timed likewise; the bound (bytes). Builds its own
              mx=32 setup (~5 s).
4. anchor  -- the driver in direct float64 mode at mx=6 (3 MG levels) must
              reach CONVERGED_RTOL in <= 20 iterations with the reference's
              initial residual.
5. main    -- the driver on the flagship: model 11, size_x 0.1, mx=32,
              float32 inner solves with float64 iterative refinement to a
              true relative residual of 1e-8, 4 MG levels. Its solver runs
              the device loop: the whole refinement one CUDA graph with
              conditional nodes, captured at setup, one graph launch per
              solve; K1 and every control kernel must have run (counted
              from the device's loop-body counters), and K4, each of its
              fused entries and K6, every K4 launch a fused one, and every
              K5 kernel and fused form but the cart path's weighted
              residual restriction (never run here). The residual is
              recomputed with the port's float64 operator. Then over the
              same setup the device loop, the host loop over captured
              bodies (loop="host") and eager=True, 3 solves each,
              alternated; one device-loop solve under
              torch.cuda.set_sync_debug_mode("error"); one plain-driver
              solve (loop="plain"). The device loop is bitwise the plain
              driver (x, history, rounds, inner its, K1, K4, K5, K6 and
              control launches), the host loop bitwise eager=True and,
              since it does the device loop's window arithmetic on CUDA,
              bitwise the device loop (x, history, rounds, inner its);
              every kind at
              3 rounds / 34-38 inner its and a true residual <= 1e-8;
              each kind's median wall and spread, ms per outer
              iteration, K1 launches and applies, K5 launches (exactly
              2 (levels - 1) per V-cycle: the fused residual restriction,
              the prolongations with their add, levels - 3 grid
              restrictions into a smoothed level as
              restrict_grid_cheb_first, one into the coarse solve plain),
              K6 launches per V-cycle, K3 launches (every p-block step
              after its zero-guess first one mp_cheb_step; K6 only the
              fine and p-block zero-guess first steps; the fine residual
              restricted with L-2's first step in the store once per
              V-cycle), control-kernel, graph launches and replays,
              loop-body executions and peak memory per solve; K1's fused
              forms on the fine level (one a00_cheb_first and pre + its
              - 2 a00_cheb_step per V-cycle, the residual and GCR's
              operator a00_masked, no keep-only form) and K6's launches
              per V-cycle. The device-loop solve
              with K1's fused forms swapped for their twins (the launches
              they replace) is bitwise the fused solve (x, history,
              rounds, inner its), with equal K1 launches and K6 the fused
              solve's plus one per fused Chebyshev step. The same with
              K3's fused forms and the fused fine restriction swapped for
              their twins: bitwise, K6 one more per K3 step and per
              V-cycle; and the order witness, K3's entries swapped for the
              parent's routing (mp_apply_plain, then K6): its rounds and
              inner its logged beside the kernel's.
              Then the float64 witness: the same flagship as
              a float64 direct
              solve through the driver (device loop) and over its setup
              with loop="host": equal iterations, reason and K1 counts;
              and over the same setup with every K4 and K5 entry, K1's
              fused forms, K6 and K3 (mp_apply_plain) swapped for their
              twins: the same reason and iterations, x within 1e-10.
6. host_anchor -- the host KSP/PC route on CUDA for three reference trees
              (3d_mg_1, abf.opts under -tpu 0, ildl_1): each must reach
              CONVERGED_RTOL in exactly the JAX package's iteration count,
              with first and last monitor values equal to the JAX run's to
              1e-5 relative. Builds the native ILU/ILDL/ordering libraries
              first (g++) and prints the build seconds.
7. host_mg -- the full-size host route: the 3d_mg_1 tree at mx=32 (859,812
              dofs) with a 4-level rediscretised saddle PCMG (dense LU of
              2,312 dofs on the coarse level). Converges; the true residual
              ||F - A x||, recomputed with the float64 SaddleOperator, equals
              the last monitored residual to 1e-6; repeated applies are
              bitwise equal and a repeated solve (-twosolves) gives the same
              iteration count and a bitwise-equal x.
8. compiled -- the fixed-work FGMRES path with no host reads
              (compiled.make_fgmres_cycle_tree) on the mx=32 pseudoice
              parity operator (859,812 dofs), Jacobi PC, F from
              default_rng(2): one FGMRES(30) cycle in float64 and in float32,
              each under torch.cuda.set_sync_debug_mode("error"), each 2 x 32
              K1 launches; the float64 cycle also captured as one CUDA graph
              (capture fails on a host sync) and replayed, bitwise equal;
              the float64 residual equals the host KSP's
              (FGMRES(30), 30 its, convergence test skipped, over the flat
              ParityMatFreeOperator.mult) to 1e-8, the float32 one is within
              1% of it; ms per cycle and per iteration (CUDA events, median
              of 5) beside the host KSP's ms per iteration. At mx=16 in
              float64, GridSaddleOperator, MatFreeSaddleOperator and the flat
              parity mult equal SaddleOperator.mult to 1e-12, bitwise
              repeatable.
9. outputs -- the flagship -saddle_ksp_view argv at mx=6 on CUDA: the JAX
              package's iteration count and tree length, and the tree of a
              -device cpu run line for line (the two esteig line classes to
              1e-5). Every -dump_* flag, -view_fields and -view_coeffs at
              mx=4 in 3D into a temporary directory: every file reloads, the
              dumped solution is X bitwise, the dumped operator maps X to
              F - r, postproc.spectrum runs on the preconditioned operator.
              ex23 at -n 50 with the default PC and ildl, ilupack, jacobi,
              ilu: error below 1e-9.
10. ex42  -- the sinker (model 1) at mx=my=mz=32 (143,748 dofs), FGMRES
              to rtol 1e-7 with an additive fieldsplit: a 4-level Galerkin MG
              u-block (Chebyshev/Jacobi smoothers), a Jacobi p-block.
              Converges in the JAX package's iteration count with p-rows of F - A X below
              1e-8 ||F||; setup and solve seconds, ms per iteration.
11. cart  -- the sharded runtime (parallel/), every shard on this card. At
              mx=16 pseudoice in float64 over a 2x2x2 device grid: the
              element-batched make_cart_mult and the sharded mult_tree (K1
              once per shard, 2 x 8 launches per apply) equal the
              single-device SaddleOperator.mult and mult_tree to 1e-12,
              bitwise repeatable; make_cart_fgmres(k=30) runs under
              torch.cuda.set_sync_debug_mode("error") and its residual equals
              the single-device compiled cycle's to 1e-8. DistABFSolver over 4
              slabs gives the single-device float64 ABF solve's iteration
              count and x to 1e-10. Then the flagship argv (model 11, size_x
              0.1, mx=32, 4 MG levels) through driver.saddle_solve with
              devices=[cuda:0] * 4 (device grid 1x2x2, mode cart) against
              the single-device float64 direct solve of the same argv: the
              same iteration count and reason, the history to 1e-8 and x to
              1e-9 (norm-relative), the true residual recomputed with the float64
              parity operator; K1 launches 2 x 4 per sharded apply; setup /
              solve seconds, ms per outer iteration, halo exchanges, K1,
              K4 (every one fused), K4's fused entries, K5 (every
              kernel; the parity pair per shard, the prolongation with
              its add, the restriction of the ownership-weighted residual
              w * (r - A x), shards per V-cycle, no unfused one;
              2 x shards + 2 (levels - 2) per V-cycle, of them levels - 3
              grid restrictions into a smoothed replicated level as
              restrict_grid_cheb_first), K6 (its masked forms: every
              fine-level step after a zero guess) and K1's keep form
              (every fine apply; K1's store epilogues never run there),
              K3 (its plain form only, one launch per shard and p-block
              step) and control launches (each above 0), peak memory. The
              driver's sharded solver runs the device loop (one CUDA graph
              with conditional nodes per solve, CartABFSolver loop
              "device"); over its setup the device loop, the plain driver
              (loop "plain") and the host loop (loop "host") run alternated
              with the single-device float64 solve: each device solve 1
              graph launch under torch.cuda.set_sync_debug_mode("error")
              and no count moved by the host, x, its and history bitwise
              the plain driver's and the host loop's, K1, K4, K4 fused,
              K5, K6, control and halo counts per solve equal (the host
              loop runs no control kernel), K6 above 0; the walls of each
              kind
              and the graph launch's CUDA-event span with the card; then
              a device-loop solve with every K5 entry, K1's keep form and
              K6's masked forms swapped for their twins, x and history
              bitwise the kernels' solve, K1 launches equal; and with K3
              swapped for mp_apply_plain (the order witness, float64):
              the same its and reason, x within 1e-10. K1 (and its
              keep form), K6's masked forms, K3 (within 1e-13 of the
              apply over absolute values on each shard's box and pscale),
              K4 (and its fused epilogues, bitwise K4 + K6), K5's weighted
              residual restriction (on each shard's own weights, bitwise)
              and K6 on the sharded solver's own operands against their
              twins.
12. cart_procs -- the same flagship in 2 processes x 2 shards on this card
              (torch.multiprocessing spawn, a gloo group on localhost with
              a 120 s timeout; device grid 1x2x2, host axis z), each rank
              running driver.saddle_solve with devices=[cuda:0] * 2 (each
              assembles its own boxes, the setup partials summed through a
              HostComm), held against phase cart's one-process 4-shard
              solve: the same iteration count and reason, history and x to
              1e-9 norm-relative (max differences printed; the HostComm
              setup sums per process first, so its last bits differ from
              the one-process setup's), both ranks the same X, the true float64 residual recomputed, 2 x 2 K1
              launches per sharded apply in each process. Then each rank
              solves phase cart's F over the same shards with the setup
              every process builds alone (the one-process setup): its,
              history and x bitwise phase cart's. Per rank: setup / solve
              seconds, ms per outer iteration, cross-process messages and
              bytes, gathers, halo exchanges, K1 launches, peak memory. A
              child's exception, nonzero exit or the 480 s deadline fails
              the phase.
13. bench -- the port's bench (exsaddle_tpu_torch/bench.py) at mx=32:
              bench_apply (100 float32 saddle applies captured as one CUDA
              graph and replayed, beside the same applies issued eagerly;
              calibration; top device kernels) and bench_solve (float32 +
              float64 refinement to a true 1e-8) under the tuned schedule,
              with the abf.opts schedule and the tuned one with 3 fixed
              V-cycles in place of GCR (u_fixed_vcycles=3) alternated with
              it, every schedule's solver on the device loop (one graph
              launch per solve); prints the bench's JSON line. The graph
              replay equals the
              eager loop bitwise, the scaled loop is stable, one eager loop
              makes 2 x 100 K1 launches; every schedule converges without
              stalling to a float64 residual <= 1e-8 recomputed with the
              port's float64 operator, in rounds and inner iterations
              inside BENCH_BANDS (a miss is logged and raised after the
              kernels line, so the rest of the script still runs); every
              K5 kernel and fused form of the
              single-device path ran, the tuned solve's grid restrictions
              levels - 3 per V-cycle fused with the next level's first
              Chebyshev step and one plain (its K6 launches logged).
              Then the tuned schedule over a new setup
              with K4 and with every K4 entry swapped for its plain twin:
              K4 gives the bench's tuned counts with every stencil apply
              fused and 2 (levels - 1) K5 launches per V-cycle, the twins
              the pre-K4 band (BENCH_TWIN_BAND) and no K4 launch; the K4
              solve's K3 and K6 launches as in phase main, and a third
              solve with K3's entries swapped for the parent's routing
              (the order witness of the tuned solve: its counts logged).
14. peer -- the cross-card collectives (csrc/peer_collective.cu,
              kernels/peer.py) on the first 4 cards (2 where there are 2
              or 3; skipped, with a null entry in the kernels line, below
              2 or without peer access between every pair): each mode at
              the shapes of the mx=32 flagship's shard on that grid
              (1 x 2 x 2, or 1 x 1 x 2) through shard_mesh.CardMesh views
              over a kernels.peer.CudaGroup -- FOLD (psums of 1 and 31
              values), COPY (the L-2 gather, the L-2 ghost extension of
              every axis at once), ADD (halo_add_axes of the Q2 node grid
              along each split axis) -- bitwise the one-card ShardMesh
              psum / all_parts / ghost_extend_axis / halo_add_axes on the
              same inputs. Each mode's device time per collective (100 of
              it captured in one CUDA graph per card, the graphs launched
              back to back, CUDA events on every card; the slowest card)
              beside its bound (the bytes a card reads from its peers at
              450 GB/s) and the share of it spent in the waits (the
              group's wait counter). Then the main path on those cards:
              pseudoice at mx=8, CartABFSolver's default loop (one
              conditional graph per card), the peer counters zeroed just
              before one solve, its peer launches read after it.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

import json
import os
import re
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET

import numpy as np
import torch

from exsaddle_tpu_torch import abf as tabf
from exsaddle_tpu_torch import bench
from exsaddle_tpu_torch import compiled
from exsaddle_tpu_torch import driver as tdriver
from exsaddle_tpu_torch import graphs
from exsaddle_tpu_torch import models as emodels
from exsaddle_tpu_torch import native
from exsaddle_tpu_torch import postproc
from exsaddle_tpu_torch import treeops
from exsaddle_tpu_torch.assembly import FESpace, assemble_element_matrices
from exsaddle_tpu_torch.bench import self_device_us
from exsaddle_tpu_torch.ex23 import solve_ex23
from exsaddle_tpu_torch.ex42 import solve_stokes_3d_coupled
from exsaddle_tpu_torch.grid_ops import (GridSaddleOperator, gather_u_parity,
                                         split_u_parity)
from exsaddle_tpu_torch.kernels import _build
from exsaddle_tpu_torch.kernels import a00
from exsaddle_tpu_torch.kernels import cheb
from exsaddle_tpu_torch.kernels import krylov_ctl
from exsaddle_tpu_torch.kernels import mp
from exsaddle_tpu_torch.kernels import stencil
from exsaddle_tpu_torch.kernels import transfer
from exsaddle_tpu_torch.krylov import KSP, KSPConfig
from exsaddle_tpu_torch.matfree import (MatFreeSaddleOperator,
                                        ParityMatFreeOperator, mult_tree,
                                        parity_permutation, tree_aux)
from exsaddle_tpu_torch.mesh import SaddleMesh
from exsaddle_tpu_torch.operator import apply_dirichlet_elimination
from exsaddle_tpu_torch.options import Options
from exsaddle_tpu_torch.precond import PCJacobi

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def log(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def _peer_views(n):
    """(the one-card ShardMesh on cuda:0, each card's CardMesh view over a
    CudaGroup on cuda:0 .. cuda:n-1, the grid, the mx=32 shard's Q2 node
    grid and L-2 slab shapes, reversed dims then components)."""
    from exsaddle_tpu_torch.kernels import peer
    from exsaddle_tpu_torch.parallel.shard_mesh import CardMesh, ShardMesh
    grid = (1, 2, 2) if n == 4 else (1, 1, 2)
    mloc = [32 // g for g in grid]
    q2 = tuple(2 * m + 1 for m in reversed(mloc)) + (3,)
    l2 = tuple(m + 1 for m in reversed(mloc)) + (3,)
    devs = [torch.device("cuda", i) for i in range(n)]
    group = peer.CudaGroup(devs, int(np.prod(q2)))
    one = ShardMesh(grid, [devs[0]] * n)
    cards = ShardMesh(grid, devs)
    return one, [CardMesh(cards, i, group) for i in range(n)], grid, q2, l2


def _on_every_card(views, fn, reps=1, time_it=False):
    """fn(view) on every card: a warm-up with the group rehearsing
    (nothing launched, every allocation made), then `reps` calls captured
    in one CUDA graph per card, the graphs launched back to back (time_it:
    twice, the second timed). Returns (the last call's result per card;
    time_it: ms per call on the slowest card and seconds per call in the
    waits on the card that waited longest)."""
    group = views[0].group
    group.rehearse = True
    try:
        for v in views:
            with torch.cuda.device(v.devices[0]):
                fn(v)
    finally:
        group.rehearse = False
    out, graphs_ = [None] * len(views), []
    for i, v in enumerate(views):
        dev = v.devices[0]
        torch.cuda.synchronize(dev)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), torch.cuda.graph(
                g, stream=graphs.capture_stream(dev)):
            for _ in range(reps):
                out[i] = fn(v)
        graphs_.append(g)

    def replay(timed):
        ev = []
        for v, g in zip(views, graphs_):
            with torch.cuda.device(v.devices[0]):
                a = torch.cuda.Event(enable_timing=timed)
                b = torch.cuda.Event(enable_timing=timed)
                a.record()
                g.replay()
                b.record()
                ev.append((a, b))
        for v in views:
            torch.cuda.synchronize(v.devices[0])
        group.check()
        return ev
    if not time_it:
        replay(False)
        return out, None, None
    replay(False)
    w0 = group.wait_seconds()
    ev = replay(True)
    w1 = group.wait_seconds()
    return (out, max(a.elapsed_time(b) for a, b in ev) / reps,
            max(y - x for x, y in zip(w0, w1)) / reps)


def phase_peer(card):
    """Phase peer (module docstring, 14): the kernels line's entry for
    peer_collective, its fields null where fewer than 2 cards with peer
    access are present."""
    from exsaddle_tpu_torch.assembly import assemble_rhs, scatter_vector
    from exsaddle_tpu_torch.kernels import peer
    from exsaddle_tpu_torch.parallel import cart_abf, shard_mesh
    from exsaddle_tpu_torch.parallel.cart import CartPartition
    from exsaddle_tpu_torch.treeops import ShardVec
    entry = {"name": "peer_collective", "route": "cuda",
             "source": "exsaddle_tpu_torch/csrc/peer_collective.cu",
             "replaces": "exsaddle_tpu/parallel/cart.py:147",
             "cards": None, "launches": None, "cart_launches": None,
             "forms": None}
    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        log(f"[peer] skipped: {n} CUDA card(s), the phase needs 2")
        return entry
    if n == 3:
        n = 2
    ok, why = peer.peer_access([torch.device("cuda", i) for i in range(n)])
    if not ok:
        log(f"[peer] skipped: {why}")
        return entry
    one, views, grid, q2, l2 = _peer_views(n)
    rng = np.random.default_rng(14)
    forms, reps = {}, 100

    def on_cards(arrays):
        return [torch.as_tensor(a, device=v.devices[0])
                for a, v in zip(arrays, views)]

    def same(want, got):
        return all(_same_bits(w.cpu(), g.cpu()) for w, g in zip(want, got))

    def record(name, want, fn, nbytes):
        got, _, _ = _on_every_card(views, fn)
        check(same(want, got),
              f"peer {name}: the cards differ from the one-card mesh")
        _, ms, wait = _on_every_card(views, fn, reps, time_it=True)
        forms[name] = {"us": 1e3 * ms, "bound_us": 1e6 * nbytes / 450e9,
                       "wait_share": wait / (1e-3 * ms), "bytes": nbytes,
                       "bitwise": True}
        log(f"[peer] {name}: {1e3 * ms:.2f} us a collective on the slowest "
            f"card, {100 * forms[name]['wait_share']:.1f}% of it in its "
            f"waits; bound {forms[name]['bound_us']:.4f} us ({nbytes} B "
            f"from its peers at 450 GB/s); bitwise the one-card mesh")
    for k in (1, 31):
        p = [rng.standard_normal(k) for _ in range(n)]
        want = one.psum(one.shard(p)).parts[0]
        src = on_cards(p)
        record(f"fold_{k}", [want] * n,
               lambda v, src=src: v.psum(ShardVec([src[v.index]])).parts[0],
               8 * (n - 1) * k)
    slab = [rng.standard_normal(l2) for _ in range(n)]
    src = on_cards(slab)
    want = one.all_parts(one.shard(slab))
    record("copy_gather", [torch.stack(want)] * n,
           lambda v: torch.stack(v.all_parts(ShardVec([src[v.index]]))),
           8 * (n - 1) * int(np.prod(l2)))
    want = one.shard(slab)
    for d in reversed(range(3)):
        want = shard_mesh.ghost_extend_axis(one, want, d)
    nodes = tuple(reversed(l2[:3]))                 # per grid axis
    near = [o for o in np.ndindex(3, 3, 3) if o != (1, 1, 1) and all(
        0 <= b + c - 1 < g for b, c, g in zip(views[0].boxes[0], o, grid))]
    record("copy_ghosts", want.parts,
           lambda v: shard_mesh.ghost_extend(
               v, ShardVec([src[v.index]])).parts[0],
           8 * 3 * sum(int(np.prod([m for m, c in zip(nodes, o) if c == 1]))
                       for o in near))
    q = [rng.standard_normal(q2) for _ in range(n)]
    for d in (1, 2):
        if grid[d] == 1:
            continue
        want = one.shard(q)
        shard_mesh.halo_add_axes(one, [want], d)
        fresh = on_cards(q)
        got, _, _ = _on_every_card(views, lambda v, d=d: shard_mesh.
                                   halo_add_axes(v, [ShardVec([fresh[
                                       v.index]])], d)[0].parts[0])
        check(same(want.parts, got),
              f"peer add_axis{d}: the cards differ from the one-card mesh")
        acc = on_cards(q)
        _, ms, wait = _on_every_card(
            views, lambda v, d=d: shard_mesh.halo_add_axes(
                v, [ShardVec([acc[v.index]])], d), reps, time_it=True)
        nbytes = 8 * int(np.prod(q2)) // q2[2 - d]
        share = wait / (1e-3 * ms)
        forms[f"add_axis{d}"] = {"us": 1e3 * ms,
                                 "bound_us": 1e6 * nbytes / 450e9,
                                 "wait_share": share,
                                 "bytes": nbytes, "bitwise": True}
        log(f"[peer] add_axis{d}: {1e3 * ms:.2f} us a collective on the "
            f"slowest card, {100 * share:.1f}% of it in its waits; "
            f"bound {1e6 * nbytes / 450e9:.4f} us ({nbytes} B from its "
            f"peer at 450 GB/s); bitwise the one-card mesh")
    # the main path on these cards: one solve's peer launches
    opts = Options.from_args(["-model", "11", "-size_x", "0.1"])
    ctx = emodels.ModelContext(opts, 3, log=lambda *a, **k: None)
    mesh = SaddleMesh(3, (8, 8, 8), (0.1, 1.0, 1.0))
    fes = FESpace(mesh)
    bci, bcv = emodels.create_bc_list(ctx, mesh)
    slv = cart_abf.CartABFSolver(
        CartPartition(mesh, grid), ctx, bci, bcv,
        [torch.device("cuda", i) for i in range(n)], nlevels=3)
    check(slv.loop == "device"
          and isinstance(slv._dev, cart_abf.CartCardsSolver),
          f"peer: the main path over {n} cards runs loop {slv.loop}")
    coeff = tdriver.fine_coefficients(ctx, fes)
    f1, f2 = assemble_rhs(fes, coeff["Fu"], coeff["Fp"])
    F = scatter_vector(mesh, f1, f2)
    F[:mesh.nu][bci] = bcv
    F = F + slv.setup["rhs_diri"]
    slv.solve(F)
    peer.PSUMS.n = peer.HALOS.n = 0
    r = slv.solve(F)
    launches = peer.PSUMS.n + peer.HALOS.n
    col = r["collectives"]
    per_card = [a + b for a, b in zip(col["psums"], col["halo_exchanges"])]
    check(launches == sum(per_card) and len(set(per_card)) == 1,
          f"peer: {launches} launches counted, {per_card} by card")
    log(f"[peer] main path, pseudoice mx=8 on {n} cards ({r['its']} its): "
        f"{launches} peer launches in one solve, {per_card[0]} a card "
        f"({col['psums'][0]} psums and gathers, {col['halo_exchanges'][0]} "
        f"halo and ghost exchanges)")
    entry.update(cards=n, launches=launches, cart_launches=per_card[0],
                 forms=forms)
    return entry


def phase_device():
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return card


def phase_build():
    t0 = time.perf_counter()
    path, built, blog = _build.build()
    a00._fn(torch.float32)          # load and bind
    log(f"[build] {'built' if built else 'reused'} {path} in "
        f"{time.perf_counter() - t0:.2f} s")
    # ptxas -v: each entry function, its spills, then its registers
    lines = [ln.strip() for ln in blog.splitlines() if "ptxas info" in ln
             or "spill" in ln]
    check(any("Used" in ln for ln in lines),
          "no ptxas register report in the build log")
    for line in lines:
        log(f"[build] {line}")


def _problem(ndim, m, model, size):
    """(mesh, fes, coefficients, bc indices and values, natural-order bc
    mask) of one structured-grid problem."""
    opts = Options.from_args(["-model", str(model)])
    ctx = emodels.ModelContext(opts, ndim, log=lambda *a, **k: None)
    mesh = SaddleMesh(ndim, m, size)
    fes = FESpace(mesh)
    bc_idx, bc_vals = emodels.create_bc_list(ctx, mesh)
    coeff = tdriver.fine_coefficients(ctx, fes)
    bc_mask = np.zeros(mesh.ndof)
    bc_mask[:mesh.nu][bc_idx] = 1.0
    return mesh, fes, coeff, bc_idx, bc_vals, bc_mask


def _operator(ndim, m, model, size, dtype, device):
    mesh, fes, coeff, _, _, bc_mask = _problem(ndim, m, model, size)
    return ParityMatFreeOperator.build(mesh, fes, coeff, bc_mask,
                                       dtype=dtype, device=device)


def _median_ms(fn, reps=15, inner=20, warmup=3):
    """Per-call ms: CUDA events around `inner` back-to-back calls (so the
    device, not the host's issue, sets the time once a call outlasts its
    issue), median over `reps` such runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    return float(np.median(times))


# H100 SXM data-sheet peaks (dense rates at 700 W): FP32 CUDA cores, FP64
# tensor cores (the float64 products run there), HBM3
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}
PEAK_BYTES = 3.35e12


def k1_bound(op, dtype):
    """(bound in ms, what sets it) of one A00 apply on this operator: the
    products' FLOP at the peak rate of their type against x, scale_visc and
    Bs read once and y written once at the memory rate."""
    nd = len(op.m_el)
    nel, nrow = op.scale_visc.shape
    ncol = 3 ** nd * nd
    flop = 2 * 2 * nel * nrow * ncol
    size = torch.empty((), dtype=dtype).element_size()
    nbytes = size * (2 * op.nu + nel * nrow + nrow * ncol)
    t_ops, t_bytes = flop / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def raw_a00_csr(op):
    """The raw A00 (no Dirichlet masks) as a CSR tensor with int32 indices
    in float64: sum_e G_e^T Bs^T diag(s_e) Bs G_e, coalesced from the
    element matrices. The yardstick of one library call for K1's function;
    the port never calls it."""
    nd = len(op.m_el)
    dev = op.Bs.device
    G = gather_u_parity(split_u_parity(torch.arange(op.nu, device=dev),
                                       op.cls_shapes, nd), op.m_el)
    nel, ncol = G.shape
    Bs = op.Bs.double()
    s = op.scale_visc.double()
    Ke = torch.empty(nel, ncol, ncol, dtype=torch.float64, device=dev)
    for c in range(0, nel, 4096):
        Ke[c:c + 4096] = (Bs.T[None] * s[c:c + 4096, None, :]) @ Bs
    idx = torch.stack([G[:, :, None].expand(nel, ncol, ncol).reshape(-1),
                       G[:, None, :].expand(nel, ncol, ncol).reshape(-1)])
    A = torch.sparse_coo_tensor(idx, Ke.reshape(-1), (op.nu, op.nu))
    del idx, Ke, G
    A = A.coalesce().to_sparse_csr()
    return torch.sparse_csr_tensor(A.crow_indices().to(torch.int32),
                                   A.col_indices().to(torch.int32),
                                   A.values(), A.shape)


def _device_kernels(fn, calls=10):
    """{kernel name: (launches per call, mean device us per launch)} of the
    K1 kernels one call of fn launches, from torch.profiler; empty where
    the profiler records no device activity. For the device times only:
    the profiler has lost kernel records of a window on the H100 (19 of
    20, and once all of them), so launch counts come from
    graphs.kernels_per_call."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.count / calls, self_device_us(e) / e.count)
            for e in prof.key_averages()
            if "a00" in e.key and self_device_us(e) > 0}


# K1's fused forms and K6's masked forms, by the kernels line's names
A00_FUSED = ("a00_apply_keep", "a00_masked", "a00_cheb_first",
             "a00_cheb_step")
K6_MASKED = ("cheb_first_masked", "cheb_step_masked")
# the fine level's Chebyshev scalars in phase K1 (any: the forms are
# bitwise their twins for every scale and omega)
FUSED_SCALE, FUSED_OMEGA = 0.37, 1.61


def _fused_bound(op, dtype, form):
    """(bound ms, what sets it, the bytes' ms, bytes) of one call of a
    fused form on op's fine level: K1's products (the operations of its
    twin's elementwise ops besides) at the peak rate of their type against
    every input read once and the output written once. K1's forms read x,
    scale_visc and Bs and write y as the plain apply does, and besides the
    keep (the keep form), ks = keep and ms (mask), ks, ms, b and d (first
    step), and p_km1 too (step); K6's masked forms read b, y, ks, ms, d and
    x0 (and p_km1) and write one vector."""
    nd = len(op.m_el)
    nel, nrow = op.scale_visc.shape
    ncol = 3 ** nd * nd
    size = torch.empty((), dtype=dtype).element_size()
    if form in K6_MASKED:
        first = form == "cheb_first_masked"
        nbytes = size * (7 if first else 8) * op.nu
        nops = (7 if first else 10) * op.nu
    else:
        vecs = {"a00_apply": 0, "a00_apply_keep": 1, "a00_masked": 2,
                "a00_cheb_first": 4, "a00_cheb_step": 5}[form]
        nbytes = size * ((2 + vecs) * op.nu + nel * nrow + nrow * ncol)
        nops = 2 * 2 * nel * nrow * ncol + {
            "a00_apply": 0, "a00_apply_keep": 1, "a00_masked": 4,
            "a00_cheb_first": 8, "a00_cheb_step": 11}[form] * op.nu
    t_ops, t_bytes = nops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", 1e3 * t_bytes,
            nbytes)


def _fused_calls(op, aux):
    """{form: (fused, pair, plain)}, each a function of (x, b, q, y, d):
    the fused entry; the launches it replaces as the port issued them
    before (K1 without keep, the torch mask ops, K6), bitwise its result;
    the plain PyTorch version (a00_apply_plain and the torch ops)."""
    ks, ms = aux[0], aux[1]
    sc, om = FUSED_SCALE, FUSED_OMEGA

    def masked(x):
        return a00.a00_apply(op, x * ks) * ks + ms * x

    def masked_plain(x):
        return a00.a00_apply_plain(op, x * ks) * ks + ms * x

    return {
        "a00_apply": (lambda x, b, q, y, d: a00.a00_apply(op, x),
                      lambda x, b, q, y, d: a00.a00_apply(op, x),
                      lambda x, b, q, y, d: a00.a00_apply_plain(op, x)),
        "a00_apply_keep": (
            lambda x, b, q, y, d: a00.a00_apply(op, x, keep=ks),
            lambda x, b, q, y, d: a00.a00_apply(op, x * ks),
            lambda x, b, q, y, d: a00.a00_apply_plain(op, x * ks)),
        "a00_masked": (lambda x, b, q, y, d: a00.a00_masked(op, aux, x),
                       lambda x, b, q, y, d: masked(x),
                       lambda x, b, q, y, d: masked_plain(x)),
        "a00_cheb_first": (
            lambda x, b, q, y, d: a00.a00_cheb_first(op, aux, b, x, d, sc),
            lambda x, b, q, y, d: cheb.cheb_first(b, masked(x), d, x, sc),
            lambda x, b, q, y, d: cheb.cheb_first_plain(
                b, masked_plain(x), d, x, sc)),
        "a00_cheb_step": (
            lambda x, b, q, y, d: a00.a00_cheb_step(op, aux, b, x, q, d, sc,
                                                    om),
            lambda x, b, q, y, d: cheb.cheb_step(b, masked(x), d, x, q, sc,
                                                 om),
            lambda x, b, q, y, d: cheb.cheb_step_plain(
                b, masked_plain(x), d, x, q, sc, om)),
        "cheb_first_masked": (
            lambda x, b, q, y, d: cheb.cheb_first_masked(b, y, ks, ms, d, x,
                                                         sc),
            lambda x, b, q, y, d: cheb.cheb_first(b, y * ks + ms * x, d, x,
                                                  sc),
            lambda x, b, q, y, d: cheb.cheb_first_masked_plain(
                b, y, ks, ms, d, x, sc)),
        "cheb_step_masked": (
            lambda x, b, q, y, d: cheb.cheb_step_masked(b, y, ks, ms, d, x,
                                                        q, sc, om),
            lambda x, b, q, y, d: cheb.cheb_step(b, y * ks + ms * x, d, x, q,
                                                 sc, om),
            lambda x, b, q, y, d: cheb.cheb_step_masked_plain(
                b, y, ks, ms, d, x, q, sc, om))}


def _hot_cold(fn, args, kernels=False):
    """Device ms per call of fn(*args) captured as one CUDA graph of
    MG_REPS calls and replayed (_graph_ms): (hot: one input; cold: the
    vectors args cycled through _cold_copies, op's scale_visc and Bs
    shared, as consecutive fine-level applies share them). With kernels,
    each is (ms, {kernel name: device us per launch})."""
    hot = _graph_ms([lambda: fn(*args)] * MG_REPS, kernels=kernels)
    nbytes = sum(a.numel() * a.element_size() for a in args)
    copies = _cold_copies(args, nbytes)
    cold = _graph_ms([lambda c=c: fn(*c) for c in copies]
                     * -(-MG_REPS // len(copies)), kernels=kernels)
    return hot, cold


def _element_us(kernels):
    """K1's element kernel (factored or dense) in a {kernel name: us}
    profile, or nan."""
    return next((us for k, us in kernels.items()
                 if "a00_factored_kernel" in k or "a00_element_kernel" in k),
                float("nan"))


def _k1_factored(name, op, dtype, card):
    """K1's factored element products on one 3D operator: the kernel and
    the factored plain version within TOL of the dense plain version; the
    whole apply's and the element kernel's device us per call, cold and
    hot (graphs of MG_REPS), twice, beside the bound (the parent's dense
    kernel is timed beside it by k1_tune.py --parent). Returns {"apply":
    [[cold, hot] us per turn], "element": [[cold, hot] us per turn]}."""
    x = torch.as_tensor(np.random.default_rng(31).standard_normal(op.nu),
                        dtype=dtype, device=op.Bs.device)
    y_p = a00.a00_apply_plain(op, x)
    scale = float(y_p.abs().max())
    for what, y in (("the kernel", a00.a00_apply(op, x)),
                    ("the factored plain version",
                     a00.a00_factored_plain(op, x))):
        err = float((y - y_p).abs().max()) / scale
        check(err <= TOL[dtype], f"K1 {name} {dtype}: {what} off the dense "
              f"plain version by {err:.3e}")
    bound_ms, bound_by = k1_bound(op, dtype)
    out = {"apply": [], "element": []}
    for _ in range(2):
        (hot, khot), (cold, kcold) = _hot_cold(
            lambda v: a00.a00_apply(op, v), (x,), kernels=True)
        out["apply"].append([1e3 * cold, 1e3 * hot])
        out["element"].append([_element_us(kcold), _element_us(khot)])
    t, e = out["apply"], out["element"]
    log(f"[K1] {name} {str(dtype)[6:]}: factored apply cold "
        + ", ".join(f"{c:.2f}" for c, _ in t) + " us, hot "
        + ", ".join(f"{h:.2f}" for _, h in t)
        + " us; its element kernel cold "
        + ", ".join(f"{c:.2f}" for c, _ in e) + " us, hot "
        + ", ".join(f"{h:.2f}" for _, h in e)
        + f" us (graphs of {MG_REPS}); the dense count's bound "
        f"{1e3 * bound_ms:.2f} us ({bound_by}), apply at "
        f"{100 * bound_ms / (t[0][0] / 1e3):.1f}% of it cold ({card})")
    return out


def _k1_fused(name, op, dtype, card):
    """K1's fused forms and K6's masked forms on op's fine level (the mx=32
    flagship's, as the main path runs them): each bitwise the launches it
    replaces (K1 without keep, the torch mask ops, K6) and its twin;
    device us per call cold and hot (_hot_cold) of the form, of the pair
    it replaces and (eager, CUDA events) of the plain version, beside its
    bound; K1 with and without keep alternated (none, keep, keep, none).
    Returns {form: the kernels line's numbers}."""
    aux = tree_aux(op)
    rng = np.random.default_rng(23)
    x, b, q, y = (torch.as_tensor(rng.standard_normal(op.nu), dtype=dtype,
                                  device=op.Bs.device) for _ in range(4))
    d = torch.as_tensor(rng.uniform(0.5, 1.5, op.nu), dtype=dtype,
                        device=op.Bs.device)
    args = (x, b, q, y, d)
    calls = _fused_calls(op, aux)
    twins = {"a00_apply_keep": lambda: a00.TWINS["a00_apply"](
        op, x, aux[0]),
             "a00_masked": lambda: a00.TWINS["a00_masked"](op, aux, x),
             "a00_cheb_first": lambda: a00.TWINS["a00_cheb_first"](
                 op, aux, b, x, d, FUSED_SCALE),
             "a00_cheb_step": lambda: a00.TWINS["a00_cheb_step"](
                 op, aux, b, x, q, d, FUSED_SCALE, FUSED_OMEGA)}
    tag = f"[K1] {name} {str(dtype)[6:]}"
    out = {}
    for form in A00_FUSED + K6_MASKED:
        fused, pair, plain = calls[form]
        got = fused(*args)
        same = _same_bits(got, pair(*args)) and _same_bits(
            got, twins[form]() if form in twins else plain(*args))
        check(same, f"{tag}: {form} is not bitwise the launches it "
              f"replaces and its twin")
        check(_same_bits(fused(*args), got),
              f"{tag}: repeated {form} calls differ")
        err = float((got - plain(*args)).abs().max())
        (hot, pair_hot), (cold, pair_cold) = zip(_hot_cold(fused, args),
                                                 _hot_cold(pair, args))
        plain_ms = _median_ms(lambda: plain(*args), reps=5, inner=5)
        bound_ms, bound_by, bytes_ms, nbytes = _fused_bound(op, dtype, form)
        log(f"{tag}: {form} bitwise the launches it replaces and its twin;"
            f" {1e3 * cold:.2f} us cold, {1e3 * hot:.2f} us hot per call "
            f"(graph of {MG_REPS}); the launches it replaces "
            f"{1e3 * pair_cold:.2f} / {1e3 * pair_hot:.2f} us cold / hot; "
            f"plain {1e3 * plain_ms:.2f} us (max abs err against it "
            f"{err:.3e}); bound {1e3 * bound_ms:.2f} us ({bound_by}; bytes "
            f"{nbytes / 1e6:.1f} MB take {1e3 * bytes_ms:.2f} us), at "
            f"{100 * bound_ms / cold:.1f}% of it cold ({card})")
        out[form] = {"max_abs_err": 0.0, "ms": cold, "hot_ms": hot,
                     "plain_ms": plain_ms, "pair_ms": pair_cold,
                     "pair_hot_ms": pair_hot, "bound_ms": bound_ms,
                     "bound_by": bound_by, "bytes_bound_ms": bytes_ms,
                     "library_ms": None}
    # K1 with and without the keep in its loads, alternated
    keep = {"a00_apply": [], "a00_apply_keep": []}
    for form in ("a00_apply", "a00_apply_keep", "a00_apply_keep",
                 "a00_apply"):
        keep[form].append(_hot_cold(calls[form][0], args))
    for form, times in keep.items():
        _, _, bytes_ms, nbytes = _fused_bound(op, dtype, form)
        log(f"{tag}: {form}, alternated (none, keep, keep, none): cold "
            + ", ".join(f"{1e3 * c:.2f}" for _, c in times) + " us, hot "
            + ", ".join(f"{1e3 * h:.2f}" for h, _ in times)
            + f" us; HBM bound by bytes {1e3 * bytes_ms:.2f} us "
            f"({nbytes / 1e6:.1f} MB) ({card})")
    out["a00_apply_keep"]["alternated_us"] = {
        f: [[1e3 * h, 1e3 * c] for h, c in t] for f, t in keep.items()}
    return out


def phase_k1(device, card):
    """K1 against its plain version and the library's CSR SpMV, then its
    fused forms at the flagship's shapes (_k1_fused); returns the float32
    3D numbers (the main path's working precision and shapes) and the
    fused forms' float32 numbers."""
    out, fused = {}, {}
    cases = [("3D mx=32 pseudoice", 3, (32, 32, 32), 11, (0.1, 1.0, 1.0)),
             ("2D mx=my=64 SolCx", 2, (64, 64), 0, (1.0, 1.0))]
    for name, ndim, m, model, size in cases:
        op64 = _operator(ndim, m, model, size, torch.float64, device)
        t0 = time.perf_counter()
        csr64 = raw_a00_csr(op64)
        log(f"[K1] {name}: raw A00 CSR nnz {csr64.values().numel()}, built "
            f"in {time.perf_counter() - t0:.2f} s")
        for dtype in (torch.float32, torch.float64):
            op = _operator(ndim, m, model, size, dtype, device)
            x = torch.as_tensor(np.random.default_rng(0).standard_normal(
                op.nu), dtype=dtype, device=device)
            f0 = a00.LAUNCHES.factored
            y_k = a00.a00_apply(op, x)
            check(a00.LAUNCHES.factored - f0 == (ndim == 3),
                  f"K1 {name} {dtype}: the apply took the "
                  f"{'factored' if ndim == 2 else 'dense'} products")
            y_p = a00.a00_apply_plain(op, x)
            torch.cuda.synchronize()
            err = float((y_k - y_p).abs().max())
            rel = err / float(y_p.abs().max())
            ok = bool(torch.isfinite(y_k).all()) and rel <= TOL[dtype]
            check(ok, f"K1 {name} {dtype} disagrees with its plain version "
                  f"(relative {rel:.3e})")
            check(torch.equal(a00.a00_apply(op, x), y_k),
                  f"K1 {name} {dtype}: repeated applies differ")
            csr = csr64 if dtype == torch.float64 else torch.sparse_csr_tensor(
                csr64.crow_indices(), csr64.col_indices(),
                csr64.values().to(dtype), csr64.shape)
            lib_rel = float((csr @ x - y_p).abs().max() / y_p.abs().max())
            check(lib_rel <= 1e3 * TOL[dtype],
                  f"K1 {name} {dtype}: CSR yardstick off by {lib_rel:.3e}")
            per_apply = graphs.kernels_per_call(
                lambda: a00.a00_apply(op, x))
            check(per_apply == a00.KERNELS_PER_APPLY,
                  f"K1 {name} {dtype}: one apply captured as a CUDA graph "
                  f"holds {per_apply} kernel launches")
            kern = _device_kernels(lambda: a00.a00_apply(op, x))
            for kname, (n, us) in kern.items():
                log(f"[K1] {name} {str(dtype)[6:]}: device {us:.2f} us per "
                    f"launch, {n:g} per apply: {kname[:110]}")
            ms = _median_ms(lambda: a00.a00_apply(op, x))
            plain_ms = _median_ms(lambda: a00.a00_apply_plain(op, x))
            library_ms = _median_ms(lambda: csr @ x)
            bound_ms, bound_by = k1_bound(op, dtype)
            log(f"[K1] {name} {str(dtype)[6:]}: max_abs_err {err:.3e} "
                f"rel {rel:.3e} (tol {TOL[dtype]:g}), bitwise repeatable, "
                f"{per_apply:g} device launches per apply; kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library (CSR SpMV, "
                f"int32) {library_ms:.4f} ms, bound {1e3 * bound_ms:.1f} us "
                f"({bound_by}), kernel at {100 * bound_ms / ms:.1f}% of it")
            del y_k, y_p, csr
            torch.cuda.empty_cache()
            if ndim == 3:
                factored = _k1_factored(name, op, dtype, card)
                rec = _k1_fused(name, op, dtype, card)
                if dtype == torch.float32:
                    out = {"max_abs_err": err, "ms": ms,
                           "plain_ms": plain_ms, "library_ms": library_ms,
                           "bound_ms": bound_ms, "bound_by": bound_by,
                           "factored_us": factored}
                    fused = rec
            del op, x
        del op64, csr64
        torch.cuda.empty_cache()
    return out, fused


# the Krylov control kernels: (name, the JAX code whose scalar tail each
# replaces, what one launch does)
CTL_KERNELS = (
    ("fgmres_start_ctl", "exsaddle_tpu/treeops.py:338"),
    ("fgmres_arnoldi_ctl", "exsaddle_tpu/treeops.py:369"),
    ("gcr_ctl", "exsaddle_tpu/treeops.py:269"),
    ("ir_ctl", "exsaddle_tpu/abf.py:1152"),
)
CTL_K, CTL_HIST, CTL_REPS = 30, 256, 50


class _Ns:
    def __init__(self, **kw):
        self.__dict__.update(kw)

    def clone(self):
        return _Ns(**{k: v.clone() if isinstance(v, torch.Tensor) else v
                      for k, v in self.__dict__.items()})

    def tensors(self):
        return {k: v for k, v in self.__dict__.items()
                if isinstance(v, torch.Tensor)}


def _fgmres_state(dtype, device, seed, it, itc, r0, par, max_it=10000,
                  git=None, k=CTL_K):
    """A recorded FGMRES control state at the main path's sizes (restart
    30, history 256) from a numpy seed."""
    rng = np.random.default_rng(seed)
    H = np.zeros((k + 1, k))
    H[:it + 1, :it] = np.triu(rng.standard_normal((it + 1, it)))
    H[np.arange(it), np.arange(it)] += 2.0
    g = np.zeros(k + 1)
    g[:it + 1] = rng.standard_normal(it + 1)
    if git is not None:
        g[it] = git
    ang = rng.random(k) * 2 * np.pi
    cs, sn = np.cos(ang), np.sin(ang)
    cs[it:], sn[it:] = 0, 0
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa
    return _Ns(k=k, hist_len=CTL_HIST, max_it=max_it, H=t(H), g=t(g),
               cs=t(cs), sn=t(sn), y=t(np.zeros(k)),
               hist=t(np.full(CTL_HIST, -1.0)), sc=t([r0, 0.0, 0.0]),
               par=t(par), ints=torch.tensor([0, it, itc], dtype=torch.int32,
                                             device=device),
               ix=torch.tensor([it, it + 1], dtype=torch.int64,
                               device=device), p0=0, c0=0)


def _max_err(a, b):
    """Largest |a - b| over the float state tensors (NaN where both are
    NaN counts 0), and whether every tensor agrees bit for bit."""
    err, same = 0.0, True
    for name, x in a.tensors().items():
        y = getattr(b, name)
        if x.is_floating_point():
            nx, ny = torch.isnan(x), torch.isnan(y)
            same &= torch.equal(nx, ny)
            x, y = torch.where(nx, 0, x), torch.where(ny, 0, y)
            bits = torch.int32 if x.dtype == torch.float32 else torch.int64
            same &= torch.equal(x.view(bits), y.view(bits))
            err = max(err, float((x - y).abs().max()))
        else:
            same &= torch.equal(x, y)
    return err, same


def _same_bits(a, b):
    """a and b: one shape, one float dtype, the same bits."""
    bits = torch.int32 if a.dtype == torch.float32 else torch.int64
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.contiguous().view(bits),
                            b.contiguous().view(bits)))


def _events_ms(fns):
    """ms per call of the calls in fns, back to back between two CUDA
    events (after one warm-up call of the first)."""
    fns[0]()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for fn in fns:
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / len(fns)


def _graph_ms(fns, restore=None, reps=5, kernels=False):
    """Device ms per call of the calls in fns, captured back to back as one
    CUDA graph (as the main path runs them: inside a graph, with no host
    issue between them) and replayed between two CUDA events; median over
    reps replays, restore() (outside the timed region) before each. With
    kernels, (that, {kernel name: device us per launch}) from one more
    replay under torch.profiler (empty where it records no device
    activity)."""
    g = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fns[0]()
    torch.cuda.current_stream().wait_stream(side)
    n0 = graphs._counters()
    with graphs.collector_held(), torch.cuda.graph(g):
        for fn in fns:
            fn()
    graphs._set_counters(n0)
    times = []
    for _ in range(reps):
        if restore is not None:
            restore()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        g.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / len(fns))
    if not kernels:
        return float(np.median(times))
    from torch.profiler import ProfilerActivity, profile
    if restore is not None:
        restore()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        g.replay()
        torch.cuda.synchronize()
    return float(np.median(times)), {
        e.key: self_device_us(e) / e.count for e in prof.key_averages()
        if self_device_us(e) > 0}


def _ctl_bound(nbytes, nops, dtype):
    t_b, t_o = nbytes / PEAK_BYTES, nops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_b, t_o), ("operations" if t_o > t_b else "bytes")


def phase_ctl(device):
    """Each Krylov control kernel against its plain twin on states that
    cover every branch, at the main path's sizes (FGMRES restart 30,
    history 256, float32; the refinement in float64): bit for bit, then
    the kernel's device ms per launch (50 launches captured as one CUDA
    graph, as the main path runs them, and replayed) and the twin's
    (issued from Python, CUDA events) beside the bound of one launch's
    bytes and operations. No single PyTorch call computes what one of
    them does (library_ms null)."""
    from exsaddle_tpu_torch.graphs import Control
    f32, f64 = torch.float32, torch.float64
    out = {}
    t = lambda v, dt=f32: torch.tensor(v, dtype=dt, device=device)  # noqa

    def ctl():
        return Control(device)

    # fgmres_arnoldi_ctl: (it, itc, h scale, tt, r0, par, max_it, g[it])
    branches = [(15, 15, 1.0, 0.7, 10.0, (1e-5, 1e-50, 1e4), 10000, None),
                (4, 9, 1.0, 1e-9, 1.0, (1e-3, 1e-50, 1e4), 10000, None),
                (3, 3, 1.0, 1e-12, 1.0, (1e-30, 1e-3, 1e4), 10000, None),
                (2, 2, 1.0, 1e-31, 1.0, (1e-45, 1e-50, 1e4), 10000, 0.5),
                (0, 0, 0.0, 0.0, 1.0, (1e-30, 1e-50, 1e4), 10000, None),
                (1, 1, 1.0, 0.5, 1e-3, (1e-12, 1e-50, 1.0), 10000, None),
                (2, 6, 1.0, 0.3, 100.0, (1e-12, 1e-50, 1e4), 7, None),
                (29, 41, 1.0, 0.3, 100.0, (1e-12, 1e-50, 1e4), 10000, None)]
    rng = np.random.default_rng(11)
    results = {}
    for dt in (f32, f64):
        err, same = 0.0, True
        for i, (it, itc, hs, tt, r0, par, max_it, git) in enumerate(
                branches):
            a = _fgmres_state(dt, device, i, it, itc, r0, par, max_it, git)
            b = a.clone()
            h = hs * rng.standard_normal(CTL_K + 1)
            h[it + 1:] = 0
            if i in (1, 2, 3):
                h[it] = 3.0
            h, ttt = t(h, dt), t(tt, dt)
            c1, c2 = ctl(), ctl()
            krylov_ctl.fgmres_arnoldi_ctl(a, h, ttt, c1)
            krylov_ctl.fgmres_arnoldi_ctl_plain(b, h, ttt, c2)
            e, sm = _max_err(a, b)
            err, same = max(err, e), same and sm and torch.equal(
                c1.pred, c2.pred) and torch.equal(c1.counts, c2.counts)
        results[("fgmres_arnoldi_ctl", dt)] = (err, same)
    it = 15
    base = _fgmres_state(f32, device, 0, it, it, 10.0, (1e-5, 1e-50, 1e4))
    h = t(np.where(np.arange(CTL_K + 1) <= it,
                   rng.standard_normal(CTL_K + 1), 0.0))
    tt = t(0.7)
    states = [base.clone() for _ in range(CTL_REPS)]
    c = ctl()

    def restore():
        for st in states:
            for name, x in base.tensors().items():
                getattr(st, name).copy_(x)
    ms = _graph_ms([lambda s=s: krylov_ctl.fgmres_arnoldi_ctl(s, h, tt, c)
                    for s in states], restore)
    restore()
    plain_ms = _events_ms([lambda s=s: krylov_ctl.fgmres_arnoldi_ctl_plain(
        s, h, tt, c) for s in states[:5]])
    # read: h[:it+1], tt, g[it], cs/sn[:it], r0, par; write: the H column,
    # cs/sn[it], g[it:it+2], rnorm, hist[itc]; ints, ix, 4 predicates and
    # 2 counters
    nb = 4 * ((it + 1) + 1 + 1 + 2 * it + 1 + 3 + (CTL_K + 1) + 2 + 2 + 1
              + 1) + 4 * 3 * 2 + 8 * 2 + 4 * 4 + 8 * 2
    out["fgmres_arnoldi_ctl"] = (ms, plain_ms) + _ctl_bound(
        nb, 6 * it + 16, f32)

    # fgmres_start_ctl: modes 0 and 1 over beta / itc / par branches
    for dt in (f32, f64):
        err, same = 0.0, True
        for i, (mode, beta, itc, par) in enumerate(
                [(0, 1.0, 5, (1e-5, 1e-50, 1e4)),
                 (1, 2.5, 0, (1e-5, 1e-50, 1e4)),
                 (1, 0.0, 0, (1e-5, 1e-50, 1e4)),
                 (1, 1e-7, 30, (1e-5, 1e-50, 1e4)),
                 (1, 7.0, 30, (1e-5, 1e-50, 2.0)),
                 (1, 1e-9, 12, (1e-30, 1e-6, 1e4))]):
            a = _fgmres_state(dt, device, 20 + i, 4, itc, 3.0, par)
            b = a.clone()
            c1, c2 = ctl(), ctl()
            bt = t([beta], dt)
            krylov_ctl.fgmres_start_ctl(mode, a, bt, c1)
            krylov_ctl.fgmres_start_ctl_plain(mode, b, bt, c2)
            e, sm = _max_err(a, b)
            err, same = max(err, e), same and sm and torch.equal(
                c1.pred, c2.pred) and torch.equal(c1.counts, c2.counts)
        results[("fgmres_start_ctl", dt)] = (err, same)
    s0 = _fgmres_state(f32, device, 0, 4, 12, 3.0, (1e-5, 1e-50, 1e4))
    beta = t([2.5])
    ms = _graph_ms([lambda: krylov_ctl.fgmres_start_ctl(1, s0, beta, c)]
                   * CTL_REPS)
    plain_ms = _events_ms([lambda: krylov_ctl.fgmres_start_ctl_plain(
        1, s0, beta, c)] * 5)
    # read: beta, itc, r0, par; write: H, g, cs, sn (zeroed), sc, hist[itc]
    nb = 4 * (1 + 1 + 3 + (CTL_K + 1) * CTL_K + (CTL_K + 1) + 2 * CTL_K + 3
              + 1) + 4 * 3 * 2 + 8 * 2 + 4 * 4 + 8
    out["fgmres_start_ctl"] = (ms, plain_ms) + _ctl_bound(nb, 4, f32)

    # gcr_ctl: init (running, atol) and steps (nv wrap, rtol, max_it,
    # alpha == 0)
    seq = [(0, 1.0, 4.0)] + [(1, 1.0, r) for r in
                              (2.0, 1.0, 0.5, 0.3, 0.2, 0.1)] + [
        (0, 1.0, 4.0), (1, 0.0, 3.0), (0, 1.0, 1e-60), (0, 1.0, 5.0),
        (1, 1.0, 0.01)]

    def gcr_state(dt):
        return _Ns(sc=t([0.0, 0.0, 0.0], dt), par=t([1e-2, 1e-50], dt),
                   ints=torch.zeros(3, dtype=torch.int32, device=device),
                   ix=torch.zeros(1, dtype=torch.int64, device=device),
                   restart=3, max_it=6, p=0, c0=0)
    for dt in (f32, f64):
        a = gcr_state(dt)
        b = a.clone()
        c1, c2 = ctl(), ctl()
        err, same = 0.0, True
        for mode, alpha, rn in seq:
            krylov_ctl.gcr_ctl(mode, a, t(alpha, dt), t(rn, dt), c1)
            krylov_ctl.gcr_ctl_plain(mode, b, t(alpha, dt), t(rn, dt), c2)
            e, sm = _max_err(a, b)
            err, same = max(err, e), same and sm and torch.equal(
                c1.pred, c2.pred) and torch.equal(c1.counts, c2.counts)
        results[("gcr_ctl", dt)] = (err, same)
    g = gcr_state(f32)
    g.restart, g.max_it = 30, 10 ** 9
    alpha, rn = t(1.0), t(0.5)
    krylov_ctl.gcr_ctl(0, g, alpha, t(4.0), c)
    ms = _graph_ms([lambda: krylov_ctl.gcr_ctl(1, g, alpha, rn, c)]
                   * CTL_REPS)
    plain_ms = _events_ms([lambda: krylov_ctl.gcr_ctl_plain(
        1, g, alpha, rn, c)] * 5)
    # read: alpha, rn, target, par, ints; write: rnorm, ints, ix, the
    # predicate and a counter
    out["gcr_ctl"] = (ms, plain_ms) + _ctl_bound(
        4 * (2 + 1 + 2 + 1) + 4 * 3 * 2 + 8 + 4 + 8, 3, f32)

    # ir_ctl (float64): init, accepted, rejected, non-contracting,
    # converged rounds and the n_rounds bound
    def ir_state():
        return _Ns(sc=t([0.0, 0.0, 1e-8, 3.0], f64),
                   ints=torch.zeros(5, dtype=torch.int32, device=device),
                   hist=torch.zeros(11, dtype=f64, device=device), p=0, c0=0)
    a, b = ir_state(), ir_state()
    c1, c2 = ctl(), ctl()
    fg = torch.zeros(3, dtype=torch.int32, device=device)
    err, same = 0.0, True
    for mode, rn, st in [(0, 2.0, 2), (1, 1e-4, 2), (1, 1e-6, -3),
                         (0, 2.0, 2), (1, 1.0, 2), (1, 3.0, 2), (0, 2.0, 2),
                         (1, 1.0, 2), (1, 1e-9, 2), (0, 2.0, 2), (1, 1.0, 2),
                         (1, 0.5, 2), (1, 0.25, 5)]:
        fg[0], fg[2] = st, 7
        krylov_ctl.ir_ctl(mode, a, t(rn, f64), fg, c1)
        krylov_ctl.ir_ctl_plain(mode, b, t(rn, f64), fg, c2)
        e, sm = _max_err(a, b)
        err, same = max(err, e), same and sm and torch.equal(
            c1.pred, c2.pred) and torch.equal(c1.counts, c2.counts)
    results[("ir_ctl", f64)] = (err, same)
    w = ir_state()
    w.sc[3] = 1e9
    rn = t(1.0, f64)
    krylov_ctl.ir_ctl(0, w, t(2.0, f64), fg, c)
    ms = _graph_ms([lambda: krylov_ctl.ir_ctl(1, w, rn, fg, c)] * CTL_REPS)
    plain_ms = _events_ms([lambda: krylov_ctl.ir_ctl_plain(1, w, rn, fg, c)]
                          * 5)
    # read: rn, the inner state and its, rnorm0, rnorm, rtol, n_rounds,
    # ints; write: rnorm, hist[rounds], ints, the predicate, a counter
    out["ir_ctl"] = (ms, plain_ms) + _ctl_bound(
        8 * (1 + 4 + 1 + 1) + 4 * (2 + 5 + 5) + 4 + 8, 2, f64)
    torch.cuda.synchronize()
    for (name, dt), (err, same) in results.items():
        log(f"[ctl] {name} {str(dt)[6:]}: max_abs_err {err:.3e} against "
            f"its twin, bitwise {same}")
        check(same, f"{name} {dt} is not bitwise its twin")
    res = {}
    for name, _ in CTL_KERNELS:
        ms, plain_ms, bound_ms, bound_by = out[name]
        err = max(e for (n, _), (e, _) in results.items() if n == name)
        log(f"[ctl] {name}: kernel {1e3 * ms:.2f} us per launch, twin "
            f"{plain_ms:.3f} ms, bound {bound_ms:.3e} ms ({bound_by}; one "
            f"launch's bytes and operations)")
        res[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None}
    return res


# K4 against its twin, relative to max_k sum_{s,j} |W||x| (the kernel sums
# slot by slot in the JAX package's order, the twin in torch's)
K4_TOL = {torch.float32: 1e-5, torch.float64: 1e-13}
MG_REPS = 50


# the card's L2 (50 MB on an H100): a cold timing cycles the inputs through
# copies that move 3x this much between two uses of one copy
L2_BYTES = 50e6


def _cold_copies(tensors, nbytes):
    """Copies of `tensors` (at least 2), so many that cycling through them
    moves 3x the card's L2 between two uses of one copy (nbytes: what one
    call moves): each call then reads its inputs from HBM."""
    n = max(2, -(-int(3 * L2_BYTES) // int(nbytes)))
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def _mg_times(kernel, plain, args, nbytes):
    """Device ms per call of kernel(*args) and of its twin plain(*args),
    each captured as one CUDA graph and replayed (as the main path runs
    them): hot, MG_REPS calls on one input, which stays in the L2 when it
    fits (as across one level's smoothing sweep, which applies one W back
    to back); cold, at least MG_REPS calls cycling through _cold_copies
    of args. Returns (hot, cold, copies): hot and cold (kernel, twin)."""
    hot = tuple(_graph_ms([lambda f=f: f(*args)] * MG_REPS)
                for f in (kernel, plain))
    copies = _cold_copies(args, nbytes)
    reps = -(-MG_REPS // len(copies))
    cold = tuple(_graph_ms([lambda f=f, c=c: f(*c) for c in copies] * reps)
                 for f in (kernel, plain))
    return hot, cold, len(copies)


def _cheb_scalars(emin, emax, npdt=np.float64):
    """The Chebyshev smoother's first-step scale and omega in the working
    numpy dtype, as treeops.cheb_smooth computes them."""
    lo, hi = npdt(emin), npdt(emax)
    scale = npdt(2.0) / (hi + lo)
    alpha_ = 1.0 - scale * lo
    mu, omegaprod = 1.0 / alpha_, 2.0 / alpha_
    return float(scale), float(omegaprod * mu / (2.0 * mu * mu - 1.0))


# K5's forms: (kernel, form) as the kernels line names them; a kernel's
# launches count every form of it
K5_KERNELS = {"prolong_parity": ("prolong_parity", "prolong_parity_add"),
              "restrict_parity": ("restrict_parity",
                                  "restrict_parity_residual",
                                  "restrict_parity_residual_cheb_first",
                                  "restrict_parity_weighted_residual"),
              "prolong_grid": ("prolong_grid", "prolong_grid_add"),
              "restrict_grid": ("restrict_grid", "restrict_grid_cheb_first")}
K5_FUSED = ("prolong_parity_add", "restrict_parity_residual",
            "restrict_parity_residual_cheb_first",
            "restrict_parity_weighted_residual", "prolong_grid_add",
            "restrict_grid_cheb_first")
# the fused form only the cart V-cycle runs (its ownership-weighted
# residual); the single-device path runs every other form but K5_NONE
K5_CART = ("restrict_parity_weighted_residual",)
# the fused form no V-cycle of this script runs: the fine residual
# restricted without L-2's first Chebyshev step, which only a 2-level
# V-cycle takes (L-2 the coarse solve); held against its twin in phase
# mg_kernels, without a row in the kernels line
K5_NONE = ("restrict_parity_residual",)
# the JAX functions each K5 kernel replaces
K5_REPLACES = {"prolong_parity": "exsaddle_tpu/abf.py:110",
               "restrict_parity": "exsaddle_tpu/abf.py:132",
               "prolong_grid": "exsaddle_tpu/abf.py:150",
               "restrict_grid": "exsaddle_tpu/abf.py:171"}


def _k5_counts():
    """K5's launches so far: each kernel's (every form) and each fused
    form's, by the kernels line's names."""
    by = transfer.LAUNCHES.by
    out = {k: sum(by[f] for f in forms) for k, forms in K5_KERNELS.items()}
    out.update({f: by[f] for f in K5_FUSED})
    return out


def _k5_per_vcycle(k5, residuals, nlev):
    """K5 launches per V-cycle of a single-device solve: the V-cycles are
    its fused stencil residuals (one per stencil level, nlev - 2 of them)."""
    vcycles = residuals / (nlev - 2)
    return sum(k5[k] for k in K5_KERNELS) / vcycles, vcycles


def _check_k5_cheb_first(k5, vcycles, nlev, k6, where):
    """A V-cycle's grid restrictions into a smoothed level (nlev - 3 of
    them) are each restrict_grid_cheb_first, which computes that level's
    first pre-smoothing step in its store (one K6 launch fewer each), and
    the one into the coarse solve the plain form; logs K6's launches."""
    fused = k5["restrict_grid_cheb_first"]
    check(fused == (nlev - 3) * vcycles
          and k5["restrict_grid"] == (nlev - 2) * vcycles,
          f"{where}: {fused} restrict_grid_cheb_first of "
          f"{k5['restrict_grid']} grid restrictions in {vcycles:g} "
          f"V-cycles, expected {nlev - 3} and {nlev - 2} per V-cycle")
    log(f"[{where.split()[0]}] {where}: K6 {k6} launches, "
        f"{k6 / vcycles:.2f} per V-cycle; restrict_grid_cheb_first {fused} "
        f"({fused / vcycles:g} per V-cycle), each the K6 launch of a "
        f"zero-guess first step that is no longer made")


def _grid_ops(shape, nd, prolong):
    """The twin's operations of a grid transfer (axis by axis): a
    prolongation's odd slot 2 (add, scale), a restriction's odd fine value
    3 (scale, an add into each of its two coarse neighbours)."""
    shape, ops = list(shape), 0
    for a in range(len(shape)):
        rest = int(np.prod(shape[:a] + shape[a + 1:])) * nd
        if prolong:
            ops += 2 * (shape[a] - 1) * rest
            shape[a] = 2 * shape[a] - 1
        else:
            nc = (shape[a] + 1) // 2
            ops += 3 * (nc - 1) * rest
            shape[a] = nc
    return ops


def _k5_yardstick(kind, grid, nd, dtype):
    """(the library call, its argument) for a grid transfer: F.conv3d
    (restriction) or F.conv_transpose3d (prolongation) with the 3x3x3
    tensor-product weights [0.5, 1, 0.5], stride 2, padding 1, groups nd,
    on the grid permuted to (1, nd, z, y, x); and its output brought back
    to (z, y, x, nd). A yardstick only: the port never calls it."""
    F = torch.nn.functional
    w1 = torch.tensor([0.5, 1.0, 0.5], dtype=dtype, device=grid.device)
    w = (w1[:, None, None] * w1[None, :, None] * w1[None, None, :])
    w = w.expand(nd, 1, 3, 3, 3).contiguous()
    arg = grid.permute(3, 0, 1, 2).unsqueeze(0).contiguous()
    if kind == "prolong_grid":
        def lib(a):
            return F.conv_transpose3d(a, w, stride=2, padding=1, groups=nd)
    else:
        def lib(a):
            return F.conv3d(a, w, stride=2, padding=1, groups=nd)
    return lib, arg, lambda y: y[0].permute(1, 2, 3, 0)


def _outputs(y):
    """A K5 entry's outputs as a tuple (the fused restriction's two)."""
    return y if isinstance(y, tuple) else (y,)


def _k5_kernels(cfg, device, card, rng, l3, l2):
    """K5 (csrc/transfer.cu) at the mx=32 flagship's own shapes: the
    parity pair between the fine level and L-2, the grid pair between L-2
    and L-3 and between L-3 and the coarse grid, and the parity pair on
    one cart shard's local box of the 1x2x2 grid, in float32 and float64:
    every entry and fused form bit for bit its twin; device ms per call of
    kernel and twin, cold and hot (_mg_times); the grid pair's library
    yardstick (cuDNN convolutions, TF32 off) against the twin to TOL and
    timed likewise; the bound (bytes: each input read once, each output
    written once). restrict_grid_cheb_first runs at L-2 -> L-3 only, the
    one shape the V-cycles give it, with L-3's own inverse diagonal and
    Chebyshev bounds l3 = (d, (emin, emax)), and is also timed against the
    pair it replaces (restrict_grid, then K6's cheb_first);
    restrict_parity_residual_cheb_first likewise at fine -> L-2 with L-2's
    own diagonal and bounds l2 (against restrict_parity_residual, then
    K6's cheb_first). Returns the records by (form, case, dtype)."""
    from exsaddle_tpu_torch.parallel.cart_abf import _local_cls_shapes
    f32, f64 = torch.float32, torch.float64
    nd = cfg.ndim
    mloc = tuple(m // s for m, s in zip(cfg.m_el, (1, 2, 2)))
    grids = cfg.level_grids                  # coarse -> finer, reversed
    cases = [("fine <-> L-2", "parity", cfg.cls_shapes, cfg.m_el),
             ("cart shard", "parity", _local_cls_shapes(mloc, nd), mloc),
             ("L-2 <-> L-3", "grid", grids[1], grids[2]),
             ("L-3 <-> coarse", "grid", grids[0], grids[1])]
    res = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for case, kind, a, b in cases:
            for dtype in (f32, f64):
                size = torch.empty((), dtype=dtype).element_size()
                t = lambda v: torch.as_tensor(  # noqa: E731
                    v, dtype=dtype, device=device)
                if kind == "parity":
                    cls, m_el = a, b
                    cshape = tuple(m + 1 for m in reversed(m_el))
                    n = sum(int(np.prod(c)) for c in cls) * nd
                    xc = t(rng.standard_normal(cshape + (nd,)))
                    x, bb, y = (t(rng.standard_normal(n)) for _ in range(3))
                    # ownership weights as the cart path holds them
                    wt = t(0.5 ** rng.integers(0, 4, n))
                    nc = xc.numel()
                    terms = sum(int(np.prod(c)) * nd * 2 ** bin(p).count("1")
                                for p, c in enumerate(cls))
                    forms = {
                        "prolong_parity": (
                            lambda v: transfer.prolong_parity(v, cls, m_el),
                            lambda v: transfer.prolong_parity_plain(
                                v, cls, m_el), (xc,), nc + n, 2 * terms),
                        "prolong_parity_add": (
                            lambda v, q: transfer.prolong_parity(
                                v, cls, m_el, add=q),
                            lambda v, q: transfer.prolong_parity_plain(
                                v, cls, m_el) + q, (xc, x), nc + 2 * n,
                            2 * terms + n),
                        "restrict_parity": (
                            lambda v: transfer.restrict_parity(v, cls, m_el),
                            lambda v: transfer.restrict_parity_plain(
                                v, cls, m_el), (bb,), n + nc, 2 * terms),
                        "restrict_parity_residual": (
                            lambda v, q: transfer.restrict_parity_residual(
                                v, q, cls, m_el),
                            lambda v, q: transfer.restrict_parity_plain(
                                v - q, cls, m_el), (bb, y), 2 * n + nc,
                            2 * terms + n),
                        "restrict_parity_weighted_residual": (
                            lambda v, q, u:
                            transfer.restrict_parity_weighted_residual(
                                v, q, u, cls, m_el),
                            lambda v, q, u: transfer.restrict_parity_plain(
                                u * (v - q), cls, m_el), (bb, y, wt),
                            3 * n + nc, 2 * terms + 2 * n)}
                    if cshape + (nd,) == tuple(l2[0].shape):
                        # the V-cycle's restriction into L-2: reads b, y
                        # and d, writes b2 and p1; the first step's 3
                        # operations per coarse value beside the
                        # restriction's
                        npdt = np.float32 if dtype == f32 else np.float64
                        dg = t(l2[0])
                        sc2 = float(treeops.cheb_scale(*map(npdt, l2[1])))

                        def ppair(v, q, dd, cls=cls, m_el=m_el, sc2=sc2):
                            bc = transfer.restrict_parity_residual(
                                v, q, cls, m_el)
                            return bc, cheb.cheb_first(
                                bc, None, dd, torch.zeros_like(bc), sc2)
                        forms["restrict_parity_residual_cheb_first"] = (
                            lambda v, q, dd, cls=cls, m_el=m_el, sc2=sc2:
                            transfer.restrict_parity_residual_cheb_first(
                                v, q, cls, m_el, dd, sc2),
                            lambda v, q, dd, cls=cls, m_el=m_el, sc2=sc2:
                            transfer.restrict_parity_residual_cheb_first_plain(
                                v, q, cls, m_el, dd, sc2), (bb, y, dg),
                            2 * n + 3 * nc, 2 * terms + n + 3 * nc)
                    shapes = f"{cshape} <-> {n} values"
                else:
                    coarse, fine = a, b
                    xc = t(rng.standard_normal(coarse + (nd,)))
                    xf, x = (t(rng.standard_normal(fine + (nd,)))
                             for _ in range(2))
                    nc, nf = xc.numel(), xf.numel()
                    pops = _grid_ops(coarse, nd, True)
                    forms = {
                        "prolong_grid": (
                            lambda v: transfer.prolong_grid(v, fine),
                            lambda v: transfer.prolong_grid_plain(v, fine),
                            (xc,), nc + nf, pops),
                        "prolong_grid_add": (
                            lambda v, q: transfer.prolong_grid(v, fine,
                                                               add=q),
                            lambda v, q: q + transfer.prolong_grid_plain(
                                v, fine), (xc, x), nc + 2 * nf, pops + nf),
                        "restrict_grid": (
                            lambda v: transfer.restrict_grid(v, coarse),
                            lambda v: transfer.restrict_grid_plain(
                                v, coarse), (xf,), nf + nc,
                            _grid_ops(fine, nd, False))}
                    if coarse == tuple(l3[0].shape[:-1]):
                        # the V-cycles' restriction into L-3: reads rf and
                        # d, writes b and p1; the first step's 3 operations
                        # per value beside the restriction's
                        npdt = np.float32 if dtype == f32 else np.float64
                        dg = t(l3[0])
                        scale = float(treeops.cheb_scale(*map(npdt, l3[1])))

                        def pair(v, dd, coarse=coarse, scale=scale):
                            bc = transfer.restrict_grid(v, coarse)
                            return bc, cheb.cheb_first(
                                bc, None, dd, torch.zeros_like(bc), scale)
                        forms["restrict_grid_cheb_first"] = (
                            lambda v, dd: transfer.restrict_grid_cheb_first(
                                v, coarse, dd, scale),
                            lambda v, dd:
                            transfer.restrict_grid_cheb_first_plain(
                                v, coarse, dd, scale), (xf, dg),
                            nf + 3 * nc,
                            _grid_ops(fine, nd, False) + 3 * nc)
                    shapes = f"{fine} <-> {coarse} nodes x {nd}"
                for form, (kern, twin, args, nval, nops) in forms.items():
                    got, want = _outputs(kern(*args)), _outputs(twin(*args))
                    torch.cuda.synchronize()
                    err = max(float((g - w).abs().max())
                              for g, w in zip(got, want))
                    check(all(_same_bits(g, w) for g, w in zip(got, want)),
                          f"K5 {form} {case} {dtype}: not bitwise its twin "
                          f"(max_abs_err {err:.3e})")
                    want = want[0]
                    nbytes = size * nval
                    (ms_hot, plain_hot), (ms, plain_ms), ncp = _mg_times(
                        kern, twin, args, nbytes)
                    bound_ms, bound_by = _ctl_bound(nbytes, nops, dtype)
                    rec = {"max_abs_err": err, "ms": ms, "hot_ms": ms_hot,
                           "plain_ms": plain_ms, "plain_hot_ms": plain_hot,
                           "bound_ms": bound_ms, "bound_by": bound_by,
                           "library_ms": None, "cold_copies": ncp}
                    lib_line = ("library null (no PyTorch call computes "
                                + ("the parity layout)" if kind == "parity"
                                   else "the fused form)"))
                    if form in ("prolong_grid", "restrict_grid"):
                        lib, larg, back = _k5_yardstick(form, args[0], nd,
                                                        dtype)
                        lib_err = float((back(lib(larg)) - want).abs().max())
                        mag = float(want.abs().max())
                        check(lib_err <= TOL[dtype] * mag,
                              f"K5 {form} {case} {dtype}: the convolution "
                              f"yardstick is off by {lib_err:.3e}")
                        lib_hot = _graph_ms([lambda: lib(larg)] * MG_REPS)
                        lcp = _cold_copies((larg,), nbytes)
                        lib_ms = _graph_ms(
                            [lambda c=c: lib(c[0]) for c in lcp]
                            * -(-MG_REPS // len(lcp)))
                        rec.update(library_ms=lib_ms, library_hot_ms=lib_hot,
                                   library_err=lib_err)
                        call = ("F.conv_transpose3d" if form ==
                                "prolong_grid" else "F.conv3d")
                        lib_line = (f"library ({call}, "
                                    f"groups {nd}, off by {lib_err:.3e} of "
                                    f"max {mag:.3e}) {1e3 * lib_ms:.2f} / "
                                    f"{1e3 * lib_hot:.2f} us cold / hot")
                    if form in ("restrict_grid_cheb_first",
                                "restrict_parity_residual_cheb_first"):
                        unfused = form[:-len("_cheb_first")]
                        fpair = (pair if form == "restrict_grid_cheb_first"
                                 else ppair)
                        g, q = _outputs(fpair(*args)), _outputs(kern(*args))
                        torch.cuda.synchronize()
                        check(all(_same_bits(u, v) for u, v in zip(g, q)),
                              f"K5 {form} {case} {dtype}: not bitwise "
                              f"{unfused} followed by K6's cheb_first")
                        (p_hot, _), (p_cold, _), _ = _mg_times(
                            fpair, fpair, args, nbytes)
                        rec.update(pair_ms=p_cold, pair_hot_ms=p_hot)
                        lib_line += (f"; the {unfused} + K6 cheb_first "
                                     f"pair it replaces (bitwise) "
                                     f"{1e3 * p_cold:.2f} / "
                                     f"{1e3 * p_hot:.2f} us cold / hot")
                    log(f"[mg_kernels] K5 {form} {case} {shapes} "
                        f"{str(dtype)[6:]}: bitwise its twin; per launch in "
                        f"a graph {1e3 * ms:.2f} us cold (inputs cycled "
                        f"through {ncp} copies), {1e3 * ms_hot:.2f} us hot; "
                        f"twin {1e3 * plain_ms:.2f} / {1e3 * plain_hot:.2f} "
                        f"us cold / hot; {lib_line}; bound "
                        f"{1e3 * bound_ms:.3f} us ({bound_by}: "
                        f"{nbytes / 1e6:.2f} MB), kernel at "
                        f"{100 * bound_ms / ms:.1f}% of it cold, "
                        f"{100 * bound_ms / ms_hot:.1f}% hot ({card})")
                    res[(form, case, dtype)] = rec
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return res


# K3's forms: the plain apply (the cart path's, per shard), the step (the
# single-device p-block's); the JAX function each replaces
K3_REPLACES = {"mp_apply": "exsaddle_tpu/abf.py:92",
               "mp_cheb_step": "exsaddle_tpu/treeops.py:167"}
# each form's record in the kernels line: at the shape and dtype of the path
# that runs it (the cart path's shard box in float64, the flagship's p size
# in float32)
K3_CASE = {"mp_apply": ("cart shard", torch.float64),
           "mp_cheb_step": ("p size", torch.float32)}


def _k3_plain(op, pscale, W, pg):
    return mp.mp_apply_plain(op, pscale, pg)


def _k3_plain_step(op, pscale, W, b, p_k, p_km1, d, scale, omega):
    return cheb.cheb_step(b, mp.mp_apply_plain(op, pscale, p_k), d, p_k,
                          p_km1, scale, omega)


# the torch routing of K3's entries (the port's before K3 was a kernel):
# the plain apply (the ~13 launches of mp_apply_plain, on the factored
# form), then K6 (looked up at each call); a caller swaps them in before a
# solver is built, as the order witness does
K3_PARENT = {"mp_apply": _k3_plain, "mp_cheb_step": _k3_plain_step}


def _mp_csr(op, pscale):
    """The assembled Mpscaled (tabf.mp_csr of the working-precision Np and
    pscale, in float64) as an int32 CSR tensor in pscale's dtype and on
    its device: the library yardstick's operand, and (tabf.mp_stencil)
    K3's stencil. Returns (CSR tensor, nnz, stencil W)."""
    A = tabf.mp_csr(op.Np.double().cpu().numpy(),
                    pscale.double().cpu().numpy(), op.m_el)
    dev, dt = pscale.device, pscale.dtype
    W = torch.as_tensor(tabf.mp_stencil(A, op.nn_p), dtype=dt, device=dev)
    return torch.sparse_csr_tensor(
        torch.as_tensor(A.indptr, dtype=torch.int32),
        torch.as_tensor(A.indices, dtype=torch.int32),
        torch.as_tensor(A.data, dtype=dt), A.shape, device=dev), A.nnz, W


def _k3_kernels(data, device, card, rng):
    """K3 (csrc/mp_apply.cu: Mpscaled's node stencil W, assembled in
    float64 from the box's pscale and Np and rounded once, as the setup
    builds it) at the mx=32 flagship's p size (33^3 nodes, 32,768
    elements) on its own pscale, Np, Jacobi diagonal and Chebyshev
    bounds, float32 and float64, and its plain form on one cart shard's
    box of the 1x2x2 grid (32 x 16 x 16 elements, the flagship's pscale
    rows of that box), float64: the plain form within K4_TOL of the plain
    apply over absolute values (mp_apply_plain: gather, two GEMMs,
    scatter, on the factored form), bitwise repeatable; the step form
    bitwise its twin (the plain kernel, then K6) and MpOp's forms the
    entries. Device ms per call, cold and hot (_mg_times: the vectors
    cycled, W held as the p-block's steps hold it), of the kernel, its
    twin (the plain form's: mp_apply_plain) and the launches the form
    replaces on the torch routing (mp_apply_plain, then K6's update); the
    library yardstick (cuSPARSE CSR SpMV of the assembled Mpscaled,
    int32; CUDA events, cold and hot, as K4's); the bound (the least
    bytes of the same work, the factored form's: pscale, Np and each node
    vector once; operations: the element products, the node sums and the
    update), beside the stencil's own bytes. Returns the records by
    (form, case, dtype)."""
    from types import SimpleNamespace
    f32, f64 = torch.float32, torch.float64
    op = data["op"]
    emin, emax = (float(b) for b in data["p_bounds"])
    nq, nc = op.Np.shape
    mloc = tuple(m // s for m, s in zip(op.m_el, (1, 2, 2)))
    # (case, m_el, dtype, forms)
    cases = [("p size", tuple(op.m_el), f32, mp.FORMS),
             ("p size", tuple(op.m_el), f64, mp.FORMS),
             ("cart shard", mloc, f64, ("mp_apply",))]
    res = {}
    for case, m_el, dtype, case_forms in cases:
        nn = tuple(m + 1 for m in m_el)
        grid = tuple(reversed(nn))
        nel, nodes = int(np.prod(m_el)), int(np.prod(grid))
        scale, omega = _cheb_scalars(emin, emax, treeops.NP_DTYPE[dtype])
        kop = SimpleNamespace(m_el=m_el, nn_p=nn,
                              Np=op.Np.to(dtype).contiguous())
        aop = SimpleNamespace(m_el=m_el, nn_p=nn, Np=kop.Np.abs())
        # the box's pscale rows: elements z, y, x with x fastest
        ps = data["pscale"].reshape(*reversed(op.m_el), nq)[
            :m_el[2], :m_el[1], :m_el[0]].reshape(nel, nq).to(
                dtype).contiguous()
        t = lambda a: torch.as_tensor(a, dtype=dtype,  # noqa: E731
                                      device=device)
        x, b, q = (t(rng.standard_normal(grid)) for _ in range(3))
        d = t(rng.uniform(0.5, 1.5, grid)) if case == "cart shard" else (
            data["inv_diag_p"].to(dtype).contiguous())
        csr, nnz, W = _mp_csr(kop, ps)
        y = mp.mp_apply(kop, ps, W, x)
        yp = mp.mp_apply_plain(kop, ps, x)
        mag = float(mp.mp_apply_plain(aop, ps.abs(), x.abs()).max())
        torch.cuda.synchronize()
        err = float((y - yp).abs().max())
        check(bool(torch.isfinite(y).all()) and err <= K4_TOL[dtype] * mag,
              f"K3 {case} {dtype}: max_abs_err {err:.3e} > "
              f"{K4_TOL[dtype]:g} x {mag:.3e}")
        check(torch.equal(mp.mp_apply(kop, ps, W, x), y),
              f"K3 {case} {dtype}: repeated applies differ")
        step = mp.mp_cheb_step(kop, ps, W, b, x, q, d, scale, omega)
        twin = mp.TWINS["mp_cheb_step"](kop, ps, W, b, x, q, d, scale,
                                        omega)
        via = mp.MpOp(kop, ps, W).cheb_step(b, x, q, d, scale, omega)
        torch.cuda.synchronize()
        check(_same_bits(step, twin) and _same_bits(via, step),
              f"K3 {case} {dtype}: the step form is not bitwise its twin "
              f"(the plain kernel, then K6)")
        xf = x.reshape(-1)
        lib_err = float((csr @ xf - yp.reshape(-1)).abs().max())
        check(lib_err <= 1e3 * K4_TOL[dtype] * mag,
              f"K3 {case} {dtype}: CSR yardstick off by {lib_err:.3e}")
        size = ps.element_size()
        lib_bytes = nnz * (size + 4) + 2 * nodes * size
        # as K4's yardstick: CUDA events around calls issued from Python
        lib_hot = _median_ms(lambda: csr @ xf)
        lcp = _cold_copies((csr,), lib_bytes)
        lib_ms = _events_ms([lambda c=c: c[0] @ xf for c in lcp]
                            * -(-MG_REPS // len(lcp)))
        # (kernel, twin, the parent's launches (None: the twin is them),
        # args, node vectors moved, update operations per node)
        forms = {
            "mp_apply": (lambda v: mp.mp_apply(kop, ps, W, v),
                         lambda v: mp.mp_apply_plain(kop, ps, v), None,
                         (x,), 2, 0),
            "mp_cheb_step": (
                lambda v, bb, qq, dd: mp.mp_cheb_step(
                    kop, ps, W, bb, v, qq, dd, scale, omega),
                lambda v, bb, qq, dd: mp.TWINS["mp_cheb_step"](
                    kop, ps, W, bb, v, qq, dd, scale, omega),
                lambda v, bb, qq, dd: _k3_plain_step(
                    kop, ps, W, bb, v, qq, dd, scale, omega), (x, b, q, d),
                5, 7)}
        for form in case_forms:
            kern, twin, parent, args, nvec, nupd = forms[form]
            nbytes = size * (ps.numel() + kop.Np.numel() + nvec * nodes)
            wbytes = size * (W.numel() + nvec * nodes)
            nops = nel * (4 * nq * nc + nq) + nodes * (nc + nupd)
            (ms_hot, tw_hot), (ms, tw_ms), ncp = _mg_times(kern, twin, args,
                                                           nbytes)
            pa_hot, pa_ms = tw_hot, tw_ms
            if parent is not None:
                (_, pa_hot), (_, pa_ms), _ = _mg_times(kern, parent, args,
                                                       nbytes)
            bound_ms, bound_by = _ctl_bound(nbytes, nops, dtype)
            rec = {"max_abs_err": err if form == "mp_apply" else 0.0,
                   "ms": ms, "hot_ms": ms_hot, "plain_ms": tw_ms,
                   "plain_hot_ms": tw_hot, "parent_ms": pa_ms,
                   "parent_hot_ms": pa_hot, "bound_ms": bound_ms,
                   "bound_by": bound_by,
                   "library_ms": lib_ms if form == "mp_apply" else None,
                   "cold_copies": ncp, "shape": list(m_el),
                   "stencil_bytes": wbytes}
            lib_line = ("library null (no PyTorch call computes the fused "
                        "form)")
            if form == "mp_apply":
                rec.update(library_hot_ms=lib_hot, library_nnz=nnz,
                           library_err=lib_err)
                lib_line = (f"library (CSR SpMV of the assembled Mpscaled, "
                            f"{nnz} nnz, int32, off by {lib_err:.3e}) "
                            f"{1e3 * lib_ms:.2f} / {1e3 * lib_hot:.2f} us "
                            f"cold / hot")
            log(f"[mg_kernels] K3 {form} {case} {grid} ({nel} elements) "
                f"{str(dtype)[6:]}: "
                + (f"max_abs_err {err:.3e} ({err / mag:.3e} of the apply "
                   f"over absolute values, tol {K4_TOL[dtype]:g}), bitwise "
                   f"repeatable" if form == "mp_apply" else
                   "bitwise its twin (the plain kernel, then K6)")
                + f"; per launch in a graph {1e3 * ms:.2f} us cold (inputs "
                f"cycled through {ncp} copies), {1e3 * ms_hot:.2f} us hot; "
                f"twin {1e3 * tw_ms:.2f} / {1e3 * tw_hot:.2f} us cold / hot; "
                f"the torch routing it replaces (mp_apply_plain"
                f"{'' if form == 'mp_apply' else ', then K6'}) "
                f"{1e3 * pa_ms:.2f} / {1e3 * pa_hot:.2f} us; {lib_line}; "
                f"bound {1e3 * bound_ms:.3f} us ({bound_by}, the factored "
                f"form's: {nbytes / 1e6:.2f} MB, {nops / 1e6:.1f} MFLOP; "
                f"the stencil's own bytes {wbytes / 1e6:.2f} MB take "
                f"{1e3 * wbytes / PEAK_BYTES:.3f} us), kernel at "
                f"{100 * bound_ms / ms:.1f}% of it cold, "
                f"{100 * bound_ms / ms_hot:.1f}% hot ({card})")
            res[(form, case, dtype)] = rec
        del csr, lcp
    return res


def phase_mg_kernels(device, card):
    """K4 (the block stencil, csrc/stencil_apply.cu) on the mx=32
    flagship's own L-2 and L-3 stencils (zero-boundary form, as the
    single-device V-cycle applies them) and on one cart shard's L-2
    stencil (the 17 x 17 x 33 slab of the 1x2x2 grid, padded form, as the
    cart path applies it), and K6 (the Chebyshev update,
    csrc/cheb_update.cu) at the fine, L-2 and p sizes with the flagship's
    Jacobi diagonals, in float32 and float64, against their plain twins:
    K4 within K4_TOL and bitwise repeatable, its two forms bitwise equal,
    each fused epilogue bitwise K4 followed by K6 or the subtraction, K6
    bit for bit its twin. Device ms per call of kernel and twin, cold and
    hot (_mg_times), the kernel's issued one by one from Python (CUDA
    events; the ctypes wrapper's host time bounds it), K4's library
    yardstick (cuSPARSE CSR SpMV of csr_from_stencil(W), int32 indices;
    CUDA events, cold and hot), the bound; the fused Chebyshev step
    against its twin and against the K4 + K6 pair it replaces (cold and
    hot). Then K3 at the p size (_k3_kernels) and K5 (_k5_kernels).
    Returns the float32 L-2 numbers of K4, of each fused entry and of K6's
    fine-level step, K5's and K3's by form at the shapes of the path that
    runs each (K3_CASE)."""
    f32, f64 = torch.float32, torch.float64
    t0 = time.perf_counter()
    p = bench._build_problem(32)
    cfg, data, setup = tabf.build_abf(p["mesh"], p["fes"], p["coeff"],
                                      p["bc_idx"], p["bc_vals"],
                                      device=device, dtype=f64, nlevels=4)
    log(f"[mg_kernels] mx=32 flagship ABF setup (4 levels, float64) "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(12)
    res = {}
    W2, d2 = setup["stencils_w"][1], data["inv_diag_lvls"][1]
    # (name, W, inverse diagonal, Chebyshev bounds, padded form)
    cases = [("L-2", W2, d2, data["bounds"][1], False),
             ("L-3", setup["stencils_w"][0], data["inv_diag_lvls"][0],
              data["bounds"][0], False),
             ("cart L-2 shard", np.ascontiguousarray(W2[:17, :17]),
              d2[:17, :17], data["bounds"][1], True)]
    for lvl, Wn, dl, (emin, emax), padded in cases:
        grid, nd = Wn.shape[:3], Wn.shape[-1]
        A = tabf.csr_from_stencil(Wn, grid, nd)
        x64 = rng.standard_normal(grid + (nd,))
        form = "padded" if padded else "zero-boundary"
        for dtype in (f32, f64):
            W = torch.as_tensor(Wn, dtype=dtype, device=device)
            x = torch.as_tensor(x64, dtype=dtype, device=device)
            xp = stencil._pad(x)
            xin = xp if padded else x
            apply = stencil.stencil_accum if padded else stencil.stencil_apply
            twin = stencil.TWINS["stencil_accum" if padded
                                 else "stencil_apply"]
            y = apply(W, xin)
            yp = stencil.stencil_accum_plain(W, xp)
            mag = float(stencil.stencil_accum_plain(W.abs(), xp.abs()).max())
            err = float((y - yp).abs().max())
            check(bool(torch.isfinite(y).all())
                  and err <= K4_TOL[dtype] * mag,
                  f"K4 {lvl} {dtype}: max_abs_err {err:.3e} > "
                  f"{K4_TOL[dtype]:g} x {mag:.3e}")
            check(torch.equal(apply(W, xin), y),
                  f"K4 {lvl} {dtype}: repeated applies differ")
            check(_same_bits(stencil.stencil_accum(W, xp),
                             stencil.stencil_apply(W, x)),
                  f"K4 {lvl} {dtype}: the padded and zero-boundary forms "
                  f"differ")
            # each epilogue against K4 followed by K6 / the subtraction
            scale, omega = _cheb_scalars(emin, emax, treeops.NP_DTYPE[dtype])
            d = dl.to(dtype).contiguous()
            b, q = (torch.as_tensor(rng.standard_normal(grid + (nd,)),
                                    dtype=dtype, device=device)
                    for _ in range(2))
            fused = {
                "residual": (lambda W, v, x, b, d, q: stencil.stencil_residual(
                    W, v, b, padded=padded),
                    lambda W, v, x, b, d, q: b - apply(W, v)),
                "cheb_first": (lambda W, v, x, b, d, q:
                               stencil.stencil_cheb_first(
                                   W, v, b, d, scale, padded=padded),
                               lambda W, v, x, b, d, q: cheb.cheb_first(
                                   b, apply(W, v), d, x, scale)),
                "cheb_step": (lambda W, v, x, b, d, q:
                              stencil.stencil_cheb_step(
                                  W, v, b, d, q, scale, omega, padded=padded),
                              lambda W, v, x, b, d, q: cheb.cheb_step(
                                  b, apply(W, v), d, x, q, scale, omega))}
            args = (W, xin, x, b, d, q)
            for e, (fn, pair) in fused.items():
                check(_same_bits(fn(*args), pair(*args)),
                      f"K4 {lvl} {dtype}: the fused {e} is not bitwise K4 "
                      f"followed by {'the subtraction' if e == 'residual' else 'K6'}")
            csr = torch.sparse_csr_tensor(
                torch.as_tensor(A.indptr, dtype=torch.int32),
                torch.as_tensor(A.indices, dtype=torch.int32),
                torch.as_tensor(A.data, dtype=dtype), A.shape,
                device=device)
            xf = x.reshape(-1)
            lib_err = float((csr @ xf - yp.reshape(-1)).abs().max())
            check(lib_err <= 1e3 * K4_TOL[dtype] * mag,
                  f"K4 {lvl} {dtype}: CSR yardstick off by {lib_err:.3e}")
            size = W.element_size()
            nbytes = size * (W.numel() + xin.numel() + y.numel())
            (ms_hot, plain_hot), (ms, plain_ms), ncp = _mg_times(
                apply, twin, (W, xin), nbytes)
            eager_ms = _median_ms(lambda: apply(W, xin))
            library_hot = _median_ms(lambda: csr @ xf)
            csrs = _cold_copies((csr,), A.nnz * (size + 4))
            library_ms = _events_ms([lambda c=c: c[0] @ xf for c in csrs]
                                    * -(-MG_REPS // len(csrs)))
            bound_ms, bound_by = _ctl_bound(nbytes, 2 * W.numel(), dtype)
            log(f"[mg_kernels] K4 {lvl} {tuple(grid)} nd {nd} "
                f"{str(dtype)[6:]} ({form} form): max_abs_err {err:.3e} "
                f"({err / mag:.3e} of max sum |W||x|, tol "
                f"{K4_TOL[dtype]:g}), bitwise repeatable, padded and "
                f"zero-boundary forms bitwise equal, every fused epilogue "
                f"bitwise K4 + K6 / the subtraction; kernel per apply in a "
                f"graph {1e3 * ms:.2f} us cold (inputs cycled through {ncp} "
                f"copies), {1e3 * ms_hot:.2f} us hot (one input"
                f"{', W stays in the 50 MB L2' if nbytes < L2_BYTES else ''})"
                f", {1e3 * eager_ms:.2f} us issued from Python; twin "
                f"{1e3 * plain_ms:.2f} / {1e3 * plain_hot:.2f} us cold / hot;"
                f" library (CSR SpMV, {A.nnz} nnz) {1e3 * library_ms:.2f} / "
                f"{1e3 * library_hot:.2f} us cold / hot; HBM bound "
                f"{1e3 * bound_ms:.2f} us ({bound_by}: {nbytes / 1e6:.1f} "
                f"MB), kernel at {100 * bound_ms / ms:.1f}% of it cold, "
                f"{100 * bound_ms / ms_hot:.1f}% hot ({card})")
            res[("K4", lvl, dtype)] = {
                "max_abs_err": err, "ms": ms, "hot_ms": ms_hot,
                "plain_ms": plain_ms, "plain_hot_ms": plain_hot,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms, "library_hot_ms": library_hot,
                "cold_copies": ncp}
            # the fused entries against their twins (the unfused torch ops)
            # and, for the Chebyshev step, against the K4 + K6 pair
            vec = size * x.numel()
            for e in (stencil.EPILOGUES if (lvl, dtype) == ("L-2", f32)
                      else ("cheb_step",)):
                fn, pair = fused[e]
                nvec = {"residual": 1, "cheb_first": 2, "cheb_step": 3}[e]
                fbytes = nbytes + nvec * vec
                twin_e = stencil.TWINS["stencil_" + e]
                targs = {"residual": lambda W, v, x, b, d, q: twin_e(
                    W, v, b, padded=padded),
                    "cheb_first": lambda W, v, x, b, d, q: twin_e(
                        W, v, b, d, scale, padded=padded),
                    "cheb_step": lambda W, v, x, b, d, q: twin_e(
                        W, v, b, d, q, scale, omega, padded=padded)}[e]
                (f_hot, t_hot), (f_ms, t_ms), ncp = _mg_times(
                    fn, targs, args, fbytes)
                fb_ms, fb_by = _ctl_bound(fbytes, 2 * W.numel(), dtype)
                line = (f"[mg_kernels] K4 fused {e} {lvl} {str(dtype)[6:]}: "
                        f"{1e3 * f_ms:.2f} us cold, {1e3 * f_hot:.2f} us "
                        f"hot per launch; twin {1e3 * t_ms:.2f} / "
                        f"{1e3 * t_hot:.2f} us cold / hot; bound "
                        f"{1e3 * fb_ms:.2f} us ({fb_by}: "
                        f"{fbytes / 1e6:.1f} MB)")
                rec = {"max_abs_err": 0.0, "ms": f_ms, "hot_ms": f_hot,
                       "plain_ms": t_ms, "plain_hot_ms": t_hot,
                       "bound_ms": fb_ms, "bound_by": fb_by,
                       "library_ms": None, "cold_copies": ncp}
                if e == "cheb_step":
                    (_, p_hot), (_, p_ms), _ = _mg_times(fn, pair, args,
                                                         fbytes)
                    line += (f"; the K4 + K6 pair it replaces "
                             f"{1e3 * p_ms:.2f} / {1e3 * p_hot:.2f} us cold "
                             f"/ hot")
                    rec.update(pair_ms=p_ms, pair_hot_ms=p_hot)
                log(line + f" ({card})")
                res[(e, lvl, dtype)] = rec
            del csr, csrs, W, x, xp, xin, y, yp, b, d, q, args
    diags = {"fine": data["inv_diag_fine"],
             "L-2": data["inv_diag_lvls"][-1], "p": data["inv_diag_p"]}
    bounds = {"fine": data["bounds"][-1], "L-2": data["bounds"][-2],
              "p": data["p_bounds"]}
    for lvl, d64 in diags.items():
        emin, emax = (float(b) for b in bounds[lvl])
        for dtype in (f32, f64):
            scale, omega = _cheb_scalars(emin, emax, treeops.NP_DTYPE[dtype])
            d = d64.to(dtype).contiguous()
            b, ap, pk, pkm1 = (torch.as_tensor(
                rng.standard_normal(tuple(d.shape)), dtype=dtype,
                device=device) for _ in range(4))
            pairs = [(cheb.cheb_first(b, None, d, pk, scale),
                      cheb.cheb_first_plain(b, None, d, pk, scale)),
                     (cheb.cheb_first(b, ap, d, pk, scale),
                      cheb.cheb_first_plain(b, ap, d, pk, scale)),
                     (cheb.cheb_step(b, ap, d, pk, pkm1, scale, omega),
                      cheb.cheb_step_plain(b, ap, d, pk, pkm1, scale,
                                           omega))]
            torch.cuda.synchronize()
            bits = torch.int32 if dtype == f32 else torch.int64
            same = all(torch.equal(a.view(bits), w.view(bits))
                       for a, w in pairs)
            err = max(float((a - w).abs().max()) for a, w in pairs)
            check(same, f"K6 {lvl} {dtype} is not bitwise its twin "
                  f"(max_abs_err {err:.3e})")
            n = d.numel()
            nbytes = 6 * n * d.element_size()
            (ms_hot, plain_hot), (ms, plain_ms), ncp = _mg_times(
                lambda *a: cheb.cheb_step(*a, scale, omega),
                lambda *a: cheb.cheb_step_plain(*a, scale, omega),
                (b, ap, d, pk, pkm1), nbytes)
            eager_ms = _median_ms(
                lambda: cheb.cheb_step(b, ap, d, pk, pkm1, scale, omega))
            bound_ms, bound_by = _ctl_bound(nbytes, 7 * n, dtype)
            log(f"[mg_kernels] K6 {lvl} ({n} values) {str(dtype)[6:]}: "
                f"first (r = b and r = b - A x0) and step bitwise their "
                f"twins; step per launch in a graph {1e3 * ms:.2f} us cold "
                f"(inputs cycled through {ncp} copies), {1e3 * ms_hot:.2f} "
                f"us hot (one input), {1e3 * eager_ms:.2f} us issued from "
                f"Python; twin {1e3 * plain_ms:.2f} / {1e3 * plain_hot:.2f} "
                f"us cold / hot; bound {1e3 * bound_ms:.2f} us ({bound_by}: "
                f"{nbytes / 1e6:.2f} MB), kernel at "
                f"{100 * bound_ms / ms:.1f}% of it cold, "
                f"{100 * bound_ms / ms_hot:.1f}% hot ({card})")
            res[("K6", lvl, dtype)] = {
                "max_abs_err": err, "ms": ms, "hot_ms": ms_hot,
                "plain_ms": plain_ms, "plain_hot_ms": plain_hot,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None, "cold_copies": ncp}
            if lvl == "L-2":
                continue
            # the zero-guess first step scale (d b) + 0, the one K6 launch
            # left on the single-device fine level and p-block
            z = torch.zeros_like(pk)
            fbytes = 4 * n * d.element_size()
            (f_hot, fp_hot), (f_ms, fp_ms), fcp = _mg_times(
                lambda bb, dd, zz: cheb.cheb_first(bb, None, dd, zz, scale),
                lambda bb, dd, zz: cheb.cheb_first_plain(bb, None, dd, zz,
                                                         scale),
                (b, d, z), fbytes)
            fb_ms, fb_by = _ctl_bound(fbytes, 3 * n, dtype)
            log(f"[mg_kernels] K6 zero-guess first step {lvl} ({n} values) "
                f"{str(dtype)[6:]}: per launch in a graph {1e3 * f_ms:.2f} "
                f"us cold (inputs cycled through {fcp} copies), "
                f"{1e3 * f_hot:.2f} us hot; twin {1e3 * fp_ms:.2f} / "
                f"{1e3 * fp_hot:.2f} us cold / hot; bound "
                f"{1e3 * fb_ms:.2f} us ({fb_by}: {fbytes / 1e6:.2f} MB), "
                f"kernel at {100 * fb_ms / f_ms:.1f}% of it cold ({card})")
            res[("K6", "fine", dtype)].update({
                f"first_{lvl}_ms": f_ms, f"first_{lvl}_hot_ms": f_hot,
                f"first_{lvl}_bound_ms": fb_ms})
    l3 = (data["inv_diag_lvls"][0].double().cpu().numpy(),
          tuple(float(b) for b in data["bounds"][0]))
    l2 = (data["inv_diag_lvls"][-1].double().cpu().numpy(),
          tuple(float(b) for b in data["bounds"][-2]))
    k3 = _k3_kernels(data, device, card, rng)
    del data, setup, diags
    k5 = _k5_kernels(cfg, device, card, rng, l3, l2)
    torch.cuda.empty_cache()
    # the kernels line's K5 entries: each form at the single-device main
    # path's float32 shape (the parity pair fine <-> L-2, the grid pair
    # L-2 <-> L-3), the cart path's own form at its float64 shard
    k5_case = {f: ("cart shard", f64) if f in K5_CART else
               ("fine <-> L-2" if "parity" in f else "L-2 <-> L-3", f32)
               for f in transfer.FORMS}
    return (res[("K4", "L-2", f32)],
            {e: res[(e, "L-2", f32)] for e in stencil.EPILOGUES},
            res[("K6", "fine", f32)],
            {f: k5[(f, *k5_case[f])] for f in transfer.FORMS},
            {f: k3[(f, *K3_CASE[f])] for f in mp.FORMS})


def phase_anchor():
    argv = tdriver.ABF_OPTS + ("-model 11 -size_x 0.1 -mx 6 "
                               "-saddle_ksp_converged_reason").split()
    r = tdriver.saddle_solve(Options.from_args(argv), 3, log=log)
    h0 = r["history"][0]
    log(f"[anchor] mx=6 direct float64: {r['reason']} in {r['its']} its, "
        f"history[0] {h0:.6g}, solve {r['seconds']['solve']:.3f} s")
    check(r["reason"] == "CONVERGED_RTOL", "anchor did not converge")
    check(r["its"] <= 20, f"anchor took {r['its']} > 20 iterations")
    check(abs(h0 - 0.00273569) / 0.00273569 < 1e-4,
          f"anchor initial residual {h0} != 0.00273569")


# phase main's timed IR solves over one setup, each kind first and last in
# turn: the device loop (one graph launch per solve), the host loop over
# captured bodies (loop="host") and eager=True (the host loop, every op
# issued from Python)
MAIN_ORDER = ("device", "host", "eager", "eager", "host", "device",
              "device", "host", "eager")


def _reset_launches():
    """Every kernel's launch count to 0: K1, K3, K4, K5, K6, the control
    kernels."""
    for k in (a00, mp, stencil, transfer, cheb, krylov_ctl):
        k.LAUNCHES.reset()


# K4's fused entries by the kernels line's names (each one launch of K4
# whose store computes the op that followed the apply)
FUSED = {e: "stencil_" + e for e in stencil.EPILOGUES}


def _mg_counts():
    """(K4 launches, K6 launches, then K4's fused launches by epilogue:
    residual, cheb_first, cheb_step)."""
    return (stencil.LAUNCHES.n, cheb.LAUNCHES.n) + tuple(
        stencil.LAUNCHES.fused[e] for e in stencil.EPILOGUES)


def _k4_twins():
    """(module, name, plain twin) of every K4 entry the solvers call (the
    zero-boundary apply, the padded apply, the fused residual and
    Chebyshev updates)."""
    return [(stencil, name, twin) for name, twin in stencil.TWINS.items()]


def _ir_solve(slv, F):
    """One IR solve to a true 1e-8 with its wall seconds, K1 launches,
    applies and factored applies, K4, K5 and K6 launches, control-kernel
    launches, graph launches and replays, and peak device memory
    (allocated, reserved)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    n0 = graphs.replays(slv.bodies())
    dev = slv._dev
    g0 = dev.graph.launches if dev is not None and dev.graph else 0
    t0 = time.perf_counter()
    res = slv.solve_ir(F, rtol=1e-8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"res": res, "wall": wall,
           "launches": a00.LAUNCHES.n, "applies": a00.LAUNCHES.applies,
           "factored": a00.LAUNCHES.factored,
           "a00_by": dict(a00.LAUNCHES.by), "k6_by": dict(cheb.LAUNCHES.by),
           "k3": dict(mp.LAUNCHES.by),
           "mg": _mg_counts(), "k5": _k5_counts(),
           "ctl": dict(krylov_ctl.LAUNCHES.n),
           "replays": graphs.replays(slv.bodies()) - n0,
           "graph_launches": (dev.graph.launches - g0
                              if dev is not None and dev.graph else 0),
           "peak": torch.cuda.max_memory_allocated() / 2 ** 30,
           "reserved": torch.cuda.max_memory_reserved() / 2 ** 30}
    if dev is not None:
        # executions of the loop bodies inside the solve, by counter slot
        out["bodies"] = int(dev.ctl.counts.sum())
    return out


def _same_ir(a, b):
    return (a["rounds"] == b["rounds"] and a["inner_its"] == b["inner_its"]
            and a["history"] == b["history"] and np.array_equal(a["x"], b["x"]))


def phase_main(card):
    """The driver on the flagship (its solver runs the device loop), then
    the three modes timed over one setup; returns the driver run's K1
    (launches, applies), K4 and K6 launches, control-kernel launches, K5
    launches, K1's by form and K3's by form."""
    argv = tdriver.ABF_OPTS + (
        "-model 11 -size_x 0.1 -mx 32 -ir -rtol_true 1e-8 "
        "-saddle_fieldsplit_u_pc_mg_levels 4 -saddle_ksp_monitor_short "
        "-saddle_ksp_converged_reason").split()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    r = tdriver.saddle_solve(Options.from_args(argv), 3, log=log)
    launches, applies = a00.LAUNCHES.n, a00.LAUNCHES.applies
    mg_launches = {"stencil_accum": stencil.LAUNCHES.n,
                   "cheb_update": cheb.LAUNCHES.n,
                   **{FUSED[e]: stencil.LAUNCHES.fused[e]
                      for e in stencil.EPILOGUES}}
    ctl_launches = dict(krylov_ctl.LAUNCHES.n)
    k5_launches = _k5_counts()
    a00_by = dict(a00.LAUNCHES.by)
    k3_by = dict(mp.LAUNCHES.by)
    res = r["res"]
    slv = r["solver"]
    graph = slv._dev.graph if slv._dev is not None else None
    log(f"[main] driver run: loop {r['loop']}, A00 kernels {launches} device "
        f"launches in {applies} applies (by form {a00_by}), K4 / K6 "
        f"{mg_launches}, K5 "
        f"{k5_launches}, K3 by form {k3_by}, control kernels {ctl_launches} "
        f"(capture warm-ups included); graph capture "
        f"{slv.capture_seconds:.3f} s, {len(graph.pieces) if graph else 0} "
        f"captured pieces, {graph.launches if graph else 0} graph launches")
    check(r["loop"] == "device" and graph is not None,
          "the driver's solver does not run the device loop")
    check(graph.launches == 1, f"the driver's solve made {graph.launches} "
          f"graph launches, expected 1")
    check(launches > 0, "the main path never launched the A00 kernel")
    check(all(n > 0 for n in mg_launches.values()),
          f"K4, a fused K4 entry or K6 never ran on the main path: "
          f"{mg_launches}")
    check(mg_launches["stencil_accum"] == sum(
        mg_launches[FUSED[e]] for e in stencil.EPILOGUES),
          f"an unfused K4 launch on the main path: {mg_launches}")
    check(all(n > 0 for k, n in k5_launches.items()
              if k not in K5_CART + K5_NONE)
          and not any(k5_launches[k] for k in K5_CART + K5_NONE),
          f"a K5 kernel or fused form never ran on the main path, or the "
          f"cart path's form or the unfused fine restriction ran there: "
          f"{k5_launches}")
    check(k3_by["mp_cheb_step"] > 0
          and not any(k3_by[f] for f in mp.FORMS if f != "mp_cheb_step"),
          f"K3's fused step never ran on the main path, or another K3 form "
          f"ran there: {k3_by}")
    check(all(ctl_launches[k] > 0 for k in krylov_ctl.NAMES),
          f"a control kernel never ran on the main path: {ctl_launches}")
    check(all(a00_by[f] > 0 for f in A00_FUSED[1:])
          and a00_by["a00_apply_keep"] == 0,
          f"a fused K1 form never ran on the main path, or the cart path's "
          f"keep-only form ran there: K1 applies by form {a00_by}")
    check(not res["stalled"], "iterative refinement stalled")
    check(res["converged"], "iterative refinement did not converge")
    check(np.all(np.isfinite(res["x"]))
          and res["x"].shape == (r["mesh"].ndof,),
          "solution not finite or of the wrong shape")
    # independent float64 true residual with the port's own operator
    op64, aux64 = slv.setup["op64"], tree_aux(slv.setup["op64"])
    F64 = slv.vec_to_tree(r["F"], dtype=torch.float64)

    def true_rel(x):
        x64 = slv.vec_to_tree(x, dtype=torch.float64)
        return float(torch.linalg.norm(F64 - mult_tree(op64, aux64, x64))
                     / torch.linalg.norm(F64))

    rel = true_rel(res["x"])
    log(f"[main] true float64 relative residual {rel:.3e}")
    check(rel <= 1e-8, f"true relative residual {rel} > 1e-8")

    # the three modes over the same setup, and the plain driver (the device
    # loop's steps from Python) that the graph is held against bitwise
    F = r["F"]
    kw = dict(device=slv.device, dtype=slv.dtype, ir=True)
    t0 = time.perf_counter()
    solvers = {"device": slv,
               "host": tabf.ABFSolver.from_parts(slv.cfg, slv.data, slv.setup,
                                                 loop="host", **kw),
               "eager": tabf.ABFSolver.from_parts(slv.cfg, slv.data,
                                                  slv.setup, eager=True,
                                                  **kw)}
    plain = tabf.ABFSolver.from_parts(slv.cfg, slv.data, slv.setup,
                                      loop="plain", **kw)
    log(f"[main] host-loop and eager solvers built in "
        f"{time.perf_counter() - t0:.2f} s")
    runs = {k: [] for k in solvers}
    for kind in MAIN_ORDER:
        rec = _ir_solve(solvers[kind], F)
        runs[kind].append(rec)
        check(rec["res"]["converged"] and not rec["res"]["stalled"],
              f"timed {kind} IR solve did not converge")
    # no host read inside a device-loop solve: the whole call under the
    # sync debug mode "error"
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        guarded = slv.solve_ir(F, rtol=1e-8)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    pl = _ir_solve(plain, F)
    first = {k: v[0]["res"] for k, v in runs.items()}
    for kind, recs in runs.items():
        check(all(_same_ir(q["res"], first[kind]) for q in recs),
              f"{kind}: repeated solves differ")
    check(_same_ir(guarded, first["device"]), "the solve under the sync "
          "debug mode differs")
    check(_same_ir(pl["res"], first["device"]), "the device-loop graph "
          "and the plain driver differ (x, history, rounds or inner its)")
    check(_same_ir(first["host"], first["eager"]), "the host loop over "
          "captured bodies and eager=True differ")
    check(_same_ir(first["host"], first["device"]), "the host loop (the "
          "device loop's window arithmetic on CUDA) and the device loop "
          "differ (x, history, rounds or inner its)")
    d, h, e = runs["device"][0], runs["host"][0], runs["eager"][0]
    check((d["launches"], d["applies"], d["mg"], d["k5"], d["ctl"], d["k3"])
          == (pl["launches"], pl["applies"], pl["mg"], pl["k5"], pl["ctl"],
              pl["k3"]),
          f"K1 / K4, K6 / K5 / control / K3 launches per solve: graph "
          f"{d['launches']} / {d['applies']} / {d['mg']} / {d['k5']} / "
          f"{d['ctl']} / {d['k3']}, plain driver {pl['launches']} / "
          f"{pl['applies']} / {pl['mg']} / {pl['k5']} / {pl['ctl']} / "
          f"{pl['k3']}")
    check((h["launches"], h["applies"], h["mg"], h["k5"], h["k3"])
          == (e["launches"], e["applies"], e["mg"], e["k5"], e["k3"]),
          f"K1, K4, K6, K5, K3 per solve: host loop {h['launches']} / "
          f"{h['applies']} / {h['mg']} / {h['k5']} / {h['k3']}, eager "
          f"{e['launches']} / {e['applies']} / {e['mg']} / {e['k5']} / "
          f"{e['k3']}")
    nlev = slv.cfg.nlevels
    per_vc, vcycles = _k5_per_vcycle(d["k5"], d["mg"][2], nlev)
    check(per_vc == 2 * (nlev - 1),
          f"K5: {per_vc} launches per V-cycle ({vcycles} V-cycles), "
          f"expected {2 * (nlev - 1)}")
    _check_k5_cheb_first(d["k5"], vcycles, nlev, d["mg"][1],
                         "main device-loop IR solve")
    check(d["graph_launches"] == 1 and d["replays"] == 0,
          f"device loop: {d['graph_launches']} graph launches per solve")
    _check_fine_fused(d, vcycles, slv.cfg, "main device-loop IR solve")
    _check_k3(d, vcycles, slv.cfg, "main device-loop IR solve")
    _fused_witness(slv, F, d, card)
    _k3_witness(slv, F, d, vcycles, card)
    for kind, res_k in first.items():
        its = res_k["inner_its"]
        check(res_k["rounds"] == 3 and 34 <= its <= 38,
              f"{kind}: IR took {res_k['rounds']} rounds / {its} inner its, "
              f"expected 3 / 34-38")
        rel = true_rel(res_k["x"])
        check(rel <= 1e-8, f"{kind}: true relative residual {rel} > 1e-8")
    fd, fh = first["device"], first["host"]
    log(f"[main] mx=32 ndof {r['mesh'].ndof}: setup "
        f"{r['seconds']['setup']:.2f} s (graph capture "
        f"{slv.capture_seconds:.3f} s), first solve "
        f"{r['seconds']['solve']:.3f} s; device loop bitwise the plain "
        f"driver (x, history, rounds {fd['rounds']}, inner its "
        f"{fd['inner_its']}, K1 and control launches) and the same under "
        f"the sync debug mode; host loop {fh['rounds']} rounds / "
        f"{fh['inner_its']} inner its, bitwise eager=True; rounds equal "
        f"{fd['rounds'] == fh['rounds']}, inner its equal "
        f"{fd['inner_its'] == fh['inner_its']}; true float64 relative "
        f"residual {true_rel(fd['x']):.3e} ({card})")
    for kind, recs in list(runs.items()) + [("plain", [pl])]:
        walls = [q["wall"] for q in recs]
        med = float(np.median(walls))
        q = recs[0]
        its = q["res"]["inner_its"]
        extra = (f", {q['bodies']} loop-body executions inside the graph"
                 if kind == "device" else "")
        log(f"[main] {kind}: median of {len(walls)} {med:.3f} s (spread "
            f"{min(walls):.3f}-{max(walls):.3f}), {1e3 * med / its:.2f} "
            f"ms/outer it, {q['res']['rounds']} rounds / {its} inner its, "
            f"K1 {q['launches']} launches in {q['applies']} applies per "
            f"solve, K4 / K6 {q['mg'][0]} / {q['mg'][1]} launches (K4 fused "
            f"residual / cheb_first / cheb_step {q['mg'][2]} / {q['mg'][3]} "
            f"/ {q['mg'][4]}), K5 {sum(q['k5'][k] for k in K5_KERNELS)} "
            f"launches ({_k5_per_vcycle(q['k5'], q['mg'][2], nlev)[0]:g} "
            f"per V-cycle: {q['k5']}), K3 {q['k3']}, control "
            f"kernels {sum(q['ctl'].values())}, "
            f"{q['graph_launches']} graph launches and {q['replays']} "
            f"captured-body replays per solve{extra}, peak mem "
            f"{max(x['peak'] for x in recs):.2f} GiB allocated, "
            f"{max(x['reserved'] for x in recs):.2f} GiB reserved ({card})")
    del solvers, plain, slv, r
    _main_witness(card)
    return (launches, applies, mg_launches, ctl_launches, k5_launches,
            a00_by, k3_by)


def _check_fine_fused(rec, vcycles, cfg, where):
    """A single-device V-cycle's fine level: the post-smooth's first step
    a00_cheb_first, every step after a first a00_cheb_step, the residual
    before the restriction a00_masked (GCR's operator too); no K1 keep
    form without an epilogue (the cart path's) and no masked K6 form."""
    by, k6 = rec["a00_by"], rec["k6_by"]
    pre = cfg.cheb_pre_its if cfg.cheb_pre_its > 0 else cfg.cheb_its
    steps = pre + cfg.cheb_its - 2
    check(by["a00_cheb_first"] == vcycles
          and by["a00_cheb_step"] == steps * vcycles
          and by["a00_masked"] >= vcycles and by["a00_apply_keep"] == 0
          and k6["cheb_first_masked"] == k6["cheb_step_masked"] == 0,
          f"{where}: K1 applies by form {by}, K6 launches by form {k6} in "
          f"{vcycles:g} V-cycles: expected 1 a00_cheb_first and {steps} "
          f"a00_cheb_step per V-cycle, no keep-only or masked K6 form")
    log(f"[main] {where}: K1 applies by form {by}; per V-cycle "
        f"a00_cheb_first 1, a00_cheb_step {steps}, K6 "
        f"{rec['mg'][1] / vcycles:.2f} launches (its zero-guess first "
        f"steps and the p-block's; by form {k6})")


def _check_k3(rec, vcycles, cfg, where):
    """The single-device p-block and the fine level's restriction: every
    p-block step after its zero-guess first is one mp_cheb_step (K3 with
    K6's update in its store), no other K3 form; K6 runs only the
    zero-guess first steps, the fine level's (one per V-cycle) and the
    p-block's (one per p-block solve), and no step; the fine residual is
    restricted with L-2's first Chebyshev step in the store, once per
    V-cycle, never unfused. Returns the p-block solves."""
    k3, k6, k5 = rec["k3"], rec["k6_by"], rec["k5"]
    steps = cfg.p_cheb_its - 1
    p_solves = k3["mp_cheb_step"] / steps
    check(k3["mp_cheb_step"] > 0 and p_solves == int(p_solves)
          and k3["mp_apply"] == 0
          and k6["cheb_step"] == 0 and k6["cheb_first"] == vcycles + p_solves
          and k5["restrict_parity_residual_cheb_first"] == vcycles
          and k5["restrict_parity_residual"] == 0,
          f"{where}: K3 by form {k3}, K6 by form {k6}, fine restrictions "
          f"{k5['restrict_parity_residual_cheb_first']} fused / "
          f"{k5['restrict_parity_residual']} unfused in {vcycles:g} "
          f"V-cycles: expected {steps} mp_cheb_step per p-block solve, "
          f"K6 one first step per V-cycle and per p-block solve, one "
          f"fused restriction per V-cycle")
    log(f"[{where.split()[0]}] {where}: K3 {k3['mp_cheb_step']} launches "
        f"(mp_cheb_step, {steps} per p-block solve, {p_solves:g} solves), "
        f"K6 {k6['cheb_first']} launches ({vcycles:g} fine and {p_solves:g} "
        f"p-block zero-guess first steps, no step), "
        f"restrict_parity_residual_cheb_first {vcycles:g} (L-2's first "
        f"step in its store)")
    return p_solves


def _fine_pair(b, y, cls_shapes, m_el, d, scale):
    """The launches restrict_parity_residual_cheb_first replaces: K5's
    residual restriction, then K6's zero-guess first step."""
    b2 = transfer.restrict_parity_residual(b, y, cls_shapes, m_el)
    return b2, cheb.cheb_first(b2, None, d, torch.zeros_like(b2), scale)


def _swapped_solve(slv, F, swaps):
    """An IR solve over slv's setup by a device-loop solver built with the
    (module, name, function) swaps in place (its graph captures them), the
    second of two; the entries restored after."""
    saved = [(mod, n, getattr(mod, n)) for mod, n, _ in swaps]
    for mod, n, fn in swaps:
        setattr(mod, n, fn)
    try:
        tslv = tabf.ABFSolver.from_parts(slv.cfg, slv.data, slv.setup,
                                         device=slv.device, dtype=slv.dtype,
                                         ir=True)
        _ir_solve(tslv, F)
        t = _ir_solve(tslv, F)
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)
    check(tslv.loop == "device" and t["res"]["converged"]
          and not t["res"]["stalled"],
          f"main: a witness solve ran the {tslv.loop} loop or did not "
          f"converge")
    return t


def _k3_witness(slv, F, d, vcycles, card):
    """The device-loop IR solve over slv's setup with K3's fused forms
    swapped for their twins (the plain kernel, then K6) and the fused fine
    restriction for the pair it replaces (K5's residual restriction, then
    K6's first step): x, history, rounds and inner its bitwise the fused
    solve's; K3 the same launches in the plain form, K6 one more per K3
    step and per V-cycle. Then the order witness: the same solve with K3's
    entries swapped for the parent's routing (mp_apply_plain, then K6):
    its rounds and inner its beside the fused solve's, x compared (the
    kernel's element products sum in another order than the GEMMs)."""
    t = _swapped_solve(slv, F, [(mp, n, fn) for n, fn in mp.TWINS.items()]
                       + [(transfer, "restrict_parity_residual_cheb_first",
                           _fine_pair)])
    steps = d["k3"]["mp_cheb_step"]
    check(_same_ir(t["res"], d["res"]),
          f"main: with K3's fused forms and the fused fine restriction "
          f"swapped for their twins the solve differs (rounds "
          f"{t['res']['rounds']} / {d['res']['rounds']}, inner its "
          f"{t['res']['inner_its']} / {d['res']['inner_its']})")
    check(t["k3"] == {**dict.fromkeys(mp.FORMS, 0), "mp_apply": steps}
          and t["mg"][1] == d["mg"][1] + steps + vcycles
          and t["k5"]["restrict_parity_residual"] == vcycles
          and t["k5"]["restrict_parity_residual_cheb_first"] == 0,
          f"main: twins' solve K3 {t['k3']}, K6 {t['mg'][1]}, K5 "
          f"{t['k5']}; fused solve K3 {d['k3']}, K6 {d['mg'][1]}")
    log(f"[main] witness: the device-loop IR solve with K3's fused forms "
        f"and the fused fine restriction swapped for their twins: "
        f"{t['res']['rounds']} rounds / {t['res']['inner_its']} inner its, "
        f"x and history bitwise the fused solve's; K3 {steps} plain "
        f"launches, K6 {t['mg'][1]} against {d['mg'][1]} ({steps} p-block "
        f"steps and {vcycles:g} L-2 first steps now in K3's and K5's "
        f"stores); wall {t['wall']:.4f} s against {d['wall']:.4f} s "
        f"({card})")
    o = _swapped_solve(slv, F, [(mp, n, fn) for n, fn in K3_PARENT.items()])
    xrel = float(np.linalg.norm(o["res"]["x"] - d["res"]["x"])
                 / np.linalg.norm(d["res"]["x"]))
    check(not any(o["k3"].values()),
          f"main: the order witness launched K3: {o['k3']}")
    ocounts = (o["res"]["rounds"], o["res"]["inner_its"])
    dcounts = (d["res"]["rounds"], d["res"]["inner_its"])
    log(f"[main] order witness: the device-loop IR solve with K3's entries "
        f"swapped for the parent's routing (mp_apply_plain, then K6): "
        f"{ocounts[0]} rounds / {ocounts[1]} inner its against the "
        f"kernel's {dcounts[0]} / {dcounts[1]} (counts equal "
        f"{ocounts == dcounts}, x bitwise "
        f"{bool(np.array_equal(o['res']['x'], d['res']['x']))}, x differs "
        f"by {xrel:.3e} norm-relative); K6 {o['mg'][1]}; wall "
        f"{o['wall']:.4f} s against {d['wall']:.4f} s ({card})")


def _fused_witness(slv, F, d, card):
    """The device-loop IR solve over slv's setup with K1's fused entries
    swapped for their twins (K1 without keep, the torch mask ops, K6: the
    launches the port issued before them): x, history, rounds and inner
    its bitwise the fused solve's; K1 launches and applies equal; K6 the
    fused solve's plus one launch per fused Chebyshev form; K4 and K5
    equal."""
    saved = {name: getattr(a00, name) for name in a00.TWINS}
    for name, twin in a00.TWINS.items():
        setattr(a00, name, twin)
    try:
        tslv = tabf.ABFSolver.from_parts(slv.cfg, slv.data, slv.setup,
                                         device=slv.device, dtype=slv.dtype,
                                         ir=True)
        t = _ir_solve(tslv, F)
        t = _ir_solve(tslv, F)
    finally:
        for name, fn in saved.items():
            setattr(a00, name, fn)
    fused_k6 = d["a00_by"]["a00_cheb_first"] + d["a00_by"]["a00_cheb_step"]
    check(tslv.loop == "device" and _same_ir(t["res"], d["res"]),
          f"main: with K1's fused forms swapped for their twins the device "
          f"loop ran {tslv.loop} and differs from the fused solve (rounds "
          f"{t['res']['rounds']} / {d['res']['rounds']}, inner its "
          f"{t['res']['inner_its']} / {d['res']['inner_its']})")
    check((t["launches"], t["applies"], t["mg"][0], t["k5"])
          == (d["launches"], d["applies"], d["mg"][0], d["k5"])
          and t["mg"][1] == d["mg"][1] + fused_k6
          and t["a00_by"]["a00_apply"] == t["applies"],
          f"main: twins' solve K1 {t['launches']} / {t['applies']} (by form "
          f"{t['a00_by']}), K6 {t['mg'][1]}, K4 {t['mg'][0]}; fused solve "
          f"K1 {d['launches']} / {d['applies']}, K6 {d['mg'][1]} + "
          f"{fused_k6} fused Chebyshev forms, K4 {d['mg'][0]}")
    log(f"[main] witness: the device-loop IR solve with K1's fused forms "
        f"swapped for their twins: {t['res']['rounds']} rounds / "
        f"{t['res']['inner_its']} inner its, x and history bitwise the "
        f"fused solve's; K1 {t['launches']} launches in {t['applies']} "
        f"applies (equal), K6 {t['mg'][1]} against the fused solve's "
        f"{d['mg'][1]} ({t['mg'][1] - d['mg'][1]} fine-level Chebyshev "
        f"steps now in K1's store); wall {t['wall']:.4f} s against "
        f"{d['wall']:.4f} s ({card})")


def _main_witness(card):
    """The flagship as a float64 direct solve: the driver's (device loop)
    against loop="host" over its setup. The float32 IR solves above may
    differ by an inner iteration between the loops, whose Gram-Schmidt
    dots sum in another order (the device loop's over the whole masked
    window); in float64 that rounding must not move the counts: equal
    iterations, reason and K1 counts per solve (so equal u-block GCR
    iterations), histories within 1e-10 of the initial residual (their
    last entries are ~1e-5 of it, where float64 rounding amplified through
    the GCR preconditioner may show at ~1e-8 of the entry). Then the
    same direct solve over the same setup with K4, K5, K6, K1's fused
    forms and K3 swapped for their twins (device loop; K3's plain version
    mp_apply_plain): K4 and K3 sum in another order than their twins, yet
    in float64 the kernels must give the twins' reason and iterations,
    with x within 1e-10 (norm-relative)."""
    argv = tdriver.ABF_OPTS + (
        "-model 11 -size_x 0.1 -mx 32 -saddle_fieldsplit_u_pc_mg_levels 4 "
        "-saddle_ksp_converged_reason").split()
    r = tdriver.saddle_solve(Options.from_args(argv), 3, log=log)
    slv = r["solver"]
    check(r["loop"] == "device" and slv.dtype == torch.float64,
          "witness: the driver's float64 solve is not on the device loop")
    host = tabf.ABFSolver.from_parts(slv.cfg, slv.data, slv.setup,
                                     device=slv.device, dtype=slv.dtype,
                                     loop="host")
    out = []
    for s in (slv, host):
        a00.LAUNCHES.reset()
        res = s.solve(r["F"])
        out.append((res, (a00.LAUNCHES.n, a00.LAUNCHES.applies)))
    (d, kd), (h, kh) = out
    hd, hh = np.asarray(d["history"]), np.asarray(h["history"])
    same = hd.shape == hh.shape
    rel0 = float(np.max(np.abs(hd - hh)) / hh[0]) if same else float("inf")
    rel = float(np.max(np.abs(hd - hh) / hh)) if same else float("inf")
    log(f"[main] witness, float64 direct solve (abf.opts, mx=32): device "
        f"loop {d['reason']} in {d['its']} its, K1 {kd[0]} launches in "
        f"{kd[1]} applies per solve; host loop {h['reason']} in {h['its']} "
        f"its, K1 {kh[0]} / {kh[1]}; histories differ by {rel0:.3e} of the "
        f"initial residual, {rel:.3e} of the entry at most ({card})")
    check((d["its"], d["reason"]) == (h["its"], h["reason"]),
          f"witness: float64 device loop {d['its']} its / {d['reason']}, "
          f"host loop {h['its']} / {h['reason']}")
    check(kd == kh, f"witness: K1 launches / applies per solve {kd} vs {kh}")
    check(rel0 <= 1e-10, f"witness: histories differ by {rel0:.3e} of the "
          f"initial residual")
    swaps = _k4_twins() + [(cheb, "cheb_first", cheb.cheb_first_plain),
                           (cheb, "cheb_step", cheb.cheb_step_plain)] + [
        (transfer, name, twin) for name, twin in transfer.TWINS.items()] + [
        (a00, name, twin) for name, twin in a00.TWINS.items()] + [
        (mp, name, fn) for name, fn in K3_PARENT.items()]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in swaps]
    for mod, attr, fn in swaps:
        setattr(mod, attr, fn)
    try:
        twins = tabf.ABFSolver.from_parts(slv.cfg, slv.data, slv.setup,
                                          device=slv.device, dtype=slv.dtype)
        _reset_launches()
        t = twins.solve(r["F"])
        mg = _mg_counts() + (transfer.LAUNCHES.n, mp.LAUNCHES.n)
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    xrel = float(np.linalg.norm(d["x"] - t["x"]) / np.linalg.norm(t["x"]))
    log(f"[main] witness, float64 direct solve with every K4 and K5 entry, "
        f"K1's fused forms, K6 and K3 (mp_apply_plain, then K6's twin) "
        f"swapped for their twins ({twins.loop} loop): kernels "
        f"{d['reason']} in {d['its']} its, twins {t['reason']} in "
        f"{t['its']} its, x differs by {xrel:.3e} (norm-relative), twin "
        f"run K4 / K6 / K5 / K3 launches {mg} ({card})")
    check(twins.loop == "device" and not any(mg),
          f"witness: the twins' solve ran loop {twins.loop}, K4 / K6 / K5 "
          f"/ K3 launches {mg}")
    check((t["its"], t["reason"]) == (d["its"], d["reason"]),
          f"witness: kernels {d['its']} its / {d['reason']}, twins "
          f"{t['its']} / {t['reason']}")
    check(xrel <= 1e-10, f"witness: x with the kernels differs from x with "
          f"the twins by {xrel:.3e}")


# (name, argv, iterations, first and last monitor values) of the JAX
# package's host route on these trees (float64 on the CPU)
HOST_ANCHORS = [
    ("3d_mg_1", "-model 2 -sinker_n 1 -mx 8 -mg -nlevels 2 "
     "-saddle_ksp_type fgmres -saddle_mg_levels_ksp_type gmres "
     "-saddle_mg_levels_pc_type jacobi -saddle_mg_levels_ksp_max_it 10",
     12, 0.0179029, 1.57335e-07),
    ("abf.opts -tpu 0", " ".join(tdriver.ABF_OPTS)
     + " -model 11 -size_x 0.1 -mx 4 -tpu 0", 21, 0.00495115, 3.13656e-08),
    ("ildl_1", "-mx 8 -model 6 -eta1 100 -eta0 1 -saddle_pc_type ildl "
     "-saddle_pc_ildl_droptol 1e-3 -saddle_ksp_pc_side right",
     7, 0.0180253, 9.43046e-08),
]

_MON = re.compile(r"^\s*(\d+) KSP Residual norm (\S+) $")


def _monitor_values(lines):
    return [float(m.group(2)) for m in map(_MON.match, lines) if m]


def phase_host_anchor():
    t0 = time.perf_counter()
    built = native.build_all()
    log(f"[host_anchor] native libraries {built or 'reused'} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, argv, its, first, last in HOST_ANCHORS:
        lines = []
        t0 = time.perf_counter()
        r = tdriver.saddle_solve(Options.from_args(
            argv.split() + ["-saddle_ksp_monitor_short"]), 3,
            log=lines.append)
        mon = _monitor_values(lines)
        log(f"[host_anchor] {name}: {r['reason']} in {r['its']} its, "
            f"monitor {mon[0]:g} .. {mon[-1]:g}, "
            f"{time.perf_counter() - t0:.2f} s")
        check(r["reason"] == "CONVERGED_RTOL" and r["its"] == its,
              f"{name}: {r['reason']} in {r['its']} its, expected "
              f"CONVERGED_RTOL in {its}")
        check(len(mon) == its + 1, f"{name}: {len(mon)} monitor lines")
        for got, want in ((mon[0], first), (mon[-1], last)):
            check(abs(got - want) <= 1e-5 * want,
                  f"{name}: monitor value {got:g} != {want:g}")


def phase_host_mg(device):
    argv = ("-model 2 -sinker_n 1 -mx 32 -mg -nlevels 4 "
            "-saddle_ksp_type fgmres -saddle_mg_levels_ksp_type gmres "
            "-saddle_mg_levels_pc_type jacobi -saddle_mg_levels_ksp_max_it 10 "
            "-saddle_ksp_monitor_short -saddle_ksp_converged_reason "
            "-diagnostics").split()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a00.LAUNCHES.reset()
    lines = []

    def tee(msg=""):
        lines.append(msg)
        log(msg)
    r = tdriver.saddle_solve(Options.from_args(argv), 3, log=tee)
    mesh, its = r["mesh"], r["its"]
    log(f"[host_mg] A00 kernel launches during the driver run: "
        f"{a00.LAUNCHES.n} (the host route applies A00 through "
        f"SaddleOperator.mult_u)")
    check(r["reason"] == "CONVERGED_RTOL", f"host_mg: {r['reason']}")
    check(r["X"].shape == (mesh.ndof,) and np.all(np.isfinite(r["X"])),
          "host_mg: solution not finite or of the wrong shape")
    mon = _monitor_values(lines)
    check(len(mon) == its + 1 and mon[-1] <= 1e-5 * mon[0],
          "host_mg: monitor history does not show the converged solve")

    # independent true residual with the float64 SaddleOperator
    op = r["levels"][-1].op
    x = r["result"].x
    F = torch.as_tensor(r["F"], device=device)
    true = float(torch.linalg.vector_norm(F - op.mult(x)))
    rel = abs(true - r["rnorm"]) / r["rnorm"]
    log(f"[host_mg] true residual {true:.9e}, last monitored "
        f"{r['rnorm']:.9e}, relative difference {rel:.3e}")
    check(rel <= 1e-6, f"host_mg: true residual differs by {rel:.3e}")

    # determinism: repeated applies and a repeated solve are bitwise equal
    xr = torch.as_tensor(np.random.default_rng(0).standard_normal(
        mesh.ndof), device=device)
    check(torch.equal(op.mult(xr), op.mult(xr)),
          "host_mg: SaddleOperator.mult not bitwise repeatable")
    P = r["ksp"].pc.levels[-1].P
    check(torch.equal(P.restrict(xr), P.restrict(xr)),
          "host_mg: Prolongation.restrict not bitwise repeatable")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res2 = tdriver._extra_solves(r["ksp"], F, log=log)
    torch.cuda.synchronize()
    t_again = time.perf_counter() - t0
    check(res2.its == its and torch.equal(res2.x, x),
          f"host_mg: repeated solve gave {res2.its} its"
          f"{'' if torch.equal(res2.x, x) else ' and a different x'}")
    t_setup, t_solve = r["seconds"]["setup"], r["seconds"]["solve"]
    log(f"[host_mg] mx=32 ndof {mesh.ndof}, 4 levels: setup {t_setup:.2f} s, "
        f"solve {t_solve:.3f} s, repeated solve {t_again:.3f} s, outer its "
        f"{its}, {1e3 * t_solve / its:.2f} ms/outer it, peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


COMPILED_K = 30


def phase_compiled(device, card):
    """The fixed-work tree FGMRES cycle on K1 at mx=32 (float64, float32)
    against the host KSP, then the natural-order operators at mx=16.
    Returns (K1 launches, applies) of the two sync-checked cycles."""
    k = COMPILED_K
    cycle = compiled.make_fgmres_cycle_tree(k)
    mesh, fes, coeff, _, _, bc_mask = _problem(3, (32, 32, 32), 11,
                                               (0.1, 1.0, 1.0))
    F_np = np.random.default_rng(2).standard_normal(mesh.ndof)
    out, launches, applies = {}, 0, 0
    for dtype in (torch.float64, torch.float32):
        op = ParityMatFreeOperator.build(mesh, fes, coeff, bc_mask,
                                         dtype=dtype, device=device)
        d = op.diagonal()
        inv = 1.0 / torch.where(d == 0.0, torch.ones_like(d), d)
        F = torch.as_tensor(F_np, dtype=dtype, device=device)
        x0 = torch.zeros_like(F)
        aux = tree_aux(op)
        op.node_table                      # K1's table on the device
        torch.cuda.synchronize()
        a00.LAUNCHES.reset()
        torch.cuda.set_sync_debug_mode("error")
        try:
            x, rn = cycle(op, aux, inv, F, x0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        n, a = a00.LAUNCHES.n, a00.LAUNCHES.applies
        launches += n
        applies += a
        check(n == 2 * (k + 2) and a == k + 2,
              f"compiled {dtype}: {n} K1 launches in {a} applies, expected "
              f"{2 * (k + 2)} in {k + 2}")
        rn = float(rn)
        check(np.isfinite(rn) and bool(torch.isfinite(x).all()),
              f"compiled {dtype}: residual {rn} or x not finite")
        ms = _median_ms(lambda: cycle(op, aux, inv, F, x0), reps=5, inner=1,
                         warmup=1)
        out[dtype] = (rn, ms)
        log(f"[compiled] mx=32 ndof {mesh.ndof} {str(dtype)[6:]}: FGMRES({k}) "
            f"cycle, no host sync, {n} K1 launches in {a} applies, "
            f"||F - A x|| {rn:.10e}, {ms:.3f} ms per cycle, {ms / k:.4f} ms per "
            f"iteration ({card})")
        if dtype == torch.float64:
            # the same cycle captured into a CUDA graph: capture fails on any
            # host synchronisation; a replay shows the device's own time
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                cycle(op, aux, inv, F, x0)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with graphs.collector_held(), torch.cuda.graph(graph):
                xg, rg = cycle(op, aux, inv, F, x0)
            graph.replay()
            check(torch.equal(xg, x) and float(rg) == rn,
                  "compiled float64: the graph replay differs from the cycle")
            g_ms = _median_ms(graph.replay, reps=5, inner=1, warmup=1)
            log(f"[compiled] the float64 cycle captured as one CUDA graph: "
                f"replay {g_ms:.3f} ms per cycle, {g_ms / k:.4f} ms per "
                f"iteration, bitwise equal to the cycle ({card})")
            del graph, xg, rg
            hist = []
            cfg = KSPConfig(type="fgmres", restart=k, max_it=k,
                            convergence_test="skip",
                            monitor=lambda i, r: hist.append(r))
            ksp = KSP(op.mult, pc=PCJacobi(d, device), cfg=cfg)
            ksp.solve(F)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hist.clear()
            ksp.solve(F)
            torch.cuda.synchronize()
            host_ms = 1e3 * (time.perf_counter() - t0) / k
            rel = abs(hist[-1] - rn) / hist[-1]
            log(f"[compiled] host KSP FGMRES({k}) over the flat parity mult: "
                f"residual {hist[-1]:.10e} (relative difference {rel:.3e}), "
                f"{host_ms:.4f} ms per iteration ({card})")
            check(rel <= 1e-8, f"compiled float64 residual differs from the "
                  f"host KSP's by {rel:.3e}")
        del op, d, inv, F, x0, x, aux
    r64, r32 = out[torch.float64][0], out[torch.float32][0]
    check(abs(r32 - r64) <= 1e-2 * r64,
          f"compiled float32 residual {r32} vs float64 {r64}")
    torch.cuda.empty_cache()

    # natural-order operators against the element-batched SaddleOperator
    mesh, fes, coeff, bc_idx, bc_vals, bc_mask = _problem(
        3, (16, 16, 16), 11, (0.1, 1.0, 1.0))
    elm = assemble_element_matrices(fes, coeff)
    sop, _, _, _ = apply_dirichlet_elimination(mesh, elm, bc_idx, bc_vals,
                                               device)
    del elm
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(mesh.ndof),
                        device=device)
    y = sop.mult(x)
    scale = float(y.abs().max())
    perm, _ = parity_permutation(mesh)
    perm = torch.as_tensor(perm, device=device)
    mf = MatFreeSaddleOperator.build(mesh, fes, coeff, bc_mask,
                                     dtype=torch.float64, device=device)
    pop = ParityMatFreeOperator.from_matfree(mf, mesh)
    for name, fn, ref in (
            ("GridSaddleOperator",
             GridSaddleOperator.from_operator(mesh, sop).mult, y),
            ("MatFreeSaddleOperator", mf.mult, y),
            ("ParityMatFreeOperator.mult", lambda v: pop.mult(v[perm]),
             y[perm])):
        got = fn(x)
        rel = float((got - ref).abs().max()) / scale
        log(f"[compiled] mx=16 {name}: relative {rel:.3e} against "
            f"SaddleOperator.mult")
        check(rel <= 1e-12, f"{name} differs from SaddleOperator.mult by "
              f"{rel:.3e}")
        check(torch.equal(fn(x), got), f"{name}: repeated applies differ")
    return launches, applies, out


# the JAX package's -saddle_ksp_view run of the flagship argv at mx=6
# (float64 on the CPU): iterations and the tree's lines, rerun by
# tests/test_torch_chip_anchors.py
VIEW_ITS, VIEW_TREE_LINES = 21, 289
_ESTEIG = re.compile(r"eigenvalues estimate via gmres|eigenvalue estimates "
                     r"used")
_FLOAT = re.compile(r"[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?")


def _same_esteig(a, b):
    """Two esteig lines: the same words, numbers to 1e-5 relative."""
    if _FLOAT.sub("#", a) != _FLOAT.sub("#", b):
        return False
    return all(abs(float(x) - float(y)) <= 1e-5 * max(abs(float(y)), 1e-300)
               for x, y in zip(_FLOAT.findall(a), _FLOAT.findall(b)))


def _tree(lines):
    return lines[lines.index("KSP Object: (saddle_) 1 MPI processes"):]


DUMP_FILES = ("coeffs_0.vts", "coeffs_1.vts", "uvw.vts", "p.vts",
              "solution.npy", "operator_0.npz", "operator_1.npz",
              "preconditioner.npz", "preconditioned_operator_out.npz",
              "smoother_1.npz", "mpscaled.npz")


def phase_outputs(device, card):
    argv = tdriver.ABF_OPTS + ("-model 11 -size_x 0.1 -mx 6 -saddle_ksp_view "
                               "-saddle_ksp_monitor_short").split()
    trees = {}
    for dev in ("cuda", "cpu"):
        lines = []
        t0 = time.perf_counter()
        r = tdriver.saddle_solve(Options.from_args(argv + ["-device", dev]),
                                 3, log=lines.append)
        trees[dev] = _tree(lines)
        log(f"[outputs] -saddle_ksp_view mx=6 -device {dev}: {r['reason']} "
            f"in {r['its']} its, tree of {len(trees[dev])} lines, "
            f"{time.perf_counter() - t0:.2f} s ({card})")
        if dev == "cuda":
            check(r["its"] == VIEW_ITS and "history" not in r,
                  f"-saddle_ksp_view run: {r['its']} its, expected "
                  f"{VIEW_ITS} on the host route")
    check(len(trees["cuda"]) == len(trees["cpu"]) == VIEW_TREE_LINES,
          f"tree lengths {len(trees['cuda'])} / {len(trees['cpu'])}, "
          f"expected {VIEW_TREE_LINES}")
    for a, b in zip(trees["cuda"], trees["cpu"]):
        ok = _same_esteig(a, b) if _ESTEIG.search(b) else a == b
        check(ok, f"-saddle_ksp_view trees differ:\ncuda: {a}\ncpu:  {b}")

    argv = ("-model 2 -sinker_n 1 -mx 4 -mg -nlevels 2 -saddle_ksp_type "
            "fgmres -saddle_mg_levels_ksp_type gmres "
            "-saddle_mg_levels_pc_type jacobi -saddle_mg_levels_ksp_max_it 3 -view_fields -view_coeffs "
            "-dump_solution -dump_operator -dump_preconditioner "
            "-dump_preconditioned_operator -dump_smoother "
            "-dump_scaled_mass_matrix").split()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            r = tdriver.saddle_solve(Options.from_args(argv), 3,
                                     log=lambda *a: None)
            t_run = time.perf_counter() - t0
            check(r["reason"] == "CONVERGED_RTOL", f"dumps: {r['reason']}")
            files = sorted(os.listdir(tmp))
            check(files == sorted(DUMP_FILES), f"dumps wrote {files}")
            for f in files:
                if f.endswith(".vts"):
                    arrays = [np.array(a.text.split(), float) for a in
                              ET.parse(f).getroot().iter("DataArray")]
                    check(all(np.isfinite(a).all() for a in arrays),
                          f"{f}: not finite")
                else:
                    z = np.load(f)
                    arrs = [z] if f.endswith(".npy") else [z[k] for k in z]
                    check(all(np.isfinite(a).all() for a in arrs),
                          f"{f}: not finite")
            X = np.load("solution.npy")
            check(np.array_equal(X, r["X"]),
                  "solution.npy is not the returned X")
            A = postproc.load_operator("operator_1.npz")
            op = r["levels"][-1].op
            res = r["F"] - op.mult(torch.as_tensor(X, device=device)).cpu(
                ).numpy()
            rel = np.abs(A @ X - (r["F"] - res)).max() / np.abs(r["F"]).max()
            check(rel <= 1e-12, f"dumped operator: A X vs F - r {rel:.3e}")
            t0 = time.perf_counter()
            s = postproc.spectrum(postproc.load_operator(
                "preconditioned_operator_out.npz"))
            check(s["pos"].size + s["neg"].size == X.size,
                  "spectrum: eigenvalue count")
            log(f"[outputs] mx=4 dumps ({len(files)} files, ndof {X.size}): "
                f"{t_run:.2f} s; A X = F - r to {rel:.3e}; spectrum of M^-1 A "
                f"in {time.perf_counter() - t0:.2f} s: {s['pos'].size} "
                f"positive, {s['neg'].size} negative, max|imag| "
                f"{s['max_imag']:.3e} ({card})")
        finally:
            os.chdir(cwd)

    for args in ("-n 50", "-n 50 -pc_type ildl", "-n 50 -pc_type ilupack",
                 "-n 50 -pc_type jacobi", "-n 50 -pc_type ilu"):
        res, err = solve_ex23(Options.from_args(args.split()),
                              log=lambda *a: None)
        log(f"[outputs] ex23 {args}: error {err:.3e} in {res.its} its")
        check(err < 1e-9, f"ex23 {args}: error {err}")


# the JAX package's ex42 run of EX42_ARGV at mx=32 (float64 on the CPU),
# rerun by tests/test_torch_chip_anchors.py
EX42_ITS = 84
EX42_ARGV = ("-model 1 -stokes_ksp_type fgmres -stokes_ksp_rtol 1e-7 "
             "-stokes_fieldsplit_u_ksp_type preonly "
             "-stokes_fieldsplit_u_pc_type mg "
             "-stokes_fieldsplit_u_pc_mg_levels 4 "
             "-stokes_fieldsplit_u_pc_mg_galerkin "
             "-stokes_fieldsplit_u_mg_levels_pc_type jacobi "
             "-stokes_fieldsplit_p_ksp_type preonly "
             "-stokes_fieldsplit_p_pc_type jacobi -stokes_ksp_monitor_blocks")


def phase_ex42(device, card):
    lines = []
    r = solve_stokes_3d_coupled(32, 32, 32, Options.from_args(
        EX42_ARGV.split()), log=lines.append, device=device)
    res, prob = r["result"], r["prob"]
    mon = [ln for ln in lines if "KSP Component" in ln]
    for ln in (mon[0], mon[-1]):
        log(f"[ex42] {ln}")
    X = r["X"].cpu().numpy()
    rp = np.abs((prob.F - prob.A @ X)[3::4]).max() / np.linalg.norm(prob.F)
    t_setup, t_solve = r["seconds"]["setup"], r["seconds"]["solve"]
    log(f"[ex42] sinker mx=32 ndof {prob.ndof}: {res.reason} in {res.its} "
        f"its, max p-row |F - A X| / ||F|| {rp:.3e}; setup {t_setup:.2f} s, "
        f"solve {t_solve:.3f} s, {1e3 * t_solve / res.its:.2f} ms per "
        f"iteration ({card})")
    check(res.reason == "CONVERGED_RTOL" and res.its == EX42_ITS,
          f"ex42: {res.reason} in {res.its} its, expected CONVERGED_RTOL in "
          f"{EX42_ITS}")
    check(len(mon) == res.its + 1, f"ex42: {len(mon)} block monitor lines")
    check(np.all(np.isfinite(X)) and X.shape == (prob.ndof,),
          "ex42: solution not finite or of the wrong shape")
    check(rp < 1e-8, f"ex42: p-rows of F - A X at {rp:.3e} of ||F||")


# the cart phase's sharded layouts: the operator checks, the flagship
CART_OP_GRID, CART_SLABS, CART_DEVICES = (2, 2, 2), 4, 4
CART_ARGV = tdriver.ABF_OPTS + (
    "-model 11 -size_x 0.1 -mx 32 -saddle_fieldsplit_u_pc_mg_levels 4 "
    "-saddle_ksp_monitor_short -saddle_ksp_converged_reason").split()
# the flagship's history, sharded against single-device, per entry
HIST_TOL = 1e-7


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def phase_cart(device, card):
    """The sharded runtime with every shard on this card; returns the K1
    (launches, applies) of the flagship's sharded driver run and that run
    (its, reason, history, X, F and a float64 true-residual function) for
    phase cart_procs."""
    from exsaddle_tpu_torch.abf import ABFSolver
    from exsaddle_tpu_torch.assembly import assemble_rhs, scatter_vector
    from exsaddle_tpu_torch.parallel.cart import (CartOperator,
                                                  CartPartition,
                                                  make_cart_fgmres,
                                                  make_cart_mult)
    from exsaddle_tpu_torch.parallel.cart_abf import CartABFSolver
    from exsaddle_tpu_torch.parallel.dist_abf import DistABFSolver

    # --- mx=16 pseudoice, float64: the sharded applies and the cycle ----
    mesh, fes, coeff, bc_idx, bc_vals, bc_mask = _problem(
        3, (16, 16, 16), 11, (0.1, 1.0, 1.0))
    ctx = emodels.ModelContext(Options.from_args(["-model", "11"]), 3,
                               log=lambda *a, **k: None)
    sop, _, _, _ = apply_dirichlet_elimination(
        mesh, assemble_element_matrices(fes, coeff), bc_idx, bc_vals, device)
    ndev = int(np.prod(CART_OP_GRID))
    part = CartPartition(mesh, CART_OP_GRID)
    t0 = time.perf_counter()
    cop = CartOperator.build(part, ctx, bc_idx, part.device_mesh(
        [device] * ndev))
    cslv = CartABFSolver(part, ctx, bc_idx, bc_vals, [device] * ndev,
                         nlevels=3)
    t_build = time.perf_counter() - t0
    smesh, blk = cslv.smesh, cslv.blocks
    x = np.random.default_rng(5).standard_normal(mesh.ndof)
    y1 = sop.mult(torch.as_tensor(x, device=device)).cpu().numpy()
    scale = float(np.abs(y1).max())
    mult = make_cart_mult(cop.smesh)
    xs = cop.smesh.shard(part.shard_vector(x))
    yc = mult(cop, xs)
    rel = float(np.abs(part.unshard_vector(yc) - y1).max()) / scale
    log(f"[cart] mx=16 make_cart_mult over {CART_OP_GRID}: relative {rel:.3e} "
        f"against SaddleOperator.mult (CartOperator and CartABFSolver built "
        f"in {t_build:.2f} s)")
    check(rel <= 1e-12, f"cart: make_cart_mult differs by {rel:.3e}")
    check(all(torch.equal(a, b) for a, b in zip(mult(cop, xs).parts,
                                                yc.parts)),
          "cart: make_cart_mult not bitwise repeatable")

    pop = ParityMatFreeOperator.build(mesh, fes, coeff, bc_mask,
                                      dtype=torch.float64, device=device)
    perm, iperm = parity_permutation(mesh)
    yt1 = mult_tree(pop, tree_aux(pop), torch.as_tensor(
        x[perm], device=device)).cpu().numpy()[iperm]
    xt = cslv.shard_saddle(x)
    torch.cuda.synchronize()
    a00.LAUNCHES.reset()
    yt = blk.saddle_mult(xt)
    n, a = a00.LAUNCHES.n, a00.LAUNCHES.applies
    check(n == 2 * ndev and a == ndev,
          f"cart: {n} K1 launches in {a} applies per sharded mult_tree, "
          f"expected {2 * ndev} in {ndev}")
    rel = float(np.abs(cslv.unshard_saddle(yt) - yt1).max()
                / np.abs(yt1).max())
    log(f"[cart] mx=16 sharded mult_tree over {CART_OP_GRID}: {n} K1 "
        f"launches per apply, relative {rel:.3e} against the single-device "
        f"mult_tree")
    check(rel <= 1e-12, f"cart: sharded mult_tree differs by {rel:.3e}")
    check(all(torch.equal(p, q) for p, q in zip(blk.saddle_mult(xt).parts,
                                                yt.parts)),
          "cart: sharded mult_tree not bitwise repeatable")

    k = COMPILED_K
    f1, f2 = assemble_rhs(fes, coeff["Fu"], coeff["Fp"])
    F = scatter_vector(mesh, f1, f2)
    d = sop.diagonal()
    inv = 1.0 / torch.where(d == 0.0, torch.ones_like(d), d)
    shard = lambda v: cop.smesh.shard(part.shard_vector(v))
    Fs, invs, x0s = shard(F), shard(inv.cpu().numpy()), shard(
        np.zeros(mesh.ndof))
    cycle = make_cart_fgmres(cop.smesh, k)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        xk, rn = cycle(cop, invs, Fs, x0s)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    rn = float(rn)
    x1, r1 = compiled.make_fgmres_cycle(sop.mult, lambda v: inv * v, k)(
        torch.as_tensor(F, device=device), torch.zeros_like(d))
    r1 = float(r1)
    ms = _median_ms(lambda: cycle(cop, invs, Fs, x0s), reps=3, inner=1,
                    warmup=1)
    log(f"[cart] mx=16 make_cart_fgmres({k}) over {CART_OP_GRID}, no host "
        f"sync: ||F - A x|| {rn:.10e} vs single-device {r1:.10e} (relative "
        f"{abs(rn - r1) / r1:.3e}), {ms:.2f} ms per cycle ({card})")
    check(abs(rn - r1) <= 1e-8 * r1, "cart: the sharded cycle's residual "
          "differs from the single-device cycle's")
    del sop, cop, cslv, blk, pop, xs, yc, xt, yt, Fs, invs, x0s, xk, x1
    torch.cuda.empty_cache()

    # --- DistABFSolver over 4 slabs vs the single-device float64 solve --
    single = ABFSolver(mesh, fes, coeff, bc_idx, bc_vals, device=device,
                       nlevels=3)
    Fd = F.copy()
    Fd[: mesh.nu][bc_idx] = bc_vals
    Fd = Fd + single.setup["rhs_diri"]
    r1 = single.solve(Fd)
    t0 = time.perf_counter()
    dslv = DistABFSolver(mesh, fes, coeff, bc_idx, bc_vals,
                         [device] * CART_SLABS, nlevels=3)
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    rd = dslv.solve(Fd)
    t_solve = time.perf_counter() - t0
    rel = _rel(rd["x"], r1["x"])
    log(f"[cart] mx=16 DistABFSolver over {CART_SLABS} slabs: {rd['reason']} "
        f"in {rd['its']} its (single device {r1['its']}), x relative "
        f"{rel:.3e}; setup {t_setup:.2f} s, solve {t_solve:.3f} s ({card})")
    check(rd["its"] == r1["its"] and rd["reason"] == r1["reason"]
          == "CONVERGED_RTOL", "cart: the slab solve's iterations differ")
    check(rel <= 1e-10, f"cart: the slab solve's x differs by {rel:.3e}")
    del single, dslv
    torch.cuda.empty_cache()

    # --- the flagship through the driver, sharded over 4 shards --------
    a00.LAUNCHES.reset()
    r1 = tdriver.saddle_solve(Options.from_args(CART_ARGV), 3,
                              log=lambda *a: None, devices=[device])
    applies1 = a00.LAUNCHES.applies
    check(r1["mode"] == "direct", f"cart: reference ran as {r1['mode']}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    lines = []
    r = tdriver.saddle_solve(Options.from_args(CART_ARGV), 3,
                             log=lines.append,
                             devices=[device] * CART_DEVICES)
    counts = _launch_counts()
    launches, applies = counts["a00_apply"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    slv = r["solver"]
    halos = r["res"]["halo_exchanges"]
    its, t_setup, t_solve = r["its"], r["seconds"]["setup"], \
        r["seconds"]["solve"]
    for ln in (lines[-3], lines[-2], lines[-1]):
        log(f"[cart] {ln}")
    check(r["mode"] == "cart" and slv.part.dev_shape == (1, 2, 2),
          f"cart: driver ran as {r['mode']}")
    check(r["loop"] == "device" and slv.smesh.capturable
          and slv._dev.graph is not None,
          f"cart: the driver's sharded solve ran the {r['loop']} loop")
    check(r["reason"] == r1["reason"] == "CONVERGED_RTOL"
          and its == r1["its"],
          f"cart: {r['reason']} in {its} its, the single device "
          f"{r1['reason']} in {r1['its']}")
    h, h1 = np.array(r["history"]), np.array(r1["history"])
    # entry by entry, each against its own size: the sharded sums are in
    # another order, and the worst entry read 2.05e-8 on the H100
    hrel, hworst = _rel(h, h1), float(np.max(np.abs(h - h1) / h1))
    xrel = _rel(r["X"], r1["X"])
    check(hworst <= HIST_TOL, f"cart: history entry differs by {hworst:.3e}")
    check(xrel <= 1e-9, f"cart: x differs by {xrel:.3e}")
    check(launches > 0 and launches == 2 * applies
          and applies % CART_DEVICES == 0,
          f"cart: {launches} K1 launches in {applies} applies")
    check(counts["cheb_update"] > 0 and counts["stencil_accum"] > 0
          and all(counts[k] > 0 for k in FUSED.values()),
          f"cart: K4 / K6 / fused K4 launches {counts['stencil_accum']} / "
          f"{counts['cheb_update']} / "
          f"{ {k: counts[k] for k in FUSED.values()} } on the sharded path")
    check(counts["stencil_accum"] == sum(counts[k] for k in FUSED.values()),
          f"cart: an unfused K4 launch on the sharded path: K4 "
          f"{counts['stencil_accum']}, fused "
          f"{ {k: counts[k] for k in FUSED.values()} }")
    check(all(counts[k] > 0 for k in krylov_ctl.NAMES if k != "ir_ctl"),
          f"cart: a control kernel never ran on the sharded path: "
          f"{ {k: counts[k] for k in krylov_ctl.NAMES} }")
    check(counts["a00_apply_keep"] > 0
          and all(counts[k] > 0 for k in K6_MASKED)
          and not any(counts[k] for k in A00_FUSED[1:]),
          f"cart: K1's keep form and K6's masked forms must run on the "
          f"sharded path, K1's store epilogues not: "
          f"{ {k: counts[k] for k in (*A00_FUSED, *K6_MASKED)} }")
    shards, p_steps = CART_DEVICES, slv.dcfg.base.p_cheb_its - 1
    check(counts["mp_apply"] > 0
          and counts["mp_apply"] % (shards * p_steps) == 0
          and not any(counts[f] for f in mp.FORMS[1:]),
          f"cart: K3 {counts['mp_apply']} launches (fused forms "
          f"{ {f: counts[f] for f in mp.FORMS[1:]} }): expected its plain "
          f"form only, {shards} per p-block step ({p_steps} per p-block "
          f"solve)")
    check(all(counts[k] > 0 for k in K5_KERNELS)
          and counts["prolong_parity_add"] == counts["prolong_parity"]
          and counts["restrict_parity_weighted_residual"]
          == counts["restrict_parity"],
          f"cart: K5 launches on the sharded path "
          f"{ {k: counts[k] for k in (*K5_KERNELS, *K5_FUSED)} }: each "
          f"kernel must run, every parity prolongation with its add, every "
          f"parity restriction in the weighted residual form")
    # independent float64 true residual with the port's parity operator
    s1 = r1["solver"]
    op64, aux64 = s1.setup["op64"], tree_aux(s1.setup["op64"])
    F64 = s1.vec_to_tree(r["F"], dtype=torch.float64)
    true = float(torch.linalg.norm(F64 - mult_tree(
        op64, aux64, s1.vec_to_tree(r["X"], dtype=torch.float64))))
    log(f"[cart] true float64 residual {true:.6e}, last monitored "
        f"{r['rnorm']:.6e}, ||F|| {float(torch.linalg.norm(F64)):.6e}")
    check(abs(true - r["rnorm"]) <= 1e-4 * r["rnorm"],
          "cart: the true residual differs from the monitored one")
    # one sharded apply: 2 K1 launches per shard
    n0 = a00.LAUNCHES.n
    slv.blocks.saddle_mult(slv.shard_saddle(r["X"]))
    check(a00.LAUNCHES.n - n0 == 2 * CART_DEVICES,
          "cart: K1 launches per sharded apply")
    log(f"[cart] mx=32 ndof {r['mesh'].ndof} over {CART_DEVICES} shards "
        f"{slv.part.dev_shape} on one card, loop {r['loop']}: {its} its "
        f"(single device {r1['its']}), history relative {hrel:.3e} (worst "
        f"entry {hworst:.3e}), x relative {xrel:.3e}; "
        f"setup {t_setup:.2f} s with graph capture "
        f"{slv.capture_seconds:.2f} s (single device "
        f"{r1['seconds']['setup']:.2f} s), first solve {t_solve:.3f} s "
        f"(single device {r1['seconds']['solve']:.3f} s), {halos} halo "
        f"exchanges, {launches} K1 launches in {applies} applies (single "
        f"device {applies1} applies), K4 {counts['stencil_accum']} (fused "
        f"{ {k: counts[k] for k in FUSED.values()} }), K6 "
        f"{counts['cheb_update']} (masked forms "
        f"{ {k: counts[k] for k in K6_MASKED} }), K1 keep form "
        f"{counts['a00_apply_keep']} applies, K5 "
        f"{ {k: counts[k] for k in (*K5_KERNELS, *K5_FUSED)} }, K3 "
        f"{counts['mp_apply']} (the plain form, {shards} per p-block step: "
        f"{counts['mp_apply'] // (shards * p_steps)} p-block solves), "
        f"control {sum(counts[k] for k in krylov_ctl.NAMES)} launches "
        f"(capture warm-ups included), peak mem {peak:.2f} GiB ({card})")
    _cart_loops(slv, r1["solver"], r["F"], r, card)
    _cart_kernels(slv)
    _cart_k1(slv, r1["solver"], card)

    def true_residual(X):
        return float(torch.linalg.norm(F64 - mult_tree(
            op64, aux64, s1.vec_to_tree(X, dtype=torch.float64))))
    ref = {"its": its, "reason": r["reason"], "history": h, "X": r["X"],
           "F": r["F"], "setup": t_setup, "solve": t_solve,
           "true_residual": true_residual}
    return counts, ref


# phase cart's loop kinds over the driver's sharded setup, and the
# single-device float64 solve, alternated; the plain driver and the host
# loop once each (7-9 s a solve on the H100, the rest under 1 s)
CART_ORDER = ("device", "plain", "single", "host", "device", "single")


def _launch_counts():
    """Every kernel's launches so far by the kernels line's names; K1 as
    (launches, applies)."""
    return {"a00_apply": (a00.LAUNCHES.n, a00.LAUNCHES.applies),
            "stencil_accum": stencil.LAUNCHES.n,
            "cheb_update": cheb.LAUNCHES.n,
            **{FUSED[e]: stencil.LAUNCHES.fused[e]
               for e in stencil.EPILOGUES}, **krylov_ctl.LAUNCHES.n,
            **_k5_counts(), **{f: a00.LAUNCHES.by[f] for f in A00_FUSED},
            **{f: cheb.LAUNCHES.by[f] for f in K6_MASKED},
            **{f: mp.LAUNCHES.by[f] for f in mp.FORMS}}


def _cart_solve(slv, F):
    """One solve with its wall seconds, its launch counts, the device
    loop's graph launches, host-moved counts and CUDA-event span of the
    graph launch (a device-loop solve runs under sync debug "error")."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    graph = getattr(getattr(slv, "_dev", None), "graph", None)
    out = {"graph_launches": 0, "span": None}
    mode = torch.cuda.get_sync_debug_mode()
    if graph is not None:
        g0 = graph.launches
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        launch = graph.launch

        def timed():
            ev[0].record()
            launch()
            ev[1].record()
        graph.launch = timed
        torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    try:
        res = slv.solve(F)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
        if graph is not None:
            del graph.launch
    torch.cuda.synchronize()
    out.update(res=res, wall=time.perf_counter() - t0,
               counts=_launch_counts(),
               peak=torch.cuda.max_memory_allocated() / 2 ** 30)
    if graph is not None:
        out.update(graph_launches=graph.launches - g0,
                   host_launches=getattr(slv._dev, "host_launches", None),
                   span=ev[0].elapsed_time(ev[1]) / 1e3)
    return out


def _cart_loops(slv, single, F, r, card):
    """The device loop (the driver's solver), the plain driver and the host
    loop over the driver's sharded setup, beside the single-device float64
    solve, alternated (CART_ORDER): the device loop one graph launch with no
    kernel issued by the host, under sync debug "error"; x, its and history
    bitwise the plain driver's and the host loop's, with equal K1, K4, K6,
    control and halo counts per solve (the host loop: no control kernel);
    each kind's wall with the card. Then the witness: the device loop with
    every K5 entry swapped for its twin, bitwise the kernels' solve."""
    solvers = {"device": slv, "plain": slv.with_loop("plain"),
               "host": slv.with_loop("host"), "single": single}
    runs = {k: [] for k in solvers}
    for kind in CART_ORDER:
        runs[kind].append(_cart_solve(solvers[kind], F))
    first = {k: v[0] for k, v in runs.items()}
    d = first["device"]
    for kind, recs in runs.items():
        q = recs[0]["res"]
        same = all(p["res"]["its"] == q["its"]
                   and p["res"]["history"] == q["history"]
                   and np.array_equal(p["res"]["x"], q["x"]) for p in recs)
        check(same, f"cart: repeated {kind} solves differ")
        check(q["reason"] == "CONVERGED_RTOL" and q["its"] == r["its"],
              f"cart: {kind} solve {q['reason']} in {q['its']} its")
    for q in runs["device"]:
        check(q["graph_launches"] == 1 and q["host_launches"] == 0,
              f"cart: a device-loop solve made {q['graph_launches']} graph "
              f"launches and moved {q['host_launches']} counts from the "
              f"host")
    check(np.array_equal(d["res"]["x"], r["X"]),
          "cart: the device loop's solve differs from the driver's")
    for kind in ("plain", "host"):
        q = first[kind]
        check(q["res"]["history"] == d["res"]["history"]
              and np.array_equal(q["res"]["x"], d["res"]["x"]),
              f"cart: the device loop and the {kind} loop differ (x "
              f"relative {_rel(q['res']['x'], d['res']['x']):.3e})")
        check(q["res"]["halo_exchanges"] == d["res"]["halo_exchanges"],
              f"cart: halo exchanges per solve: device "
              f"{d['res']['halo_exchanges']}, {kind} "
              f"{q['res']['halo_exchanges']}")
        keys = d["counts"] if kind == "plain" else (
            "a00_apply", "stencil_accum", "cheb_update", *FUSED.values(),
            *K5_KERNELS, *K5_FUSED, *A00_FUSED, *K6_MASKED, *mp.FORMS)
        check(all(q["counts"][k] == d["counts"][k] for k in keys),
              f"cart: launches per solve: device {d['counts']}, {kind} "
              f"{q['counts']}")
    check(d["counts"]["cheb_update"] > 0,
          "cart: K6 never ran in a sharded solve")
    c = d["counts"]
    # a cart V-cycle's fused residuals: the L-2 level on every shard and
    # each replicated stencil level once
    nlev = slv.dcfg.base.nlevels
    shards = len(slv.blocks.ops.parts)
    vcycles = c["stencil_residual"] / (shards + nlev - 3)
    k5 = sum(c[k] for k in K5_KERNELS)
    check(k5 == (2 * shards + 2 * (nlev - 2)) * vcycles,
          f"cart: {k5} K5 launches in {vcycles} V-cycles, expected "
          f"{2 * shards + 2 * (nlev - 2)} per V-cycle")
    _check_k5_cheb_first(c, vcycles, nlev, c["cheb_update"],
                         "cart device-loop solve")
    wres = c["restrict_parity_weighted_residual"]
    check(wres == shards * vcycles and c["restrict_parity"] == wres,
          f"cart: {wres} weighted residual restrictions of "
          f"{c['restrict_parity']} in {vcycles} V-cycles, expected "
          f"{shards} per V-cycle and no unfused one")
    # the witness: the device loop over the same setup with every K5 entry,
    # K1's keep form and K6's masked forms swapped for their twins gives
    # the kernels' bits (each is bitwise its twin)
    swaps = ([(transfer, n, t) for n, t in transfer.TWINS.items()]
             + [(a00, "a00_apply", a00.TWINS["a00_apply"])]
             + [(cheb, n, cheb.TWINS[n]) for n in K6_MASKED])
    saved = [(mod, n, getattr(mod, n)) for mod, n, _ in swaps]
    for mod, n, twin in swaps:
        setattr(mod, n, twin)
    try:
        tw = _cart_solve(slv.with_loop("device"), F)
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)
    tk5 = sum(tw["counts"][k] for k in K5_KERNELS)
    tfused = {k: tw["counts"][k] for k in (*A00_FUSED, *K6_MASKED)}
    check(tw["res"]["history"] == d["res"]["history"]
          and np.array_equal(tw["res"]["x"], d["res"]["x"]) and tk5 == 0
          and not any(tfused.values())
          and tw["counts"]["a00_apply"] == c["a00_apply"],
          f"cart: with the twins the device loop differs from the kernels' "
          f"(x relative {_rel(tw['res']['x'], d['res']['x']):.3e}) or ran "
          f"{tk5} K5 launches, fused K1 / masked K6 {tfused}, K1 "
          f"{tw['counts']['a00_apply']} against {c['a00_apply']}")
    # the order witness: K3's plain form swapped for mp_apply_plain (the
    # factored form, its element products summed per call), float64: the
    # same iterations and reason, x within 1e-10
    saved = mp.mp_apply
    mp.mp_apply = K3_PARENT["mp_apply"]
    try:
        ow = _cart_solve(slv.with_loop("device"), F)
    finally:
        mp.mp_apply = saved
    oxrel = _rel(ow["res"]["x"], d["res"]["x"])
    check(ow["res"]["its"] == d["res"]["its"]
          and ow["res"]["reason"] == d["res"]["reason"]
          and ow["counts"]["mp_apply"] == 0 and oxrel <= 1e-10,
          f"cart: with K3 swapped for mp_apply_plain {ow['res']['its']} its "
          f"/ {ow['res']['reason']} (the kernels' {d['res']['its']} / "
          f"{d['res']['reason']}), {ow['counts']['mp_apply']} K3 launches, "
          f"x differs by {oxrel:.3e}")
    log(f"[cart] order witness: the device loop with K3 swapped for "
        f"mp_apply_plain: {ow['res']['its']} its / {ow['res']['reason']} "
        f"(equal), x bitwise "
        f"{bool(np.array_equal(ow['res']['x'], d['res']['x']))}, differs "
        f"by {oxrel:.3e} (norm-relative); 0 K3 launches against "
        f"{c['mp_apply']}; wall {ow['wall']:.4f} s ({card})")
    log(f"[cart] witness: the device loop with every K5 entry, K1's keep "
        f"form and K6's masked forms swapped for their twins, "
        f"{tw['res']['its']} its, 0 K5 launches, no fused K1 or masked K6 "
        f"launch, K1 {tw['counts']['a00_apply'][0]} launches (equal), K6 "
        f"{tw['counts']['cheb_update']} (the kernels' solve "
        f"{c['cheb_update']}), x and history bitwise the kernels' solve; "
        f"wall {tw['wall']:.4f} s ({card})")
    log(f"[cart] loops over one setup: device loop bitwise the plain "
        f"driver and the host loop ({d['res']['its']} its, x, history), "
        f"each device solve 1 graph launch under sync debug \"error\", 0 "
        f"host-issued launches; per solve K1 {c['a00_apply'][0]} launches "
        f"in {c['a00_apply'][1]} applies, K4 {c['stencil_accum']} (fused "
        f"{ {k: c[k] for k in FUSED.values()} }), K6 "
        f"{c['cheb_update']}, K5 {k5} ({k5 / vcycles:g} per V-cycle: "
        f"{ {k: c[k] for k in (*K5_KERNELS, *K5_FUSED)} }), K3 "
        f"{c['mp_apply']}, control "
        f"{ {k: c[k] for k in krylov_ctl.NAMES} }, "
        f"{d['res']['halo_exchanges']} halo exchanges ({card})")
    for kind, recs in runs.items():
        walls = [q["wall"] for q in recs]
        its = recs[0]["res"]["its"]
        spans = ", ".join(f"{q['span']:.4f}" for q in recs
                          if q["span"] is not None)
        span = f", graph launch span by CUDA events {spans} s" if spans \
            else ""
        wl = ", ".join(f"{w:.4f}" for w in walls)
        log(f"[cart] {kind}: walls {wl} "
            f"s (mean {np.mean(walls):.4f}), {1e3 * np.mean(walls) / its:.2f} "
            f"ms/outer it, {its} its{span}, peak mem "
            f"{max(q['peak'] for q in recs):.2f} GiB ({card})")


def _cart_kernels(slv):
    """K1, K4, K5's weighted residual restriction and K6 on the sharded
    solve's own placed operands, each wrapper against its plain twin on
    the same seeded inputs: K1 on each
    shard's local box within TOL (phase K1's, relative to max |y|); K4 on
    each shard's L-2 slab stencil with the ghosted operand lvl1A builds
    (ghost_extend_axis) and on the replicated deep stencils with their
    zero ghosts, within K4_TOL of max sum |W||x| (phase mg_kernels');
    K6's first and step updates on each shard's fine, L-2 and p inverse
    diagonals and the replicated levels', bit for bit. Float64, as the
    cart path runs them."""
    from exsaddle_tpu_torch.parallel.shard_mesh import ghost_extend_axis
    f64 = torch.float64
    dd, blk, smesh = slv.ddata, slv.blocks, slv.smesh
    nd, nlev = blk.nd, slv.dcfg.base.nlevels
    rng = np.random.default_rng(13)

    def rand(t):
        return torch.as_tensor(rng.standard_normal(tuple(t.shape)),
                               dtype=t.dtype, device=t.device)

    k1 = 0.0
    for i, op in enumerate(blk.ops.parts):
        x = torch.as_tensor(rng.standard_normal(op.nu), dtype=f64,
                            device=op.Bs.device)
        y, yp = a00.a00_apply(op, x), a00.a00_apply_plain(op, x)
        rel = float((y - yp).abs().max() / yp.abs().max())
        check(bool(torch.isfinite(y).all()) and rel <= TOL[f64],
              f"cart: K1 on shard {i}'s box disagrees with its plain "
              f"version (relative {rel:.3e})")
        k1 = max(k1, rel)
        # the keep in K1's loads and K6's masked forms on the shard's own
        # keep / mask and fine inverse diagonal
        ks, ms = blk.aux[0].parts[i], blk.aux[1].parts[i]
        d = dd["inv_diag_fine"].parts[i]
        b, q = rand(x), rand(x)
        yk = a00.a00_apply(op, x, keep=ks)
        pairs = [(yk, a00.a00_apply(op, x * ks)),
                 (cheb.cheb_first_masked(b, yk, ks, ms, d, x, 0.37),
                  cheb.cheb_first_masked_plain(b, yk, ks, ms, d, x, 0.37)),
                 (cheb.cheb_step_masked(b, yk, ks, ms, d, x, q, 0.37, 1.61),
                  cheb.cheb_step_masked_plain(b, yk, ks, ms, d, x, q, 0.37,
                                              1.61))]
        check(all(_same_bits(a, w) for a, w in pairs),
              f"cart: K1's keep form or K6's masked forms on shard {i} are "
              f"not bitwise their twins")

    xp = dd["inv_diag_l1"].map(rand)
    for k in range(nd):
        xp = ghost_extend_axis(smesh, xp, nd - 1 - k)
    pad = (0, 0) + (1, 1) * nd
    k4 = [(f"L-2 shard {i}", W, x)
          for i, (W, x) in enumerate(zip(dd["W1"].parts, xp.parts))]
    # the replicated deep levels: repl_vcycle(k) applies stencils[k - 1]
    # to grids of inv_diag_repl[k - 1]'s shape
    for dev, rep in dd["repl"].items():
        for k, (W, d) in enumerate(zip(rep["stencils"],
                                       rep["inv_diag_repl"])):
            k4.append((f"L-{nlev - k - 1} on {dev}", W,
                       torch.nn.functional.pad(rand(d), pad)))
    k4_worst, nfused = 0.0, 0
    for name, W, x in k4:
        y, yp = stencil.stencil_accum(W, x), stencil.stencil_accum_plain(W, x)
        mag = float(stencil.stencil_accum_plain(W.abs(), x.abs()).max())
        err = float((y - yp).abs().max())
        check(bool(torch.isfinite(y).all()) and err <= K4_TOL[f64] * mag,
              f"cart: K4 {name} max_abs_err {err:.3e} > {K4_TOL[f64]:g} x "
              f"{mag:.3e}")
        k4_worst = max(k4_worst, err / mag)
        # the fused epilogues on these operands: padded on the shards (as
        # their smoothers call them), zero-boundary on the replicated
        # levels, each bitwise this K4 apply followed by K6 / the
        # subtraction
        shard = name.startswith("L-2 shard")
        xc = x[1:-1, 1:-1, 1:-1].contiguous()
        v = x if shard else xc
        b, d, q = (rand(xc) for _ in range(3))
        pairs = [(stencil.stencil_residual(W, v, b, padded=shard), b - y),
                 (stencil.stencil_cheb_first(W, v, b, d, 0.37,
                                             padded=shard),
                  cheb.cheb_first(b, y, d, xc, 0.37)),
                 (stencil.stencil_cheb_step(W, v, b, d, q, 0.37, 1.61,
                                            padded=shard),
                  cheb.cheb_step(b, y, d, xc, q, 0.37, 1.61))]
        check(all(_same_bits(a, w) for a, w in pairs),
              f"cart: a fused K4 epilogue on {name} is not bitwise K4 + K6 "
              f"/ the subtraction")
        nfused += len(pairs)

    levels = [("fine", dd["inv_diag_fine"].parts, dd["bounds"][-1]),
              ("L-2", dd["inv_diag_l1"].parts, dd["bounds"][nlev - 3]),
              ("p", dd["inv_diag_p"].parts, dd["p_bounds"])]
    for rep in dd["repl"].values():
        levels += [(f"L-{nlev - k - 1}", [d], dd["bounds"][k])
                   for k, d in enumerate(rep["inv_diag_repl"])]
    # K3 on each shard's local box: its own stencil, against the plain
    # version on its own pscale and Np
    from types import SimpleNamespace
    k3 = 0.0
    for i, (op, ps, W) in enumerate(zip(blk.ops.parts, dd["pscale"].parts,
                                        blk.mp_w.parts)):
        x = rand(dd["inv_diag_p"].parts[i])
        y, yp = mp.mp_apply(op, ps, W, x), mp.mp_apply_plain(op, ps, x)
        mag = float(mp.mp_apply_plain(
            SimpleNamespace(m_el=op.m_el, nn_p=op.nn_p, Np=op.Np.abs()),
            ps.abs(), x.abs()).max())
        err = float((y - yp).abs().max())
        check(bool(torch.isfinite(y).all()) and err <= K4_TOL[f64] * mag,
              f"cart: K3 on shard {i}'s box max_abs_err {err:.3e} > "
              f"{K4_TOL[f64]:g} x {mag:.3e}")
        k3 = max(k3, err / mag)
    # K5's weighted residual restriction on each shard's own ownership
    # weights and local parity layout
    mloc, cls_loc = slv.dcfg.mloc, slv.dcfg.cls_shapes_loc
    for i, w in enumerate(blk.w_u.parts):
        b, y = rand(w), rand(w)
        check(_same_bits(
            transfer.restrict_parity_weighted_residual(b, y, w, cls_loc,
                                                       mloc),
            transfer.restrict_parity_plain(w * (b - y), cls_loc, mloc)),
            f"cart: K5's weighted residual restriction on shard {i} is not "
            f"bitwise its twin")
    k6 = 0
    for name, diags, (emin, emax) in levels:
        scale, omega = _cheb_scalars(emin, emax)
        for i, d in enumerate(diags):
            b, ap, pk, pkm1 = (rand(d) for _ in range(4))
            pairs = [(cheb.cheb_first(b, None, d, pk, scale),
                      cheb.cheb_first_plain(b, None, d, pk, scale)),
                     (cheb.cheb_first(b, ap, d, pk, scale),
                      cheb.cheb_first_plain(b, ap, d, pk, scale)),
                     (cheb.cheb_step(b, ap, d, pk, pkm1, scale, omega),
                      cheb.cheb_step_plain(b, ap, d, pk, pkm1, scale,
                                           omega))]
            same = all(torch.equal(a.view(torch.int64), w.view(torch.int64))
                       for a, w in pairs)
            err = max(float((a - w).abs().max()) for a, w in pairs)
            check(same, f"cart: K6 {name} on part {i} is not bitwise its "
                  f"twin (max_abs_err {err:.3e})")
            k6 += len(pairs)
    log(f"[cart] kernels on the sharded solve's own operands, float64: K1 "
        f"on each of the {len(blk.ops.parts)} local boxes {slv.dcfg.mloc} "
        f"within {k1:.3e} of max |y| (tol {TOL[f64]:g}), its keep form "
        f"and K6's masked forms on each shard's own keep, mask and fine "
        f"diagonal bitwise their twins; K4 on "
        f"{len(k4)} stencils ({', '.join(n for n, _, _ in k4)}) within "
        f"{k4_worst:.3e} of max sum |W||x| (tol {K4_TOL[f64]:g}), their "
        f"{nfused} fused epilogues bitwise K4 + K6 / the subtraction; K3 on "
        f"each shard's box and stencil within {k3:.3e} of the apply over "
        f"absolute values (tol {K4_TOL[f64]:g}); K5's "
        f"weighted residual restriction on every shard's own weights "
        f"bitwise its twin; K6 first "
        f"and step on every part's fine, L-2 and p inverse diagonals and "
        f"the replicated levels': {k6} updates bitwise their twins")


def _cart_k1(slv, single, card):
    """K1 per shard against K1 on the whole mesh, float64 as the cart path
    runs it: one apply on every shard's local box, back to back inside a
    CUDA graph (as the device loop issues them), against one apply of the
    single-device operator; each with its bound."""
    ops = slv.blocks.ops.parts
    rng = np.random.default_rng(11)
    xs = [torch.as_tensor(rng.standard_normal(o.nu), device=o.Bs.device)
          for o in ops]
    op1 = single.data["op"]
    x1 = torch.as_tensor(rng.standard_normal(op1.nu), device=op1.Bs.device)
    n = 20
    shards_ms = _graph_ms([lambda: [a00.a00_apply(o, x)
                                    for o, x in zip(ops, xs)]] * n)
    one_ms = _graph_ms([lambda: a00.a00_apply(op1, x1)] * n)
    b_shard, by_shard = k1_bound(ops[0], torch.float64)
    b_one, by_one = k1_bound(op1, torch.float64)
    log(f"[cart] K1 float64 per shard: one apply on each of the "
        f"{len(ops)} local boxes {slv.dcfg.mloc} {1e3 * shards_ms:.2f} us "
        f"({1e3 * shards_ms / len(ops):.2f} us per shard apply, bound "
        f"{1e3 * b_shard:.2f} us by {by_shard}), one apply on the whole "
        f"mesh {1e3 * one_ms:.2f} us (bound {1e3 * b_one:.2f} us by "
        f"{by_one}): the shards' applies take {shards_ms / one_ms:.2f}x the "
        f"single device's ({n} of each replayed in one CUDA graph; {card})")


# phase cart_procs: processes x shards per process, all on this card; a
# message or collective that never completes fails the group after
# PROCS_GROUP_TIMEOUT seconds, the whole phase after PROCS_DEADLINE
CART_PROCS, CART_PROCS_SHARDS = 2, 2
# history and x of the group's driver run (HostComm setup) against phase
# cart's, norm-relative: phase cart's bound on x of the sharded solve
# against the single device (a CPU run of mx=4 over the same layout read
# 1.5e-12 and 4.2e-12, the H100 at mx=32 1.2e-11 and 7.8e-13)
PROCS_TOL = 1e-9
PROCS_GROUP_TIMEOUT, PROCS_DEADLINE = 120, 480


def _free_port():
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _procs_child(rank, init_method, out_dir):
    """One process of phase cart_procs: the flagship through
    driver.saddle_solve in the group ([cuda:0] * CART_PROCS_SHARDS, a
    HostComm setup), one sharded apply's K1 launches, then the same shards
    with the setup every process builds alone (the one-process setup) on
    phase cart's F. Saves its numbers to out_dir."""
    from exsaddle_tpu_torch.parallel import multihost
    from exsaddle_tpu_torch.parallel.cart_abf import (CartABFSolver,
                                                      build_cart_abf)
    multihost.initialize(init_method, CART_PROCS, rank,
                         timeout=PROCS_GROUP_TIMEOUT)
    try:
        device = torch.device("cuda", 0)
        devices = [device] * CART_PROCS_SHARDS
        opts = Options.from_args(CART_ARGV)
        torch.cuda.init()           # the peak-memory counters need it
        torch.cuda.reset_peak_memory_stats(device)
        a00.LAUNCHES.reset()
        r = tdriver.saddle_solve(opts, 3, log=lambda *a: None,
                                 devices=devices)
        launches, applies = a00.LAUNCHES.n, a00.LAUNCHES.applies
        peak = torch.cuda.max_memory_allocated(device)
        slv = r["solver"]
        traffic = dict(slv.smesh.traffic)
        halos = r["res"]["halo_exchanges"]
        n0 = a00.LAUNCHES.n
        slv.blocks.saddle_mult(slv.shard_saddle(r["X"]))
        per_apply = a00.LAUNCHES.n - n0
        fine = r["levels"][-1]
        ctx = emodels.ModelContext(Options.from_args(CART_ARGV), 3,
                                   log=lambda *a, **k: None)
        t0 = time.perf_counter()
        _, ddata, setup = build_cart_abf(slv.part, ctx, fine.bc_idx,
                                         fine.bc_vals,
                                         nlevels=slv.dcfg.base.nlevels)
        alone = CartABFSolver.from_parts(slv.part, slv.dcfg, ddata, setup,
                                         devices)
        t_setup = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ra = alone.solve(np.load(os.path.join(out_dir, "F.npy")))
        torch.cuda.synchronize()
        t_solve = time.perf_counter() - t0
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 X=r["X"], its=r["its"], reason=r["reason"],
                 history=np.array(r["history"]), rnorm=r["rnorm"],
                 setup=r["seconds"]["setup"], solve=r["seconds"]["solve"],
                 launches=launches, applies=applies, per_apply=per_apply,
                 peak=peak, halos=halos,
                 shards=np.array(slv.smesh.shards),
                 dev_shape=np.array(slv.part.dev_shape),
                 **{f"traffic_{k}": v for k, v in traffic.items()},
                 X_alone=ra["x"], its_alone=ra["its"],
                 history_alone=np.array(ra["history"]),
                 setup_alone=t_setup, solve_alone=t_solve)
    finally:
        torch.distributed.destroy_process_group()


def phase_cart_procs(card, ref):
    """The flagship in CART_PROCS processes x CART_PROCS_SHARDS shards on
    this card, held against phase cart's one-process 4-shard solve `ref`;
    returns the K1 (launches, applies) of the group's driver runs, summed
    over the ranks."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "F.npy"), ref["F"])
        t0 = time.perf_counter()
        ctx = mp.spawn(_procs_child, nprocs=CART_PROCS, join=False, args=(
            f"tcp://localhost:{_free_port()}", tmp))
        try:
            while not ctx.join(timeout=5):
                check(time.perf_counter() - t0 < PROCS_DEADLINE,
                      f"cart_procs: the group ran past {PROCS_DEADLINE} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(timeout=30)
        wall = time.perf_counter() - t0
        ranks = [dict(np.load(os.path.join(tmp, f"rank{k}.npz")))
                 for k in range(CART_PROCS)]
    h0, X0 = ref["history"], ref["X"]
    for k, g in enumerate(ranks):
        its = int(g["its"])
        check(g["dev_shape"].tolist() == [1, 2, 2] and g["shards"].tolist()
              == list(range(k * CART_PROCS_SHARDS,
                            (k + 1) * CART_PROCS_SHARDS)),
              f"cart_procs: rank {k} held shards {g['shards'].tolist()} of "
              f"{g['dev_shape'].tolist()}")
        check(its == ref["its"] and str(g["reason"]) == ref["reason"]
              == "CONVERGED_RTOL",
              f"cart_procs: rank {k} {g['reason']} in {its} its, one "
              f"process {ref['reason']} in {ref['its']}")
        # the HostComm setup sums each node's box contributions per process
        # first, so its last bits differ from the one-process setup's and
        # the solve carries that (PROCS_TOL); the one-process-setup leg
        # below is bitwise
        h = g["history"]
        check(h.shape == h0.shape, f"cart_procs: rank {k} history of "
              f"{h.size} entries, one process {h0.size}")
        hrel, xrel = _rel(h, h0), _rel(g["X"], X0)
        hworst = float(np.max(np.abs(h - h0) / h0))
        check(hrel <= PROCS_TOL and xrel <= PROCS_TOL,
              f"cart_procs: rank {k} history relative {hrel:.3e}, x "
              f"relative {xrel:.3e}")
        check(np.array_equal(g["X"], ranks[0]["X"]),
              f"cart_procs: ranks 0 and {k} return different X")
        check(int(g["per_apply"]) == 2 * CART_PROCS_SHARDS,
              f"cart_procs: rank {k} made {int(g['per_apply'])} K1 "
              f"launches per sharded apply")
        n, a = int(g["launches"]), int(g["applies"])
        check(n > 0 and n == 2 * a and a % CART_PROCS_SHARDS == 0,
              f"cart_procs: rank {k} made {n} K1 launches in {a} applies")
        alone_same = (int(g["its_alone"]) == ref["its"]
                      and np.array_equal(g["history_alone"], h0)
                      and np.array_equal(g["X_alone"], X0))
        check(alone_same, f"cart_procs: rank {k}'s solve with the "
              f"one-process setup is not bitwise phase cart's (x relative "
              f"{_rel(g['X_alone'], X0):.3e})")
        true = ref["true_residual"](g["X"])
        check(abs(true - float(g["rnorm"])) <= 1e-4 * float(g["rnorm"]),
              f"cart_procs: rank {k}'s true residual {true:.6e} against "
              f"the monitored {float(g['rnorm']):.6e}")
        log(f"[cart_procs] rank {k}: {its} its, history relative "
            f"{hrel:.3e} (worst entry {hworst:.3e}, max |diff| "
            f"{np.abs(h - h0).max():.3e}), x "
            f"relative {xrel:.3e} (max |diff| "
            f"{np.abs(g['X'] - X0).max():.3e}) against one process; true "
            f"float64 residual {true:.6e}; setup "
            f"{float(g['setup']):.2f} s, solve {float(g['solve']):.3f} s, "
            f"{1e3 * float(g['solve']) / its:.1f} ms per outer it (one "
            f"process {1e3 * ref['solve'] / ref['its']:.1f}); "
            f"{int(g['traffic_messages'])} messages "
            f"{int(g['traffic_bytes'])} B sent, "
            f"{int(g['traffic_gathers'])} gathers "
            f"{int(g['traffic_gather_bytes'])} B given, "
            f"{int(g['halos'])} halo exchanges; {n} K1 launches in {a} "
            f"applies, {int(g['per_apply'])} per sharded apply; peak mem "
            f"{int(g['peak']) / 2 ** 30:.2f} GiB; with the one-process "
            f"setup: bitwise, setup {float(g['setup_alone']):.2f} s, solve "
            f"{float(g['solve_alone']):.3f} s ({card})")
    log(f"[cart_procs] mx=32 ndof {X0.size} in {CART_PROCS} processes x "
        f"{CART_PROCS_SHARDS} shards on one card (device grid 1x2x2, host "
        f"axis z): both ranks the same X; phase {wall:.1f} s ({card})")
    return (sum(int(g["launches"]) for g in ranks),
            sum(int(g["applies"]) for g in ranks))


# the bench phase's schedules beside the tuned one, and the (rounds, inner
# its) bands of each around the first card run's counts of the code path
# (abf.opts 3 / 35, fixed3 4 / 72 on an H100, PERF.md section 6; tuned
# 3 / 27 since the K4 kernel): rounds +-1 and not below 3, inner its +-20%,
# since float32 perturbations of 1e-7 move them by ~10%. The tuned band
# before K4 (4 / 37 on an H100 with the plain stencil) holds the
# tuned solve with K4's plain twin swapped in (_bench_twin_witness): the
# evidence that K4's float32 summation order alone moved the tuned count.
BENCH_OTHERS = {"abfopts": bench.ABFOPTS_KW, "fixed3": {"u_fixed_vcycles": 3}}
BENCH_BANDS = {"solve_": ((3, 4), (22, 32)),
               "solve_abfopts_": ((3, 4), (28, 42)),
               "solve_fixed3_": ((3, 5), (58, 86))}
BENCH_TWIN_BAND = ((3, 5), (30, 44))
BENCH_INNER = 100


def _bench_twin_witness(device, card, extras):
    """The bench's tuned float32 IR solve at mx=32 over one new setup of
    its own, with K4 and again with every K4 entry swapped for its plain
    twin (captured into the second solver's graph; the twins of the fused
    entries apply the stencil, then compute K6's update or the residual
    in torch ops, bitwise K6; K6 itself stays): the K4 solve must give
    the bench's tuned rounds and inner its (a code path's counts are
    deterministic) with every stencil apply fused, the twin solve the
    pre-K4 band BENCH_TWIN_BAND and no K4 launch, each converged to a
    true 1e-8. The K4 solve's K3 and K6 launches are checked
    (_check_k3); a third solve over the same setup with K3's entries
    swapped for the parent's routing (mp_apply_plain, then K6) is the
    order witness: its rounds and inner its are logged beside the
    kernel's."""
    prob = bench._build_problem(32, with_rhs=True)
    slv = tabf.ABFSolver(prob["mesh"], prob["fes"], prob["coeff"],
                         prob["bc_idx"], prob["bc_vals"], device=device,
                         dtype=torch.float32,
                         nlevels=bench.bench_nlevels(prob["mesh"]), ir=True,
                         **bench.bench_solver_kw())
    F = prob["F_raw"] + slv.setup["rhs_diri"]
    solvers = {"K4": slv}
    for name, swaps in (("twin", _k4_twins()),
                        ("K3 parent", [(mp, n, fn)
                                       for n, fn in K3_PARENT.items()])):
        saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in swaps]
        for mod, attr, fn in swaps:
            setattr(mod, attr, fn)
        try:
            solvers[name] = tabf.ABFSolver.from_parts(
                slv.cfg, slv.data, slv.setup, device=device,
                dtype=torch.float32, ir=True)
        finally:
            for mod, attr, fn in saved:
                setattr(mod, attr, fn)
    out = {}
    nlev = slv.cfg.nlevels
    for name, s in solvers.items():
        rec = _ir_solve(s, F)
        res = rec["res"]
        out[name] = (res["rounds"], res["inner_its"], rec["mg"])
        if name == "K4":
            # the twin solve has no fused residual to count V-cycles by
            per_vc, vcycles = _k5_per_vcycle(rec["k5"], rec["mg"][2], nlev)
            log(f"[bench] tuned solve: K5 "
                f"{sum(rec['k5'][k] for k in K5_KERNELS)} launches in "
                f"{vcycles:g} V-cycles, {per_vc:g} per V-cycle "
                f"({rec['k5']}) ({card})")
            check(per_vc == 2 * (nlev - 1),
                  f"bench: {per_vc} K5 launches per V-cycle of the tuned "
                  f"solve, expected {2 * (nlev - 1)}")
            _check_k5_cheb_first(rec["k5"], vcycles, nlev, rec["mg"][1],
                                 "bench tuned solve")
            p_solves = _check_k3(rec, vcycles, slv.cfg, "bench tuned solve")
            log(f"[bench] tuned solve: K6 {rec['mg'][1]} launches = "
                f"{vcycles:g} fine + {p_solves:g} p-block zero-guess first "
                f"steps; K3 {rec['k3']['mp_cheb_step']} mp_cheb_step "
                f"launches ({card})")
        if name == "K3 parent":
            k = out["K4"]
            log(f"[bench] order witness, the tuned solve with K3's entries "
                f"swapped for the parent's routing (mp_apply_plain, then "
                f"K6): {res['rounds']} rounds / {res['inner_its']} inner its "
                f"against the kernel's {k[0]} / {k[1]} (counts equal "
                f"{(res['rounds'], res['inner_its']) == k[:2]}); K3 "
                f"launches {sum(rec['k3'].values())} ({card})")
        log(f"[bench] tuned solve with {name} ({s.loop} loop): "
            f"{res['rounds']} rounds, {res['inner_its']} inner its, "
            f"{rec['wall']:.3f} s, K4 / K6 launches {rec['mg'][0]} / "
            f"{rec['mg'][1]} (K4 fused residual / cheb_first / cheb_step "
            f"{rec['mg'][2]} / {rec['mg'][3]} / {rec['mg'][4]}), true float64 "
            f"relative residual {res['rnorm'] / res['rnorm0']:.3e} ({card})")
        check(res["converged"] and not res["stalled"]
              and res["rnorm"] <= 1e-8 * res["rnorm0"],
              f"bench twin witness: the {name} solve did not converge")
    (rk, ik, nk), (rt, it, nt) = out["K4"], out["twin"]
    (r0, r1), (i0, i1) = BENCH_TWIN_BAND
    check((rk, ik) == (extras["solve_ir_rounds"], extras["solve_outer_its"])
          and nk[0] > 0 and nk[0] == sum(nk[2:]),
          f"bench twin witness: K4 {rk} / {ik} with K4 / K6 / fused "
          f"launches {nk}, the bench's tuned solve "
          f"{extras['solve_ir_rounds']} / {extras['solve_outer_its']}")
    check(nt[0] == 0 and r0 <= rt <= r1 and i0 <= it <= i1,
          f"bench twin witness: twin {rt} / {it} ({nt[0]} K4 launches) "
          f"outside the pre-K4 band {r0}-{r1} / {i0}-{i1}")
    del slv, solvers


def phase_bench(device, card):
    """The port's bench at mx=32 (apply and solve legs); prints its JSON
    line and returns the K1 (launches, applies) and the K5 launches of
    the bench's run, and the schedules' counts outside BENCH_BANDS (one
    message each; main raises them after the kernels line)."""
    torch.cuda.synchronize()
    a00.LAUNCHES.reset()
    transfer.LAUNCHES.reset()
    t0 = time.perf_counter()
    extras = bench.bench_apply(32, BENCH_INNER, 5, device)
    t_apply = time.perf_counter() - t0
    extras.update(bench.bench_solve(32, 1e-8, device, others=BENCH_OTHERS))
    launches, applies = a00.LAUNCHES.n, a00.LAUNCHES.applies
    k5 = _k5_counts()
    log(json.dumps(bench.result_line(extras, 32, 1e-8, device)))
    kb = extras["kernel_breakdown"]
    roof, cal = kb["roofline"], kb["device_calibration"]
    log(f"[bench] apply mx=32: graph replay {extras['t_apply_us']:.2f} us "
        f"(min/median/max {kb['apply_spread_us']}), eager "
        f"{extras['t_apply_eager_us']:.2f} us ({kb['apply_eager_spread_us']}),"
        f" normloop {kb['apply_normloop_us']:.2f} us; effective CSR "
        f"{extras['effective_csr_gbs']} GB/s, {extras['apply_tflops']} "
        f"TFLOP/s, {roof['fraction_of_floor']} of the data-sheet floor "
        f"{roof['t_floor_us']} us, {roof['fraction_of_shape_ceiling']} of the "
        f"shape ceiling {cal['t_2gemm_shape_us']} us; triad "
        f"{cal['stream_gbs']} GB/s, 4096^3 GEMM {cal['gemm4k_f32_tflops']} "
        f"TFLOP/s; power rho {kb['power_rho']:.6g}; {t_apply:.1f} s ({card})")
    check(extras["apply_timing"] == "graph", "bench: the apply was not "
          "timed as a CUDA graph replay")
    check(kb["graph_bitwise_equal"], "bench: the graph replay differs from "
          "the eager apply loop")
    check(kb["k1_launches_per_loop"] == 2 * BENCH_INNER,
          f"bench: {kb['k1_launches_per_loop']} K1 launches in one eager "
          f"loop of {BENCH_INNER} applies")
    misses = []
    for pre, ((r0, r1), (i0, i1)) in BENCH_BANDS.items():
        rounds, its = extras[pre + "ir_rounds"], extras[pre + "outer_its"]
        rel = extras[pre + "recomputed_rel_resid"]
        log(f"[bench] {pre[:-1]}: {rounds} rounds, {its} inner its, median "
            f"{extras[pre + 'seconds']:.3f} s (min/median/max "
            f"{extras[pre + 'spread_s']}), {extras[pre + 'ms_per_outer_it']}"
            f" ms/outer it, true float64 relative residual {rel:.3e} "
            f"(recomputed), setup {extras['solve_setup_seconds']} s ({card})")
        check(extras[pre + "converged"] and not extras[pre + "stalled"],
              f"bench {pre[:-1]}: did not converge or stalled")
        check(extras[pre + "loop"] == "device",
              f"bench {pre[:-1]}: the solver ran the {extras[pre + 'loop']} "
              f"loop")
        check(rel <= 1e-8, f"bench {pre[:-1]}: true residual {rel:.3e}")
        if not (r0 <= rounds <= r1 and i0 <= its <= i1):
            misses.append(f"bench {pre[:-1]}: {rounds} rounds / {its} inner"
                          f" its outside {r0}-{r1} / {i0}-{i1}")
            log(f"[bench] {misses[-1]} (raised at the end)")
    check(all(n > 0 for k, n in k5.items() if k not in K5_CART + K5_NONE),
          f"bench: a K5 kernel or fused form never ran: {k5}")
    log(f"[bench] K5 launches over the bench's solves: {k5} ({card})")
    _bench_twin_witness(device, card, extras)
    return launches, applies, k5, misses


def _ranged(name, fn):
    def wrapped(*a, **k):
        with torch.profiler.record_function(name):
            return fn(*a, **k)
    return wrapped


# ROADMAP section 2's K2-K7, as the port's functions whose device work each
# counts (the innermost enclosing one; the hand-written K1, K3, K4, K5 and
# K6 by kernel name wherever they run; restrict_grid_kernel and
# restrict_parity_kernel cover their fused forms, mp_stencil_kernel K3's)
PROFILE_KERNELS = (("K1 a00_apply", "a00_factored_kernel"),
                   ("K1 a00_apply", "a00_element_kernel"),
                   ("K3 mp_apply", "mp_stencil_kernel"),
                   ("K1 a00_apply", "a00_node_gather_kernel"),
                   ("K1 fused gather", "a00_fused_gather_kernel"),
                   ("K4 stencil_apply", "stencil_k4_kernel"),
                   ("K5 transfers", "prolong_parity_kernel"),
                   ("K5 transfers", "prolong_parity_staged_kernel"),
                   ("K5 transfers", "restrict_parity_kernel"),
                   ("K5 transfers", "prolong_grid_kernel"),
                   ("K5 transfers", "restrict_grid_kernel"),
                   ("K6 cheb_smooth", "cheb_first_kernel"),
                   ("K6 cheb_smooth", "cheb_step_kernel"),
                   ("K6 cheb_smooth", "cheb_first_masked_kernel"),
                   ("K6 cheb_smooth", "cheb_step_masked_kernel"))
PROFILE_RANGES = (("K2 mult_tree", tabf, "mult_tree"),
                  ("K3 mp_apply", tabf, "mp_apply"),
                  ("K6 cheb_smooth", treeops, "cheb_smooth"),
                  ("K7 dots", treeops, "tdot"),
                  ("K7 dots", treeops, "_bdots"))


_LAUNCH_APIS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


def _launches(ka):
    """(kernel launch calls, graph launch calls) of a profile."""
    return (sum(e.count for e in ka if e.key in _LAUNCH_APIS),
            sum(e.count for e in ka if e.key in ("cudaGraphLaunch",
                                                 "cuGraphLaunch")))


def _timed_ir(slv, F):
    """(wall seconds, result) of one unprofiled IR solve after a warm-up."""
    slv.solve_ir(F, rtol=1e-8)
    rec = _ir_solve(slv, F)
    return rec["wall"], rec["res"]


def phase_profile(card):
    """mx=32 IR solves under the bench's tuned schedule with
    torch.profiler, each after a warm-up solve. The eager=True solve: device
    time by K1-K7 (the rest: Krylov vector updates, the coarse matvec,
    casts; record_function ranges do not exist inside a graph replay), by
    kernel, the card's busy share of the unprofiled solve, kernel launches,
    then the profiler's table. Then over the same setup the host loop over
    captured bodies (loop="host") and the device loop (the
    solver's default on CUDA: one graph launch per solve): each one's
    busy share, kernel and graph launches from the host and replays per
    solve."""
    from torch.profiler import ProfilerActivity, profile
    device = torch.device("cuda", 0)
    p = bench._build_problem(32, with_rhs=True)
    slv = tabf.ABFSolver(p["mesh"], p["fes"], p["coeff"], p["bc_idx"],
                         p["bc_vals"], device=device, dtype=torch.float32,
                         nlevels=bench.bench_nlevels(p["mesh"]), ir=True,
                         **bench.bench_solver_kw(env=False))

    def eager():
        return tabf.ABFSolver.from_parts(slv.cfg, slv.data, slv.setup,
                                         device=device, dtype=torch.float32,
                                         ir=True, eager=True)

    F = p["F_raw"] + slv.setup["rhs_diri"]
    wall, res = _timed_ir(eager(), F)
    saved = [(mod, attr, getattr(mod, attr)) for _, mod, attr in
             PROFILE_RANGES]
    for (name, mod, attr), (_, _, fn) in zip(PROFILE_RANGES, saved):
        setattr(mod, attr, _ranged(name, fn))
    _reset_launches()
    try:
        # built under the ranges: the Krylov loops bind their dots when
        # they are made
        eslv = eager()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res = eslv.solve_ir(F, rtol=1e-8)
            torch.cuda.synchronize()
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    check(res["converged"], "profiled solve did not converge")
    ka = prof.key_averages()
    names = {name for name, _, _ in PROFILE_RANGES}
    # kernel rows only: an operator's row repeats its kernels' time, and a
    # range's device-side row spans the kernels inside it
    dev = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA
           and self_device_us(e) > 0 and e.key not in names]
    total = sum(self_device_us(e) for e in dev) / 1e6
    check(total > 0, "the profiler recorded no device time")
    # the hand-written kernels by name (a ctypes launch has no torch op
    # above it to carry a range), the rest by their innermost range
    buckets = {}
    for b, tag in PROFILE_KERNELS:
        buckets[b] = buckets.get(b, 0.0) + sum(
            self_device_us(e) for e in dev if tag in e.key) / 1e6
    for e in prof.events():
        for k in e.kernels:
            if any(tag in k.name for _, tag in PROFILE_KERNELS):
                continue
            q = e
            while q is not None and q.name not in names:
                q = q.cpu_parent
            if q is not None:
                buckets[q.name] = buckets.get(q.name, 0.0) + k.duration / 1e6
    buckets["rest"] = total - sum(buckets.values())
    launches, _ = _launches(ka)
    pads = sum(e.count for e in ka if e.key == "aten::constant_pad_nd")
    applies_eager = a00.LAUNCHES.applies
    mg_eager = _mg_counts()
    k5_eager = sum(_k5_counts()[k] for k in K5_KERNELS)
    log(f"[profile] mx=32 IR solve, tuned schedule, eager=True: unprofiled "
        f"wall {wall:.3f} s, {res['rounds']} rounds / {res['inner_its']} "
        f"inner its, device time {total:.3f} s (busy {100 * total / wall:.1f}%"
        f" of the unprofiled wall), {a00.LAUNCHES.applies} K1 applies (by "
        f"form {dict(a00.LAUNCHES.by)}), K4 / "
        f"K6 {mg_eager[0]} / {mg_eager[1]} launches (K4 fused residual / "
        f"cheb_first / cheb_step {mg_eager[2]} / {mg_eager[3]} / "
        f"{mg_eager[4]}), K5 {k5_eager} launches, {pads} F.pad calls, "
        f"kernel launches {launches} ({card})")
    check(mg_eager[0] == sum(mg_eager[2:]) and pads == 0,
          f"profile: K4 launches {mg_eager[0]}, fused {mg_eager[2:]}, F.pad "
          f"calls {pads}: every stencil apply of the single-device solve "
          f"is fused and pads nothing")
    for name in sorted(buckets):
        log(f"[profile] {name:18s} {buckets[name]:8.3f} s "
            f"({100 * buckets[name] / total:5.1f}% of device time)")
    for e in sorted(dev, key=self_device_us, reverse=True)[:12]:
        log(f"[profile] {self_device_us(e) / 1e3:10.3f} ms "
            f"{e.count:7d} x  {e.key[:90]}")
    log(ka.table(sort_by="self_cuda_time_total", row_limit=25))

    # the graphed solves: the same kernels, the host loop over captured
    # bodies and the whole solve as one graph with conditional nodes
    host = tabf.ABFSolver.from_parts(slv.cfg, slv.data, slv.setup,
                                     device=device, dtype=torch.float32,
                                     ir=True, loop="host")
    e_applies = applies_eager
    counts = {}
    for name, gslv in (("host loop, captured bodies", host),
                       ("device loop, one graph", slv)):
        gwall, gres = _timed_ir(gslv, F)
        check(gres["converged"], f"profile: the {name} solve did not "
              f"converge")
        check(gslv is not host or _same_ir(gres, res), "profile: the host "
              "loop over captured bodies differs from the eager solve")
        _reset_launches()
        n0 = graphs.replays(gslv.bodies())
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as gprof:
            gslv.solve_ir(F, rtol=1e-8)
            torch.cuda.synchronize()
        replays = graphs.replays(gslv.bodies()) - n0
        applies = a00.LAUNCHES.applies
        mg = _mg_counts()
        k5 = sum(_k5_counts()[k] for k in K5_KERNELS)
        gka = gprof.key_averages()
        gdev = [e for e in gka
                if e.device_type == torch.autograd.DeviceType.CUDA
                and self_device_us(e) > 0]
        gtotal = sum(self_device_us(e) for e in gdev) / 1e6
        g_launch, g_graph = _launches(gka)
        kernels = sum(e.count for e in gdev)
        busy = (f"device time {gtotal:.3f} s over {kernels} kernels, busy "
                f"{100 * gtotal / gwall:.1f}% of the unprofiled wall"
                if gtotal > 0 else "device time not measured (the profiler "
                "recorded no kernel)")
        if gslv.loop == "device":
            # the profiler does not trace the kernels inside conditional
            # bodies: the solve's device span from CUDA events instead
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e0.record()
            gslv.solve_ir(F, rtol=1e-8)
            e1.record()
            e1.synchronize()
            w = time.perf_counter() - t0
            span = e0.elapsed_time(e1) / 1e3
            busy = (f"the profiler traced {kernels} kernels ({gtotal:.3f} "
                    f"s; none inside the conditional bodies); device span "
                    f"{span:.3f} s (CUDA events around the solve's stream "
                    f"work, input and result copies included) = "
                    f"{100 * span / w:.1f}% of that solve's wall {w:.3f} s")
        log(f"[profile] mx=32 IR solve, tuned schedule, {name}: unprofiled "
            f"wall {gwall:.3f} s (eager {wall:.3f} s), {gres['rounds']} "
            f"rounds / {gres['inner_its']} inner its, {busy}; per solve "
            f"{g_launch} kernel launches and {g_graph} graph launches from "
            f"the host, {replays} captured-body replays, "
            f"{applies} K1 applies, K4 / K6 {mg[0]} / {mg[1]} launches (K4 "
            f"fused residual / cheb_first / cheb_step {mg[2]} / {mg[3]} / "
            f"{mg[4]}), K5 {k5} launches; "
            f"graph capture "
            f"{gslv.capture_seconds:.3f} s ({card})")
        for e in sorted(gdev, key=self_device_us, reverse=True)[:8]:
            log(f"[profile] {name[:11]} {self_device_us(e) / 1e3:10.3f} ms "
                f"{e.count:7d} x  {e.key[:80]}")
        counts[gslv.loop] = (gres["rounds"], gres["inner_its"], applies)
    # on this schedule the loops take the same rounds and FGMRES its; the
    # K1 applies also follow the u-block GCR's its, which float32 rounding
    # of the device loop's masked-window dots may move
    check(counts["device"][:2] == counts["host"][:2]
          == (res["rounds"], res["inner_its"]),
          f"profile: (rounds, inner its, K1 applies) device loop "
          f"{counts['device']}, host loop {counts['host']}, eager "
          f"{(res['rounds'], res['inner_its'], e_applies)}")
    check(counts["host"][2] == e_applies, f"profile: K1 applies host loop "
          f"{counts['host'][2]}, eager {e_applies}")
    log(f"[profile] tuned schedule: device loop, host loop and eager=True "
        f"each {res['rounds']} rounds / {res['inner_its']} inner its; K1 "
        f"applies per solve: device loop {counts['device'][2]}, host loop "
        f"{counts['host'][2]}, eager {e_applies} ({card})")


def _profiled(fn):
    """fn() under torch.profiler: (kernels traced, their device seconds,
    {kernel name: (count, device seconds)})."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and self_device_us(e) > 0]
    return (sum(e.count for e in dev),
            sum(self_device_us(e) for e in dev) / 1e6,
            {e.key: (e.count, self_device_us(e) / 1e6) for e in dev})


def _span(fn):
    """(wall seconds, CUDA-event span seconds) of fn()."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e0.record()
    fn()
    e1.record()
    e1.synchronize()
    return time.perf_counter() - t0, e0.elapsed_time(e1) / 1e3


def profile_cart(card):
    """Phase cart's flagship (float64 direct, 4 shards on this card) and
    its single-device solve: the plain driver of each profiled (the device
    loop's kernels, issued from Python, which the profiler traces: their
    count and device time), beside the device loop's CUDA-event span,
    which the profiler cannot see into; the top kernels of the sharded
    solve."""
    single = tdriver.saddle_solve(Options.from_args(CART_ARGV), 3,
                                  log=lambda *a: None,
                                  devices=[torch.device("cuda", 0)])
    r = tdriver.saddle_solve(Options.from_args(CART_ARGV), 3,
                             log=lambda *a: None,
                             devices=[torch.device("cuda", 0)] * CART_DEVICES)
    check(r["loop"] == single["loop"] == "device",
          f"profile: cart loop {r['loop']}, single {single['loop']}")
    F = r["F"]
    s1 = single["solver"]
    kinds = {"cart": (r["solver"], r["solver"].with_loop("plain")),
             "single": (s1, tabf.ABFSolver.from_parts(
                 s1.cfg, s1.data, s1.setup, device=s1.device,
                 dtype=s1.dtype, loop="plain"))}
    for name, (dev, plain) in kinds.items():
        dev.solve(F)
        wall, span = _span(lambda: dev.solve(F))
        pwall, _ = _span(lambda: plain.solve(F))
        n, t, by = _profiled(lambda: plain.solve(F))
        log(f"[profile] {name} mx=32 float64 direct solve: device loop wall "
            f"{wall:.4f} s, CUDA-event span {span:.4f} s; its plain driver "
            f"{pwall:.4f} s unprofiled, {n} kernels traced, {t:.4f} s of "
            f"kernel time ({1e6 * t / n:.2f} us per kernel); the span "
            f"exceeds the kernel time by {span - t:.4f} s "
            f"({1e6 * (span - t) / n:.2f} us per kernel) ({card})")
        if name == "cart":
            for k, (c, sec) in sorted(by.items(), key=lambda kv: -kv[1][1])[
                    :10]:
                log(f"[profile] cart {1e3 * sec:9.3f} ms {c:7d} x  {k[:80]}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = phase_device()
    phase_build()
    if "--peer" in sys.argv[1:]:
        log(json.dumps({"kernels": [phase_peer(card)]}))
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--profile" in sys.argv[1:]:
        phase_profile(card)
        profile_cart(card)
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    k1, k1_fused = phase_k1(device, card)
    ctl = phase_ctl(device)
    t_mg = time.perf_counter()
    k4, fused, k6, k5, k3 = phase_mg_kernels(device, card)
    log(f"[smoke] mg_kernels phase {time.perf_counter() - t_mg:.1f} s")
    phase_anchor()
    launches, applies, mg_launches, ctl_launches, k5_launches, \
        a00_fused_launches, k3_launches = phase_main(card)
    phase_host_anchor()
    phase_host_mg(device)
    t0 = time.perf_counter()
    c_launches, c_applies, _ = phase_compiled(device, card)
    phase_outputs(device, card)
    phase_ex42(device, card)
    t_cart = time.perf_counter()
    cart_counts, cart_ref = phase_cart(device, card)
    cart_launches, cart_applies = cart_counts["a00_apply"]
    log(f"[smoke] cart phase {time.perf_counter() - t_cart:.1f} s")
    torch.cuda.empty_cache()
    t_procs = time.perf_counter()
    procs_launches, procs_applies = phase_cart_procs(card, cart_ref)
    del cart_ref
    log(f"[smoke] cart_procs phase {time.perf_counter() - t_procs:.1f} s")
    t_bench = time.perf_counter()
    bench_launches, bench_applies, bench_k5, misses = phase_bench(device,
                                                                  card)
    log(f"[smoke] bench phase {time.perf_counter() - t_bench:.1f} s")
    peer_entry = phase_peer(card)
    log(f"[smoke] compiled, outputs, ex42, cart, cart_procs and bench "
        f"phases "
        f"{time.perf_counter() - t0:.1f} s; whole script "
        f"{time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [{
        "name": "a00_apply", "route": "cuda",
        "source": "exsaddle_tpu_torch/csrc/a00_apply.cu",
        "replaces": "exsaddle_tpu/pallas_apply.py:61",
        "launches": launches, "applies": applies,
        "launches_per_apply": launches / applies,
        "compiled_launches": c_launches, "compiled_applies": c_applies,
        "cart_launches": cart_launches, "cart_applies": cart_applies,
        "cart_procs_launches": procs_launches,
        "cart_procs_applies": procs_applies,
        "bench_launches": bench_launches, "bench_applies": bench_applies,
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_us": 1e3 * k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"]}] + [{
            "name": name, "route": "cuda",
            "source": "exsaddle_tpu_torch/csrc/krylov_ctl.cu",
            "replaces": replaces, "launches": ctl_launches[name],
            "cart_launches": cart_counts[name],
            **ctl[name]} for name, replaces in CTL_KERNELS] + [{
            "name": "stencil_accum", "route": "cuda",
            "source": "exsaddle_tpu_torch/csrc/stencil_apply.cu",
            "replaces": "exsaddle_tpu/abf.py:240",
            "launches": mg_launches["stencil_accum"],
            "cart_launches": cart_counts["stencil_accum"], **k4}] + [{
            "name": FUSED[e], "route": "cuda",
            "source": "exsaddle_tpu_torch/csrc/stencil_apply.cu",
            "replaces": ("exsaddle_tpu/abf.py:240" if e == "residual"
                         else "exsaddle_tpu/treeops.py:167"),
            "launches": mg_launches[FUSED[e]],
            "cart_launches": cart_counts[FUSED[e]], **fused[e]}
            for e in stencil.EPILOGUES] + [{
            "name": "cheb_update", "route": "cuda",
            "source": "exsaddle_tpu_torch/csrc/cheb_update.cu",
            "replaces": "exsaddle_tpu/treeops.py:167",
            "launches": mg_launches["cheb_update"],
            "cart_launches": cart_counts["cheb_update"], **k6}] + [{
            "name": form, "route": "cuda",
            "source": "exsaddle_tpu_torch/csrc/a00_apply.cu",
            "replaces": {"a00_apply_keep": "exsaddle_tpu/pallas_apply.py:61",
                         "a00_masked": "exsaddle_tpu/abf.py:56"}.get(
                             form, "exsaddle_tpu/treeops.py:167"),
            # the cart path's own form: its launches in phase cart's run
            "launches": a00.KERNELS_PER_APPLY * (
                cart_counts if form == "a00_apply_keep"
                else a00_fused_launches)[form],
            "cart_launches": a00.KERNELS_PER_APPLY * cart_counts[form],
            **k1_fused[form]} for form in A00_FUSED] + [{
            "name": form, "route": "cuda",
            "source": "exsaddle_tpu_torch/csrc/cheb_update.cu",
            "replaces": "exsaddle_tpu/treeops.py:167",
            "launches": cart_counts[form], "cart_launches": cart_counts[form],
            **k1_fused[form]} for form in K6_MASKED] + [{
            "name": name, "route": "cuda",
            "source": "exsaddle_tpu_torch/csrc/transfer.cu",
            "replaces": K5_REPLACES[kernel],
            # the cart path's own form: its launches in phase cart's run
            "launches": (cart_counts if name in K5_CART
                         else k5_launches)[name],
            "cart_launches": cart_counts[name],
            "bench_launches": bench_k5[name], **k5[name]}
            for kernel, forms in K5_KERNELS.items()
            for name in (kernel,) + tuple(f for f in forms
                                          if f in K5_FUSED
                                          and f not in K5_NONE)] + [{
            "name": form, "route": "cuda",
            "source": "exsaddle_tpu_torch/csrc/mp_apply.cu",
            "replaces": K3_REPLACES[form],
            # the cart path's own form: its launches in phase cart's run
            "launches": (cart_counts if form == "mp_apply"
                         else k3_launches)[form],
            "cart_launches": cart_counts[form], **k3[form]}
            for form in mp.FORMS] + [peer_entry]}))
    check(not misses, "; ".join(misses))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
