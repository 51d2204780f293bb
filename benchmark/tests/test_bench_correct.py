"""`correct` on the CPU at a small size: a sound run of the harness comes
out correct; with the timed path broken underneath (a solve that returns
its state unchanged, an answer altered where it is produced) it comes out
not correct; the control, the system's float32 path, reads above the
limit. The card's test runs the same readings on the card."""

import copy
import time

import numpy as np
import pytest
import torch

from benchmark import harness

CELL = "solcx_ar_mx32.rhs_stream"
SEED = 2 ** 31 + 12345


def _small(cell=CELL, mx=4, loads=2):
    _, _, _, config, traffic = harness.cell_files(harness.ROOT, cell)
    config = copy.deepcopy(config)
    config["flags"].update(mx=mx, my=mx, mz=mx)
    config["mg_levels"] = 3
    return config, dict(traffic, loads=loads)


def _run(wrap=None, trace=False):
    config, traffic = _small()
    return harness.run_cell(CELL, SEED, 0.5, trace, torch.device("cpu"),
                            time.perf_counter(), config=config,
                            traffic=traffic, wrap=wrap)


class _Fault:
    def __init__(self, entry, fault):
        self.entry, self.fault = entry, fault

    def __call__(self, F):
        x, its, r = self.entry(F)
        return self.fault(x), its, r


def test_sound_run_is_correct():
    out = _run()
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"solve_s", "solve_s_p90", "setup_s"}
    checks = out["checks"]
    assert checks["resid_max"]["value"] <= checks["resid_max"]["limit"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", [
    lambda x: np.zeros_like(x),
    lambda x: harness.altered(x, SEED)], ids=["unchanged", "altered"])
def test_broken_timed_path_is_not_correct(fault):
    out = _run(wrap=lambda e: _Fault(e, fault))
    assert not out["correct"]
    assert out["failed"] == out["attempted"]
    assert out["checks"]["resid_max"]["value"] > 1e-8


def test_traced_run_reports_per_layer_metrics():
    out = _run(trace=True)
    assert out["correct"]
    assert {"build_s", "fgmres_its", "ms_per_fgmres_it"} <= set(
        out["metrics"])
    assert out["device"]["busy_s"] > 0 and out["device"]["window_s"] > 0


def _readings(device, mx):
    config, traffic = _small(mx=mx)
    out = harness.readings(config, traffic, [SEED, 7], [SEED], device,
                           lambda s: None)
    limit = out["limit"]
    assert all(v <= limit for v in out["program"].values())
    assert all(v > 3 * limit for v in out["control"].values())
    assert all(v > limit for v in out["altered"].values())
    assert all(v == 1.0 for v in out["unchanged"].values())
    return out


def test_control_reads_above_the_limit():
    _readings(torch.device("cpu"), 4)


@pytest.mark.gpu
def test_control_reads_above_the_limit_on_the_card(card):
    _readings(card, 8)
