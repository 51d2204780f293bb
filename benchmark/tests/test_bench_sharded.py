"""The harness on a sharded configuration (one that states "shards": n).

On the CPU, at a small size with every shard on the CPU device (the
sharded solver's host loop): a sound run comes out correct, each planted
fault (an answer altered where it is produced, a solve that returns its
state unchanged) comes out not correct, a traced run reports the cell's
metrics, the readings of controls.py take the single-card float32 control,
and the harness's sharded solution for one load is the port's driver's
(driver.saddle_solve in cart mode) bit for bit. A guard holds the
one-card configurations' build to the ABFSolver arguments they have always
had. On the card: four shards on cuda:0 (the device loop), and one shard
on each of four cards where the machine has them."""

import copy
import json
import os
import time

import numpy as np
import pytest
import torch

from benchmark import breakdown, harness

CONFIG = "pseudoice_mx32_cart4"
CELL = CONFIG + ".rhs_stream_f64"
SEED = 2 ** 31 + 12345
# the least mesh the sharded build takes with 4 shards and 3 MG levels:
# grid 1 x 2 x 2, 4 x 4 x 4 elements a shard
SMALL = {"mx": 4, "my": 8, "mz": 8}


def _config():
    """The sharded configuration: pseudoice_mx32's, with 4 shards."""
    base = harness.read_json(os.path.join(harness.HERE, "configs",
                                          "pseudoice_mx32.json"))
    return dict(copy.deepcopy(base), name=CONFIG, shards=4)


def _root(tmp_path):
    """A checkout root whose BENCHMARK.json is the repository's with the
    sharded configuration, its cell and its metrics entered where it lacks
    them, and whose configuration file is _config()."""
    bench = harness.read_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    path = f"benchmark/configs/{CONFIG}.json"
    if CONFIG not in [c["name"] for c in bench["configs"]]:
        bench["configs"].append({"name": CONFIG, "source": "-", "file": path,
                                 "reduced": [], "why": "-"})
    if CELL not in [w["name"] for w in bench["workloads"]]:
        bench["workloads"].append({"name": CELL, "config": CONFIG,
                                   "traffic": "rhs_stream_f64", "chips": 4,
                                   "why": "-"})
    for m in bench["per_layer"]:
        if (m["name"] in ("build_s", "fgmres_its", "ms_per_fgmres_it")
                and CELL not in m["workloads"]):
            m["workloads"].append(CELL)
    if "cards_idle_pct" not in [m["name"] for m in bench["per_layer"]]:
        bench["per_layer"].append({
            "name": "cards_idle_pct", "unit": "%", "better": "lower",
            "source": "device_trace", "layer": "-", "moves": "solve_s",
            "workloads": [CELL]})
    os.makedirs(tmp_path / "benchmark" / "configs")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / path).write_text(json.dumps(_config()))
    return str(tmp_path)


def _small(loads=2, **flags):
    config = _config()
    config["flags"].update(flags or SMALL)
    config["mg_levels"] = 3
    traffic = harness.read_json(os.path.join(harness.HERE, "traffic",
                                             "rhs_stream_f64.json"))
    return config, dict(traffic, loads=loads)


@pytest.fixture
def one_thread():
    """The CPU shards' many small ops run fastest on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(tmp_path, device=torch.device("cpu"), wrap=None, trace=False,
         seconds=0.5, chips=4, **flags):
    config, traffic = _small(**flags)
    return harness.run_cell(CELL, SEED, seconds, trace, device,
                            time.perf_counter(), root=_root(tmp_path),
                            config=config, traffic=traffic, wrap=wrap,
                            chips=chips)


class _Fault:
    def __init__(self, entry, fault):
        self.entry, self.fault = entry, fault

    def __call__(self, F):
        x, its, r = self.entry(F)
        return self.fault(x), its, r


def test_sound_run_is_correct(tmp_path, one_thread):
    out = _run(tmp_path)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"solve_s", "solve_s_p90", "setup_s"}
    assert out["checks"]["resid_max"]["value"] <= 1e-8
    assert out["device"]["count"] == 1
    assert out["device"]["memory_peak_bytes_by_card"] == [0]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", [
    lambda x: np.zeros_like(x),
    lambda x: harness.altered(x, SEED)], ids=["unchanged", "altered"])
def test_broken_timed_path_is_not_correct(tmp_path, one_thread, fault):
    out = _run(tmp_path, wrap=lambda e: _Fault(e, fault))
    assert not out["correct"]
    assert out["failed"] == out["attempted"]
    assert out["checks"]["resid_max"]["value"] > 1e-8


def test_traced_run_reports_the_cells_metrics(tmp_path, one_thread):
    out = _run(tmp_path, trace=True)
    assert out["correct"]
    # cards_idle_pct is a device reading: none on the CPU
    assert set(out["metrics"]) == {"build_s", "fgmres_its",
                                   "ms_per_fgmres_it"}
    assert out["device"]["busy_s"] > 0 and out["device"]["window_s"] > 0


def test_mixed_traffic_is_refused(tmp_path):
    config, _ = _small()
    traffic = harness.read_json(os.path.join(harness.HERE, "traffic",
                                             "rhs_stream.json"))
    with pytest.raises(ValueError, match="float64 traffic only"):
        harness.run_cell(CELL, SEED, 0.5, False, torch.device("cpu"),
                         time.perf_counter(), root=_root(tmp_path),
                         config=config, traffic=traffic)


def test_sharded_solution_is_the_drivers(one_thread):
    """One load solved by the harness's sharded build and by
    driver.saddle_solve's cart mode over 4 CPU shards: equal bit for bit."""
    from exsaddle_tpu_torch import driver
    from exsaddle_tpu_torch.options import Options
    config, _ = _small()
    args = (list(driver.ABF_OPTS) + harness.flag_args(config["flags"])
            + ["-device", "cpu", "-saddle_ksp_rtol",
               str(config["guarantee"]["requested_rtol"]),
               "-saddle_fieldsplit_u_pc_mg_levels",
               str(config["mg_levels"])])
    cpu = torch.device("cpu")
    ref = driver.saddle_solve(Options.from_args(args), 3, log=lambda *a: None,
                              devices=[cpu] * 4)
    assert ref["mode"] == "cart"
    slv, _ = harness.build_solver(config, harness.system_problem(config),
                                  cpu, "float64", chips=4)
    assert slv.part.dev_shape == ref["solver"].part.dev_shape == (1, 2, 2)
    x, its, _ = harness.Entry(slv, config, "float64")(ref["F"])
    assert its == ref["its"]
    assert np.array_equal(x, np.asarray(ref["X"], np.float64))


def test_readings_take_the_single_card_float32_control(one_thread):
    """controls.py's readings on a sharded configuration: the program's
    reading is the sharded solver's, the control the single-card float32
    solve, and the faults read as on one card."""
    config, traffic = _small()
    out = harness.readings(config, traffic, [SEED], [SEED],
                           torch.device("cpu"), lambda s: None, chips=4)
    limit = out["limit"]
    assert out["program"][SEED] <= limit
    assert out["control"][SEED] > 3 * limit
    assert out["altered"][SEED] > limit
    assert out["unchanged"][SEED] == 1.0


class _Recorder:
    def __init__(self, *args, **kw):
        self.args, self.kw = args, kw


def test_one_card_build_is_unchanged(monkeypatch):
    """build_solver hands ABFSolver, for each one-card configuration and
    precision, exactly the arguments it handed it before sharded
    configurations were taken."""
    from exsaddle_tpu_torch import abf
    monkeypatch.setattr(abf, "ABFSolver", _Recorder)
    bench = harness.read_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    sysprob = {k: object() for k in ("mesh", "fes", "coeff", "bc_idx",
                                      "bc_vals", "ctx")}
    cpu = torch.device("cpu")
    seen = 0
    for c in bench["configs"]:
        config = harness.read_json(os.path.join(harness.ROOT, c["file"]))
        if harness.shards_of(config):
            continue
        for precision in ("mixed", "float64", "float32"):
            kw = dict(config["solver"])
            if precision != "mixed":
                kw["rtol"] = float(config["guarantee"]["requested_rtol"])
            if precision == "float32":
                kw["max_it"] = int(config["control_max_it"])
            want = dict(kw, device=cpu, nlevels=int(config["mg_levels"]),
                        ir=precision == "mixed",
                        dtype=(torch.float64 if precision == "float64"
                               else torch.float32))
            slv, _ = harness.build_solver(config, sysprob, cpu, precision)
            assert slv.args == tuple(sysprob[k] for k in (
                "mesh", "fes", "coeff", "bc_idx", "bc_vals"))
            assert slv.kw == want
            seen += 1
    assert seen >= 6


def test_cards_idle_pct_reads_the_profile():
    """The reader's arithmetic on a two-card trace: card 0 busy over 60%
    of the solve's wall in two overlapping kernels and a copy, card 1 over
    20%; a kernel outside the solve counts for nothing."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": breakdown.SOLVE,
           "ts": 1000.0, "dur": 100.0},
          {"ph": "X", "cat": "gpu_user_annotation", "name": breakdown.SOLVE,
           "ts": 1000.0, "dur": 60.0, "pid": 0, "args": {"device": 0}},
          {"ph": "X", "cat": "cpu_op", "name": "aten::add_", "ts": 1000.0,
           "dur": 100.0},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 1000.0,
           "dur": 30.0, "pid": 0, "args": {"device": 0}},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 1020.0,
           "dur": 20.0, "pid": 0, "args": {"device": 0}},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy PtoP", "ts":
           1080.0, "dur": 20.0, "pid": 0, "args": {"device": 0}},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 1060.0,
           "dur": 20.0, "pid": 1, "args": {"device": 1}},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 900.0,
           "dur": 50.0, "pid": 1, "args": {"device": 1}}]
    prof = breakdown.cards_summary(ev, [0, 1])
    assert prof["wall_s"] == pytest.approx(1e-4)
    assert prof["busy_by_card"][0] == pytest.approx(0.6e-4)
    assert prof["busy_by_card"][1] == pytest.approx(0.2e-4)
    assert prof["busy_s"] == pytest.approx(0.4e-4)
    names = [n for n, _ in prof["device_ops"]]
    assert names[0] == "[cart cuda:1] k1" and "[cart cuda:0] k2" in names
    gaps = prof["idle_gaps"]
    assert gaps[0] == ["[cart cuda:1] host in aten::add_",
                       pytest.approx(0.6e-4)]
    assert len(gaps) == 3
    run = type("Run", (), {"config": {"shards": 2}, "cards_prof": prof})()
    value = harness.metric_reader("cards_idle_pct")(run)
    assert value == pytest.approx(60.0)
    assert breakdown.cards_summary(ev[2:], [0, 1]) is None


def _card_run(tmp_path, device, chips):
    out = _run(tmp_path, device=device, trace=True, seconds=2.0,
               chips=chips, mx=8, my=8, mz=8)
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == chips
    by_card = out["device"]["memory_peak_bytes_by_card"]
    assert len(by_card) == chips and min(by_card) > 0
    assert out["device"]["memory_peak_bytes"] == max(by_card)
    assert 0.0 < out["metrics"]["cards_idle_pct"]["value"] < 100.0
    assert 0.0 < out["device"]["busy_s"] < out["device"]["window_s"]
    ops = out["breakdown"]["device_ops"]
    assert ops and all(n.startswith("[cart cuda:") for n, _ in ops)
    return out


@pytest.mark.gpu
def test_four_shards_on_one_card(tmp_path, card):
    """Every shard on cuda:0: the sharded device loop, its host loop
    profiled."""
    _card_run(tmp_path, card, 1)


@pytest.mark.gpu
def test_one_shard_on_each_of_four_cards(tmp_path, card):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards")
    out = _card_run(tmp_path, card, 4)
    names = {n.split("]")[0] for n, _ in out["breakdown"]["device_ops"]}
    assert len(names) > 1
