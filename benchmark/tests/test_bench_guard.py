"""The import guard, and what a run loads: neither JAX nor the JAX package
(exsaddle_tpu, compared by top-level name, whole), and nothing of the system
under test in the reference."""

import glob
import json
import os
import shutil
import subprocess
import sys

from benchmark import guard

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _loaded(code):
    """Top-level module names loaded by `code` in a fresh interpreter."""
    prog = ("import sys; sys.path.insert(0, %r)\n%s\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))" % (ROOT, code))
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, check=True, timeout=300, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_guard_compares_whole_top_level_names():
    assert guard.banned_loaded(["exsaddle_tpu_torch", "exsaddle_tpu_torch.abf",
                                "numpy", "jaxtyping"]) == []
    assert guard.banned_loaded(["exsaddle_tpu.mesh", "jax.numpy", "flax",
                                "jaxlib.xla_client"]) == [
        "exsaddle_tpu", "flax", "jax", "jaxlib"]


def test_a_run_imports_no_jax():
    """Every module a run imports: the harness, its readers, the reference
    and the system's modules a run reaches."""
    readers = "".join(
        f"harness.metric_reader({os.path.basename(p)[:-3]!r})\n"
        for p in sorted(glob.glob(os.path.join(ROOT, "benchmark", "metrics",
                                               "*.py"))))
    names = _loaded(
        "import benchmark.run\n"
        "from benchmark import harness, breakdown, controls, loads, "
        "yardstick, guard\n"
        "from benchmark.reference.models import pseudoice, solcx\n"
        "import exsaddle_tpu_torch.abf, exsaddle_tpu_torch.driver\n"
        "import exsaddle_tpu_torch.parallel.cart_abf\n"
        "from exsaddle_tpu_torch.kernels import a00, stencil, _build\n"
        + readers)
    assert "exsaddle_tpu_torch" in names
    assert guard.banned_loaded(names) == []


def test_the_reference_imports_nothing_of_the_system():
    names = _loaded("from benchmark.reference import fem\n"
                    "from benchmark.reference.models import pseudoice, "
                    "solcx\nfrom benchmark import loads, yardstick")
    assert not names & {"exsaddle_tpu", "exsaddle_tpu_torch", "jax"}


def test_run_prints_no_result_without_a_card_or_the_system(tmp_path):
    """Without a CUDA card (this machine), and in a directory that holds
    only BENCHMARK.json and the benchmark's files, a run exits non-zero and
    prints nothing on standard output."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for where in (ROOT, str(tmp_path)):
        p = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload",
             "pseudoice_mx32.rhs_stream", "--seed", "3000000001",
             "--seconds", "1", "--trace", "0"],
            capture_output=True, text=True, timeout=300, cwd=where,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert p.returncode != 0
        assert p.stdout == ""
