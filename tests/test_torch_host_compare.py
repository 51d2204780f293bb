"""The harness of tests/test_torch_host_driver_{2d,3d}.py, and tests of its
line rules: one argv goes through the JAX driver and through the port's
driver (-device cpu), and every printed line is compared.

Rules, applied line by line:
  - non-numeric tokens identical; integers (iteration counts) identical;
  - float tokens to 1e-5 relative (the printed precision);
  - a residual monitor line below 1e-10 on both sides is rounding noise at
    the bottom of a direct solve and matches whatever its format branch
    (the rule of tests/refcompare.py);
  - the port consumes one option the JAX driver does not have (-device), so
    the port's -options_left table carries one more line, "-device cpu",
    which is dropped before the comparison.
Then: identical iteration count and reason, X to 1e-8 relative to max|X|.
"""

import re

import numpy as np

from exsaddle_tpu import driver as jdriver
from exsaddle_tpu.options import Options as JOptions

from exsaddle_tpu_torch import driver as tdriver
from exsaddle_tpu_torch.options import Options as TOptions

_MON = re.compile(r"^\s*(\d+) KSP Residual norm (.+?)\s*$")
_FLOAT = re.compile(r"^[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?[,;]?$")


def _run(mod, Options, argv, ndim, lame, nranks):
    lines = []

    def log(msg=""):
        lines.extend(str(msg).split("\n"))
    r = mod.saddle_solve(Options.from_args(argv), ndim, lame=lame, log=log,
                         nranks=nranks)
    return lines, r


def _monitor(line):
    m = _MON.match(line)
    if not m:
        return None
    v = m.group(2)
    return 1e-11 if v.startswith("<") else float(v)


def _same_line(a, b):
    ma, mb = _monitor(a), _monitor(b)
    if (ma is not None and mb is not None and ma < 1e-10 and mb < 1e-10
            and a.split()[0] == b.split()[0]):
        return True
    ta, tb = a.split(), b.split()
    if len(ta) != len(tb):
        return False
    for x, y in zip(ta, tb):
        if x == y:
            continue
        if not (_FLOAT.match(x) and _FLOAT.match(y)
                and any(c in x + y for c in ".eE")):
            return False
        fx, fy = float(x.rstrip(",;")), float(y.rstrip(",;"))
        if abs(fx - fy) > 1e-5 * max(abs(fx), abs(fy), 1e-300):
            return False
    return True


def check_same_output(args, ndim, lame=False, nranks=1):
    argv = args.split()
    jl, jr = _run(jdriver, JOptions, argv, ndim, lame, nranks)
    tl, tr = _run(tdriver, TOptions, argv + ["-device", "cpu"], ndim, lame,
                  nranks)
    tl = [ln for ln in tl if ln != "-device cpu"]
    assert len(tl) == len(jl), "\n".join(["--- jax ---"] + jl
                                         + ["--- torch ---"] + tl)
    for a, b in zip(tl, jl):
        assert _same_line(a, b), f"\ntorch: {a}\njax:   {b}"
    assert (tr["its"], tr["reason"]) == (jr["result"].its,
                                         jr["result"].reason)
    X = np.asarray(jr["X"])
    assert np.abs(tr["X"] - X).max() <= 1e-8 * np.abs(X).max()
    return tl, tr


def test_line_rules():
    assert _same_line("  3 KSP Residual norm 0.0179029 ",
                      "  3 KSP Residual norm 0.0179030 ")
    assert not _same_line("  3 KSP Residual norm 0.0179029 ",
                          "  3 KSP Residual norm 0.0179129 ")
    assert not _same_line("  3 KSP Residual norm 0.0179029 ",
                          "  4 KSP Residual norm 0.0179029 ")
    assert _same_line("  1 KSP Residual norm < 1.e-11",
                      "  1 KSP Residual norm 1.107e-11 ")
    assert not _same_line("Linear saddle_ solve converged due to "
                          "CONVERGED_RTOL iterations 12",
                          "Linear saddle_ solve converged due to "
                          "CONVERGED_RTOL iterations 13")
    assert _same_line("|p|_1          +3.645439e+02",
                      "|p|_1          +3.645440e+02")
    assert not _same_line("|p|_1          +3.645439e+02",
                          "|p|_2          +3.645439e+02")
