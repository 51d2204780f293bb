"""The port's ABF solve with four MG levels (two block-stencil levels in the
V-cycle) against the JAX package's, mx=8 pseudoice, float64: identical
reason and iteration count, history and solution within 1e-8 relative to
their largest entry. Kept apart from test_torch_abf.py so the parallel test
runner spreads the JAX compiles over workers."""

import numpy as np
import torch

from test_torch_abf import _jax_solver, _from_jax, _own, _same_solve


def test_abf_solve_four_levels_matches_jax():
    args = (3, (8, 8, 8), (0.1, 1.0, 1.0), 11)
    jslv, F = _jax_solver(*args, nlevels=4)
    rj = jslv.solve(F)
    assert rj["reason"] == "CONVERGED_RTOL"
    _same_solve(_from_jax(jslv, torch.float64).solve(F), rj)
    tslv, Ft = _own(*args, nlevels=4)
    assert np.array_equal(Ft, F)
    _same_solve(tslv.solve(Ft), rj)
