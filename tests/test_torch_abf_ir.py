"""The port's mixed-precision iterative refinement (float32 inner ABF
solves, float64 true residuals) against the JAX package's, mx=6 pseudoice:
both converge to a true 1e-8 in the same number of rounds, with total inner
iterations within 2 (float32 sums in another order move the inner
histories). The port's solver is built from the JAX build's numbers and
from its own setup."""

import numpy as np
import jax.numpy as jnp
import torch

from test_torch_abf import _jax_solver, _from_jax, _own


def test_abf_solve_ir_float32_matches_jax():
    kw = dict(nlevels=3, ir=True)
    jslv, F = _jax_solver(3, (6, 6, 6), (0.1, 1.0, 1.0), 11,
                          dtype=jnp.float32, **kw)
    rj = jslv.solve_ir(F, rtol=1e-8)
    assert rj["converged"] and not rj["stalled"]
    for tslv in (_from_jax(jslv, torch.float32, ir=True),
                 _own(3, (6, 6, 6), (0.1, 1.0, 1.0), 11,
                      dtype=torch.float32, **kw)[0]):
        rt = tslv.solve_ir(F, rtol=1e-8)
        assert rt["converged"] and not rt["stalled"]
        assert rt["rounds"] == rj["rounds"]
        assert abs(rt["inner_its"] - rj["inner_its"]) <= 2
        assert rt["x"].dtype == np.float64
