"""The one traffic generator: a stream of right-hand sides, each the
configuration's own body force modulated by a seeded smooth field.

A traffic file (traffic/<name>.json) gives its parameters:

    loads         distinct loads per seed, solved in order (cycled if a
                  window outlasts them)
    modulation    a: load k's body force is Fu (1 + a g_k(x))
    modes         Fourier modes in g_k
    max_wave      largest wavenumber per axis, over the box
    precision     "mixed" (float32 inner solves in float64 refinement,
                  ABFSolver.solve_ir) or "float64" (ABFSolver.solve)

g_k(x) = sum_m c_m cos(pi n_m . x / L + phi_m) over the box L, with n_m
integer wave vectors (0 <= n <= max_wave per axis, not all 0), phases phi_m
uniform and weights c_m >= 0 summing to 1, so |g_k| <= 1. Every seed draws
the same number of loads of one size; the seed changes only the fields.
Loads are assembled by the reference's own code (reference/fem.py), with
the Dirichlet rows at the configuration's values.
"""

import numpy as np

PRECISIONS = ("mixed", "float64")


def rng_of(seed):
    """A numpy generator for any whole number, negative ones included."""
    seed = int(seed)
    return np.random.default_rng([int(seed < 0), abs(seed)])


def modes(traffic, seed, nd):
    """Each load's (wave vectors (modes, nd), phases, weights)."""
    rng = rng_of(seed)
    nmax = int(traffic["max_wave"])
    out = []
    for _ in range(int(traffic["loads"])):
        waves = []
        while len(waves) < int(traffic["modes"]):
            n = rng.integers(0, nmax + 1, size=nd)
            if n.any():
                waves.append(n)
        phases = rng.uniform(0.0, 2.0 * np.pi, size=len(waves))
        weights = rng.uniform(0.5, 1.0, size=len(waves))
        out.append((np.array(waves, dtype=np.float64), phases,
                    weights / weights.sum()))
    return out


def make_loads(traffic, seed, problem, saddle):
    """The seed's loads (natural dof order, float64 numpy, Dirichlet rows
    at their values) of a reference problem (harness.reference_problem),
    assembled on the device of `saddle` (its fem.Saddle)."""
    import torch
    if traffic["precision"] not in PRECISIONS:
        raise ValueError(f"precision {traffic['precision']!r}: one of "
                         f"{PRECISIONS}")
    fes = problem["fes"]
    f64 = dict(dtype=torch.float64, device=saddle.device)
    unit = torch.as_tensor(fes.qp_coords / np.asarray(fes.mesh.size), **f64)
    Fu = torch.as_tensor(problem["Fu"], **f64)
    Fp = torch.as_tensor(problem["Fp"], **f64)
    a = float(traffic["modulation"])
    out = []
    for waves, phases, weights in modes(traffic, seed, fes.mesh.ndim):
        arg = np.pi * (unit @ torch.as_tensor(waves.T, **f64))
        g = (torch.cos(arg + torch.as_tensor(phases, **f64))
             @ torch.as_tensor(weights, **f64))          # (nel, nqp)
        m = 1.0 + a * g
        out.append(saddle.load(Fu * m[..., None], Fp * m,
                               problem["bc_vals"]).cpu().numpy())
    return out
