"""PseudoIce (models.c, -model 11, 3D): viscosity ramping linearly in x
from eta1 at x = 0 to eta0 at x = size_x, a unit body force along z, the
y = 0 face fixed in every component (FixedBase); every other face free."""

import numpy as np


def coefficients(flags, x):
    eta0 = float(flags.get("eta0", 1.0))
    eta1 = float(flags.get("eta1", 10000.0))
    xrel = x[:, 0] / float(flags.get("size_x", 1.0))
    eta = xrel * eta0 + (1 - xrel) * eta1
    Fu = np.zeros_like(x)
    Fu[:, 2] = 1.0
    return eta, Fu, np.zeros(len(x))


def dirichlet(flags, mesh):
    nd = mesh.ndim
    nodes = mesh.u_face_nodes(1, 0)
    idx = np.concatenate([nd * nodes + d for d in range(nd)])
    return idx.astype(np.int64), np.zeros(len(idx))
