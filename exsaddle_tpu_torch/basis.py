"""Q1/Q2 Lagrange basis tabulation on the reference element [-1,1]^d.

Capability parity with the reference's EvaluateBasis_Q1/Q2 and
EvaluateBasisDerivLocal_Q1/Q2 (femixedspace.c:1489-1855). Node ordering is
tensor-product with the x index fastest (matching the element->node maps of
femixedspace.c:933-1039), i.e. node (i,j,k) -> i + 3*j + 9*k for Q2.

All tables are plain numpy float64; they are tiny constants baked into traced
computations.
"""

import numpy as np


def _q1_1d(x):
    """Linear hat values at the two 1D nodes {-1, +1}."""
    return np.array([0.5 * (1.0 - x), 0.5 * (1.0 + x)])


def _q1_1d_deriv(x):
    return np.array([-0.5, 0.5])


def _q2_1d(x):
    """Quadratic Lagrange values at the three 1D nodes {-1, 0, +1}."""
    return np.array([0.5 * x * (x - 1.0),
                     (1.0 + x) * (1.0 - x),
                     0.5 * (1.0 + x) * x])


def _q2_1d_deriv(x):
    return np.array([0.5 * (2.0 * x - 1.0),
                     -2.0 * x,
                     0.5 * (2.0 * x + 1.0)])


def _tensor_basis(pts, vals_1d, derivs_1d, nb_1d):
    """Tabulate a tensor-product basis and its local derivatives.

    Returns (N, dN) with N: (nqp, nb) and dN: (nqp, ndim, nb).
    """
    nqp, ndim = pts.shape
    nb = nb_1d ** ndim
    N = np.zeros((nqp, nb))
    dN = np.zeros((nqp, ndim, nb))
    for q in range(nqp):
        v = [vals_1d(pts[q, d]) for d in range(ndim)]
        g = [derivs_1d(pts[q, d]) for d in range(ndim)]
        idx = 0
        if ndim == 2:
            for j in range(nb_1d):
                for i in range(nb_1d):
                    N[q, idx] = v[0][i] * v[1][j]
                    dN[q, 0, idx] = g[0][i] * v[1][j]
                    dN[q, 1, idx] = v[0][i] * g[1][j]
                    idx += 1
        else:
            for k in range(nb_1d):
                for j in range(nb_1d):
                    for i in range(nb_1d):
                        N[q, idx] = v[0][i] * v[1][j] * v[2][k]
                        dN[q, 0, idx] = g[0][i] * v[1][j] * v[2][k]
                        dN[q, 1, idx] = v[0][i] * g[1][j] * v[2][k]
                        dN[q, 2, idx] = v[0][i] * v[1][j] * g[2][k]
                        idx += 1
    return N, dN


def tabulate_q1(pts):
    """Q1 basis values/derivatives at points (nqp, ndim)."""
    return _tensor_basis(pts, _q1_1d, _q1_1d_deriv, 2)


def tabulate_q2(pts):
    """Q2 basis values/derivatives at points (nqp, ndim)."""
    return _tensor_basis(pts, _q2_1d, _q2_1d_deriv, 3)
