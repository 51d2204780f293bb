"""Tensor-product Gauss-Legendre quadrature on [-1,1]^d.

Capability parity with the reference's FEMixedSpaceQuadratureCreate
(femixedspace.c:1366-1408): a fixed 3-point rule per dimension, points
ordered with the x index fastest (i, then j, then k).
"""

import numpy as np

# 3-point Gauss-Legendre rule, written to the same precision the reference
# hard-codes (femixedspace.c:1379-1380) so qp coordinates/weights agree bitwise.
_XI_1D = np.array([-0.774596669241483, 0.0, 0.774596669241483], dtype=np.float64)
_WT_1D = np.array([0.555555555555556, 0.888888888888889, 0.555555555555556],
                  dtype=np.float64)


def gauss_tensor(ndim: int):
    """Return (points, weights) for the 3^ndim tensor rule.

    points: (nqp, ndim) float64, x-index fastest.
    weights: (nqp,) float64.
    """
    if ndim == 2:
        pts = np.array([[_XI_1D[i], _XI_1D[j]]
                        for j in range(3) for i in range(3)])
        wts = np.array([_WT_1D[i] * _WT_1D[j]
                        for j in range(3) for i in range(3)])
    elif ndim == 3:
        pts = np.array([[_XI_1D[i], _XI_1D[j], _XI_1D[k]]
                        for k in range(3) for j in range(3) for i in range(3)])
        wts = np.array([_WT_1D[i] * _WT_1D[j] * _WT_1D[k]
                        for k in range(3) for j in range(3) for i in range(3)])
    else:
        raise ValueError(f"ndim must be 2 or 3, got {ndim}")
    return pts, wts
