"""SolCx (models.c, -model 0): viscosity eta0 for x <= xc and eta1 beyond,
body force Fu_y = sin(nz pi y) cos(pi x); the normal velocity fixed on every
min face, on x = max and, in 3D, on z = max (free slip there); y = max is
free unless -freesliphack."""

import numpy as np


def coefficients(flags, x):
    eta0 = float(flags.get("eta0", 1.0))
    eta1 = float(flags.get("eta1", 1.0))
    xc = float(flags.get("solcx_xc", 0.5))
    nz = int(flags.get("solcx_nz", 1))
    eta = np.where(x[:, 0] > xc, eta1, eta0)
    Fu = np.zeros_like(x)
    Fu[:, 1] = np.sin(nz * np.pi * x[:, 1]) * np.cos(np.pi * x[:, 0])
    return eta, Fu, np.zeros(len(x))


def dirichlet(flags, mesh):
    nd = mesh.ndim
    idx = [nd * mesh.u_face_nodes(d, 0) + d for d in range(nd)]
    idx.append(nd * mesh.u_face_nodes(0, 1) + 0)
    if flags.get("freesliphack", False):
        idx.append(nd * mesh.u_face_nodes(1, 1) + 1)
    if nd == 3:
        idx.append(nd * mesh.u_face_nodes(2, 1) + 2)
    idx = np.concatenate(idx)
    return idx.astype(np.int64), np.zeros(len(idx))
