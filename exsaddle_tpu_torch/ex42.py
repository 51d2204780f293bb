"""ex42: 3D Q1-Q1 stabilized Stokes on a single interleaved 4-dof grid, in
the PyTorch port.

The equivalent of the reference's modified PETSc tutorial ex42mod.c: Bochev
polynomial-projection stabilization (FormStabilisationOperatorQ13D,
ex42mod.c:671-727, the 0.015625 projection term), free-slip sides/bottom +
free-surface top imposed by zeroing element-matrix rows/cols
(ex42mod.c:917-933), models isoviscous (-model 0) and box sinker
(-model 1) (ex42mod.c:1455-1524), fieldsplit by fields u={0,1,2}/p={3}
(ex42mod.c:1561-1567), and the per-block residual monitor
KSPMonitorStokesBlocks (ex42mod.c:1339-1362).

Dof layout: interleaved per Q1 node [Vx,Vy,Vz,P], node x-fastest -- the
DMDA layout of ex42mod.c:1392. Elements are assembled on the host with 2x2x2
Gauss quadrature as batched einsums (Ex42Problem, a numpy copy of the JAX
package's); geometry is the unit box. The solve runs on the device: A and
its field blocks apply there as padded-row gathers (precond_mg.csr_apply),
and the Krylov bases live there. -device {cuda,cpu}, default cuda.

    python -m exsaddle_tpu_torch.ex42 -model 1 -mx 5 -stokes_pc_type ilu \\
        -stokes_ksp_rtol 1e-6 -stokes_ksp_monitor_blocks
"""

import sys
import time

import numpy as np
import torch

from exsaddle_tpu_torch import solver_config as sc
from exsaddle_tpu_torch.driver import resolve_device
from exsaddle_tpu_torch.krylov import KSPConfig
from exsaddle_tpu_torch.mesh import _element_node_map
from exsaddle_tpu_torch.options import Options
from exsaddle_tpu_torch.precond_mg import csr_apply

NSD = 3
NPE = 8          # nodes per element
UD = 3           # velocity dofs per node
DOF = 4


def _gauss2():
    g = 0.57735026919
    pts = np.array([[i, j, k] for k in (-g, g) for j in (-g, g)
                    for i in (-g, g)])
    return pts, np.ones(8)


def _q1_tables(pts):
    xi, et, ze = pts[:, 0], pts[:, 1], pts[:, 2]
    # local node order x-fastest (sx innermost)
    N = np.stack([0.125 * (1 + sx * xi) * (1 + sy * et) * (1 + sz * ze)
                  for sz in (-1, 1) for sy in (-1, 1) for sx in (-1, 1)])
    dN = np.zeros((8, 3, len(xi)))
    idx = 0
    for sz in (-1, 1):
        for sy in (-1, 1):
            for sx in (-1, 1):
                dN[idx, 0] = 0.125 * sx * (1 + sy * et) * (1 + sz * ze)
                dN[idx, 1] = 0.125 * (1 + sx * xi) * sy * (1 + sz * ze)
                dN[idx, 2] = 0.125 * (1 + sx * xi) * (1 + sy * et) * sz
                idx += 1
    return N.T, dN.transpose(2, 1, 0)    # (nqp, 8), (nqp, 3, 8)


class Ex42Problem:
    def __init__(self, mx, my, mz, opts, log=print):
        self.opts = opts
        self.log = log
        self.m_el = (mx, my, mz)
        self.nn = (mx + 1, my + 1, mz + 1)
        self.nnodes = int(np.prod(self.nn))
        self.ndof = DOF * self.nnodes
        self.el_nodes = _element_node_map(self.m_el, self.nn, 2, 1)
        nel = self.el_nodes.shape[0]

        pts, wq = _gauss2()
        N, dN = _q1_tables(pts)
        h = np.array([1.0 / m for m in self.m_el])     # unit box
        J = np.diag(h / 2.0)
        detJ = float(np.prod(h) / 8.0)
        GNx = np.einsum("qai,ab->qbi", dN, np.linalg.inv(J).T)  # (nqp,3,8)
        self.N, self.GNx, self.wq, self.detJ = N, GNx, wq, detJ

        # quadrature-point coordinates + model coefficients
        node_xyz = self._node_coords()
        elc = node_xyz[self.el_nodes]                   # (nel, 8, 3)
        gpc = np.einsum("qi,eid->eqd", N, elc)          # (nel, nqp, 3)
        self.eta, self.f, self.hc = self._model(gpc)

        self._assemble()

    def _node_coords(self):
        nx, ny, nz = self.nn
        kk, jj, ii = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                                 indexing="ij")
        return np.stack([ii.ravel() / (nx - 1), jj.ravel() / (ny - 1),
                         kk.ravel() / (nz - 1)], axis=1)

    def _model(self, gpc):
        """Models 0 (isoviscous) and 1 (sinker), ex42mod.c:1455-1524."""
        model = self.opts.get_int("model", 0)
        nel, nqp, _ = gpc.shape
        f = np.zeros((nel, nqp, 3))
        hc = np.zeros((nel, nqp))
        if model == 0:
            eta = np.ones((nel, nqp))
            f[:, :, 2] = -np.sin(2.2 * np.pi * gpc[:, :, 1]) \
                * np.cos(1.0 * np.pi * gpc[:, :, 0])
        elif model == 1:
            eta0 = self.opts.get_real("sinker_eta0", 1.0e-2)
            eta1 = self.opts.get_real("sinker_eta1", 1.0)
            inside = ((np.abs(gpc[:, :, 0] - 0.5) < 0.2)
                      & (np.abs(gpc[:, :, 1] - 0.5) < 0.2)
                      & (np.abs(gpc[:, :, 2] - 0.5) < 0.2))
            eta = np.where(inside, eta1, eta0)
            f[:, :, 2] = np.where(inside, 1.0, 0.0)
        else:
            raise ValueError(
                "No default model is supported. Choose either -model {0,1}")
        return eta, f, hc

    def _bc_components(self):
        """(nel, 8, 3) bool: True where the element-local dof is a
        constrained boundary normal component (free slip sides/bottom,
        free surface top -- ex42mod.c:917-933)."""
        nx, ny, nz = self.nn
        nodes = self.el_nodes                          # (nel, 8)
        gi = nodes % nx
        gj = (nodes // nx) % ny
        gk = nodes // (nx * ny)
        bc = np.zeros(nodes.shape + (3,), bool)
        bc[:, :, 0] = (gi == 0) | (gi == nx - 1)
        bc[:, :, 1] = (gj == 0) | (gj == ny - 1)
        bc[:, :, 2] = (gk == 0)
        return bc

    def _assemble(self):
        import scipy.sparse as sp
        N, GNx, wq, detJ = self.N, self.GNx, self.wq, self.detJ
        nel = self.el_nodes.shape[0]
        no_stab = self.opts.get_bool("no_stab", False)
        if no_stab:
            self.log("** WARNING ** You are assembling a Q1Q1 saddle point "
                     "system without the stabilization term")

        fac = wq[None, :] * detJ                       # (nel=1bc, nqp)
        facv = fac * self.eta                          # (nel, nqp)

        # stress operator B^T diag(2,2,2,1,1,1) B (ex42mod.c:560-617)
        nud = UD * NPE
        Ae = np.zeros((nel, nud, nud))
        for a in range(3):
            Ae[:, a::3, a::3] += 2.0 * np.einsum(
                "eq,qi,qj->eij", facv, GNx[:, a], GNx[:, a])
        for r, (a, b) in enumerate([(0, 1), (0, 2), (1, 2)]):
            Ga, Gb = GNx[:, b], GNx[:, a]
            Ae[:, a::3, a::3] += np.einsum("eq,qi,qj->eij", facv, Ga, Ga)
            Ae[:, a::3, b::3] += np.einsum("eq,qi,qj->eij", facv, Ga, Gb)
            Ae[:, b::3, a::3] += np.einsum("eq,qi,qj->eij", facv, Gb, Ga)
            Ae[:, b::3, b::3] += np.einsum("eq,qi,qj->eij", facv, Gb, Gb)

        # gradient Ge[(i,di),j] = -sum_q GNx[di,i] N[j] fac (ex42mod.c:619)
        Ge = -np.einsum("eq,qai,qj->eaij", np.broadcast_to(fac, facv.shape),
                        GNx, N)
        Ge = Ge.transpose(0, 2, 1, 3).reshape(nel, nud, NPE)
        De = np.transpose(Ge, (0, 2, 1)).copy()        # divergence = G^T

        # Bochev stabilization (ex42mod.c:671-727)
        eta_avg = self.eta.mean(axis=1)                # (nel,)
        Ce = -np.einsum("eq,qi,qj->eij", np.broadcast_to(fac, facv.shape),
                        N, N)
        Ce += (fac.sum() * 0.015625)                   # +fac*0.015625 per qp
        Ce = Ce / eta_avg[:, None, None]
        if no_stab:
            Ce = np.zeros_like(Ce)

        # RHS (ex42mod.c:954-1030)
        Fe = np.einsum("eq,qi,eqa->eia", np.broadcast_to(fac, facv.shape),
                       N, self.f).reshape(nel, nud)
        He = np.einsum("eq,qi,eq->ei", np.broadcast_to(fac, facv.shape),
                       N, self.hc)

        # boundary conditions: zero element rows/cols but KEEP the original
        # diagonal entry (_ZERO_ROWCOL_i, ex42mod.c:841-846)
        bc = self._bc_components().reshape(nel, nud)
        keep = (~bc).astype(float)
        diag = np.einsum("eii->ei", Ae).copy()
        Ae = Ae * keep[:, :, None]
        Ae *= keep[:, None, :]
        ii = np.arange(nud)
        Ae[:, ii, ii] = np.where(bc, diag, Ae[:, ii, ii])
        Ge = Ge * keep[:, :, None]
        De = De * keep[:, None, :]
        Fe = Fe * keep

        # scatter into interleaved CSR (dof = 4*node + c)
        udofs = (4 * self.el_nodes[:, :, None]
                 + np.arange(3)[None, None, :]).reshape(nel, nud)
        pdofs = 4 * self.el_nodes + 3
        rows, cols, vals = [], [], []

        def add(r, c, v):
            rows.append(np.broadcast_to(r[:, :, None], v.shape).ravel())
            cols.append(np.broadcast_to(c[:, None, :], v.shape).ravel())
            vals.append(v.ravel())

        add(udofs, udofs, Ae)
        add(udofs, pdofs, Ge)
        add(pdofs, udofs, De)
        add(pdofs, pdofs, Ce)
        A = sp.coo_matrix(
            (np.concatenate(vals),
             (np.concatenate(rows), np.concatenate(cols))),
            shape=(self.ndof, self.ndof)).tocsr()
        A.sum_duplicates()
        self.A = A

        F = np.zeros(self.ndof)
        np.add.at(F, udofs.ravel(), Fe.ravel())
        np.add.at(F, pdofs.ravel(), He.ravel())
        self.F = F

        self.u_dofs = np.nonzero(np.arange(self.ndof) % 4 != 3)[0]
        self.p_dofs = np.nonzero(np.arange(self.ndof) % 4 == 3)[0]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _shell(A, device, **kw):
    """MatShell of a host scipy CSR matrix whose apply runs on `device`."""
    return sc.MatShell(A.shape[0], csr_apply(A, device), device,
                       diagonal=lambda: A.diagonal(), csr=lambda: A,
                       dense=lambda: A.toarray(), **kw)


def solve_stokes_3d_coupled(mx, my, mz, opts, log=print, device=None):
    """ex42mod.c:1366-1624. device: a torch device; None reads -device
    (default cuda). Returns X as a tensor on the device, and the wall
    seconds of the setup (assembly and solver tree) and of the solve."""
    device = (resolve_device(opts.get_string("device", "cuda"))
              if device is None else torch.device(device))
    t0 = time.perf_counter()
    prob = Ex42Problem(mx, my, mz, opts, log=log)
    A = prob.A
    ud, pd = prob.u_dofs, prob.p_dofs

    amat = _shell(A, device)
    Auu = A[ud][:, ud].tocsr()
    App = A[pd][:, pd].tocsr()
    A00 = _shell(Auu, device, mg_info={"node_nn": prob.nn, "dof": 3})
    A11 = _shell(App, device)
    amat.fieldsplit = {
        "A00": A00, "A11": A11,
        "mult_up": csr_apply(A[ud][:, pd].tocsr(), device),
        "mult_pu": csr_apply(A[pd][:, ud].tocsr(), device),
        "Sp": A11,
        "index_sets": (ud, pd),
        "default_type": "additive",
    }

    ksp = sc.make_ksp(opts, "stokes_", amat,
                      ksp_defaults=KSPConfig(type="gmres"),
                      pc_default="fieldsplit", log=log)

    F = torch.as_tensor(prob.F, device=device)
    if opts.get_bool("ksp_monitor_blocks", False, prefix="stokes_"):
        def blocks_monitor(its, rnorm):
            x = ksp.build_solution() if hasattr(ksp, "build_solution") \
                else torch.zeros_like(F)
            r = F - amat.apply(x)
            nm = [float(torch.linalg.vector_norm(r[c::4])) for c in range(4)]
            log(f"{its:3d} KSP Component U,V,W,P residual norm "
                f"[ {nm[0]:1.12e}, {nm[1]:1.12e}, {nm[2]:1.12e}, "
                f"{nm[3]:1.12e} ]")
        ksp.cfg.monitor = blocks_monitor

    _sync(device)
    t1 = time.perf_counter()
    res = ksp.solve(F)
    _sync(device)
    t2 = time.perf_counter()
    X = res.x
    if opts.get_bool("ksp_view", False, prefix="stokes_"):
        from exsaddle_tpu_torch.ksp_view import view_ksp
        view_ksp(ksp, log=log)
    if opts.get_bool("write_pvts", False):
        from exsaddle_tpu_torch import io as esio
        # DAView3DPVTS (ex42mod.c:1322): one .pvts master + per-rank .vts
        # pieces; virtual ranks via -pvts_ranks (default 1 = serial piece)
        esio.write_pvts_interleaved("ex42-up", prob.nn, X,
                                    ("Vx", "Vy", "Vz", "P"),
                                    nranks=opts.get_int("pvts_ranks", 1),
                                    log=log)
    return {"X": X, "result": res, "prob": prob, "ksp": ksp,
            "seconds": {"setup": t1 - t0, "solve": t2 - t1}}


def main(argv=None):
    args = sys.argv[1:] if argv is None else argv
    opts = Options.from_args(args)
    mx = opts.get_int("mx", 10)
    my = opts.get_int("my", mx)
    mz = opts.get_int("mz", mx)
    return solve_stokes_3d_coupled(mx, my, mz, opts)


if __name__ == "__main__":
    main()
