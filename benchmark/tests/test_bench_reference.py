"""The reference (benchmark/reference) at tiny meshes against the
configurations' analytic pieces: exact quadrature and bases, a symmetric
A00 and a saddle structure, rigid motions in the null space of A00 and of
the divergence, the Dirichlet rows, the load's integral; and against the
system's own float64 operator."""

import numpy as np
import pytest
import torch

from benchmark.reference import fem
from benchmark.reference.models import pseudoice, solcx

CASES = [("pseudoice", pseudoice, (2, 3, 2), (0.1, 1.0, 1.0),
          {"model": 11, "size_x": 0.1}),
         ("solcx_ar", solcx, (3, 2, 4), (1.0, 1.0, 0.1),
          {"model": 0, "size_z": 0.1})]
IDS = [c[0] for c in CASES]


def _problem(mod, m_el, size, flags, bc=True):
    mesh = fem.Mesh(m_el, size)
    fes = fem.FESpace(mesh)
    eta, Fu, Fp = mod.coefficients(flags, fes.qp_coords.reshape(-1, 3))
    cq = np.concatenate([eta[:, None], Fu, Fp[:, None]], axis=1)
    cq = fem.projected(fes, cq.reshape(mesh.nel, fes.nqp, -1))
    bc_idx, bc_vals = (mod.dirichlet(flags, mesh) if bc
                       else (np.zeros(0, np.int64), np.zeros(0)))
    return mesh, fes, cq, bc_idx, bc_vals


def _dense(op, n):
    return op(torch.eye(n, dtype=torch.float64)).numpy()


def test_gauss_rule_and_bases():
    pts, w = fem.gauss_tensor(3)
    assert abs(w.sum() - 8.0) < 1e-13
    # degree 5 per axis is integrated exactly (to the rule's 15 digits)
    assert abs((w * pts[:, 0] ** 4 * pts[:, 1] ** 2).sum()
               - 0.4 * (2.0 / 3.0) * 2.0) < 1e-13
    for tab, nb in ((fem.tabulate_q1, 2), (fem.tabulate_q2, 3)):
        N, dN = tab(pts)
        assert np.allclose(N.sum(axis=1), 1.0, atol=1e-14)
        assert np.allclose(dN.sum(axis=2), 0.0, atol=1e-13)
        nodes = np.linspace(-1.0, 1.0, nb)
        grid = np.stack(np.meshgrid(nodes, nodes, nodes, indexing="ij"),
                        axis=-1).reshape(-1, 3)[:, ::-1]
        assert np.allclose(tab(grid)[0], np.eye(nb ** 3), atol=1e-14)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_a00_symmetric_and_saddle(case):
    _, mod, m_el, size, flags = case
    mesh, fes, cq, bc_idx, _ = _problem(mod, m_el, size, flags)
    S = fem.Saddle(fes, cq[..., 0], bc_idx, "cpu", block=5)
    K = _dense(S.apply_raw, mesh.ndof)
    nu = mesh.nu
    scale = np.abs(K).max()
    assert np.abs(K - K.T).max() <= 1e-13 * scale
    assert np.abs(K[nu:, nu:]).max() == 0.0
    # A00 is positive semi-definite, and definite once the rows are fixed
    assert np.linalg.eigvalsh(K[:nu, :nu]).min() > -1e-10 * scale
    A = _dense(S.apply, mesh.ndof)
    assert np.abs(A - A.T).max() <= 1e-13 * scale
    free = np.setdiff1d(np.arange(nu), bc_idx)
    assert np.linalg.eigvalsh(A[np.ix_(free, free)]).min() > 0.0


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_rigid_motions_strain_and_divergence_free(case):
    _, mod, m_el, size, flags = case
    mesh, fes, cq, _, _ = _problem(mod, m_el, size, flags)
    S = fem.Saddle(fes, cq[..., 0], [], "cpu")
    x = mesh.u_coords
    rng = np.random.default_rng(0)
    t, w = rng.standard_normal(3), rng.standard_normal(3)
    u = t[None, :] + np.cross(w[None, :], x)             # translation + spin
    X = np.zeros((mesh.ndof, 1))
    X[:mesh.nu, 0] = u.ravel()
    Y = S.apply_raw(torch.as_tensor(X)).numpy()[:, 0]
    ref = np.abs(_dense(S.apply_raw, mesh.ndof)).max() * np.abs(u).max()
    assert np.abs(Y).max() <= 1e-12 * ref


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_dirichlet_rows(case):
    _, mod, m_el, size, flags = case
    mesh, fes, cq, bc_idx, bc_vals = _problem(mod, m_el, size, flags)
    assert len(bc_idx) > 0
    S = fem.Saddle(fes, cq[..., 0], bc_idx, "cpu")
    A = _dense(S.apply, mesh.ndof)
    assert np.array_equal(A[bc_idx], np.eye(mesh.ndof)[bc_idx])
    assert np.array_equal(A[:, bc_idx], np.eye(mesh.ndof)[:, bc_idx])
    F = fem.rhs_vector(fes, cq[..., 1:4], cq[..., 4], bc_idx, bc_vals)
    assert np.array_equal(F[bc_idx], bc_vals)
    x = np.linalg.solve(A, S.rhs(torch.as_tensor(F[:, None])).numpy())
    assert np.array_equal(x[bc_idx, 0], bc_vals)
    res = S.rel_residuals(torch.as_tensor(F[:, None]), torch.as_tensor(x))
    assert float(res[0]) < 1e-12


def test_load_integral():
    """A unit body force along z assembles to the box's volume in the z
    rows (the Q2 basis is a partition of unity)."""
    mesh, fes, cq, _, _ = _problem(pseudoice, (2, 3, 2), (0.1, 1.0, 1.0),
                                   {"model": 11, "size_x": 0.1}, bc=False)
    F = fem.rhs_vector(fes, cq[..., 1:4], cq[..., 4], [], [])
    assert abs(F[2:mesh.nu:3].sum() - 0.1) < 1e-14
    assert np.abs(F[0:mesh.nu:3]).max() == 0.0
    assert np.abs(F[mesh.nu:]).max() == 0.0


def test_shared_geometry_path_matches_per_element():
    """Past 4096 elements a translate-congruent box shares one element's
    geometry; its element matrices are the per-element ones."""
    flags = {"model": 11, "size_x": 0.1}
    mesh = fem.Mesh((17, 16, 16), (0.1, 1.0, 1.0))
    fes = fem.FESpace(mesh)
    assert fes.shared
    eta, _, _ = pseudoice.coefficients(flags, fes.qp_coords.reshape(-1, 3))
    S = fem.Saddle(fes, eta.reshape(mesh.nel, -1), [], "cpu")
    els = torch.tensor([0, 1000, mesh.nel - 1])
    shared = S.element_matrices(els)
    S.shared = False
    S.G = torch.as_tensor(np.ascontiguousarray(fes.dNu_glob[[0]]).repeat(
        mesh.nel, axis=0))
    assert torch.allclose(S.element_matrices(els), shared, rtol=0,
                          atol=1e-12 * float(shared.abs().max()))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_reference_agrees_with_the_system(case):
    """The same problem worked out by the system under test (its float64
    natural-order operator and load): equal to rounding."""
    from exsaddle_tpu_torch import driver, models
    from exsaddle_tpu_torch.assembly import (FESpace, assemble_rhs,
                                             scatter_vector)
    from exsaddle_tpu_torch.matfree import MatFreeSaddleOperator
    from exsaddle_tpu_torch.mesh import SaddleMesh
    from exsaddle_tpu_torch.options import Options
    _, mod, m_el, size, flags = case
    mesh, fes, cq, bc_idx, bc_vals = _problem(mod, m_el, size, flags)
    args = sum([["-" + k, str(v)] for k, v in flags.items()], [])
    ctx = models.ModelContext(Options.from_args(args), 3,
                              log=lambda *a, **k: None)
    pmesh = SaddleMesh(3, m_el, size)
    pfes = FESpace(pmesh)
    pbc, pvals = models.create_bc_list(ctx, pmesh)
    coeff = driver.fine_coefficients(ctx, pfes)
    assert sorted(pbc) == sorted(bc_idx)
    mask = np.zeros(mesh.ndof)
    mask[pbc] = 1.0
    op = MatFreeSaddleOperator.build(pmesh, pfes, coeff, mask,
                                     dtype=torch.float64, device="cpu")
    S = fem.Saddle(fes, cq[..., 0], bc_idx, "cpu")
    X = torch.randn(mesh.ndof, 2, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    Y = torch.stack([op.mult(X[:, k]) for k in range(2)], dim=1)
    assert float((S.apply(X) - Y).abs().max()) <= 1e-13 * float(
        Y.abs().max())
    f1, f2 = assemble_rhs(pfes, coeff["Fu"], coeff["Fp"])
    Fp = scatter_vector(pmesh, f1, f2)
    Fp[pbc] = pvals
    F = fem.rhs_vector(fes, cq[..., 1:4], cq[..., 4], bc_idx, bc_vals)
    assert np.abs(F - Fp).max() <= 1e-14 * np.abs(Fp).max()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_device_load_is_the_assembled_load(case):
    """Saddle.load (the traffic's assembly, on the device) against the
    numpy rhs_vector."""
    _, mod, m_el, size, flags = case
    mesh, fes, cq, bc_idx, bc_vals = _problem(mod, m_el, size, flags)
    S = fem.Saddle(fes, cq[..., 0], bc_idx, "cpu", block=3)
    rng = np.random.default_rng(3)
    Fu = cq[..., 1:4] * (1.0 + 0.1 * rng.uniform(-1, 1, cq.shape[:2]))[
        ..., None]
    Fp = rng.standard_normal(cq.shape[:2])
    F = fem.rhs_vector(fes, Fu, Fp, bc_idx, bc_vals)
    G = S.load(torch.as_tensor(Fu), torch.as_tensor(Fp), bc_vals).numpy()
    assert np.abs(F - G).max() <= 1e-15 * np.abs(F).max()
