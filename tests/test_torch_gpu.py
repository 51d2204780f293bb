"""Card-only tests of the PyTorch port: each hand-written kernel against its
plain PyTorch version on CUDA tensors, and the driver on CUDA against the
driver on the CPU. They skip where there is no CUDA device.

This file imports nothing of JAX, so it runs on a machine that has only the
port's dependencies; there, skip tests/conftest.py (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from exsaddle_tpu_torch import driver as tdriver
from exsaddle_tpu_torch import matfree as tmf
from exsaddle_tpu_torch import models as tmodels
from exsaddle_tpu_torch.assembly import FESpace
from exsaddle_tpu_torch.kernels import a00
from exsaddle_tpu_torch.mesh import SaddleMesh
from exsaddle_tpu_torch.options import Options

# (nd, m_el, lame, model, size): test_fast_apply.CASES plus an odd 3D shape
CASES = [(2, (5, 4), False, "0", None),
         (3, (3, 4, 2), False, "11", (0.1, 1.0, 1.0)),
         (2, (4, 4), True, "6", None),
         (3, (3, 3, 3), True, "6", None),
         (2, (1, 1), False, "0", None),
         (3, (5, 7, 3), False, "11", (0.1, 1.0, 1.0))]

# kernel vs plain: float32 to float32 summation order, float64 to ~ulps
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _operator(case, dtype, device):
    nd, m_el, lame, model, size = case
    opts = Options.from_args(["-model", model])
    ctx = tmodels.ModelContext(opts, nd, lame=lame, log=lambda *a, **k: None)
    mesh = SaddleMesh(nd, m_el, size or (1.0,) * nd)
    fes = FESpace(mesh)
    bci, _ = tmodels.create_bc_list(ctx, mesh)
    coeff = tdriver.fine_coefficients(ctx, fes)
    bc_mask = np.zeros(mesh.ndof)
    bc_mask[:mesh.nu][bci] = 1.0
    return tmf.ParityMatFreeOperator.build(mesh, fes, coeff, bc_mask,
                                           lame=lame, dtype=dtype,
                                           device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_a00_kernel_matches_plain(cuda, case, dtype):
    op = _operator(case, dtype, cuda)
    x = torch.as_tensor(np.random.default_rng(8).standard_normal(op.nu),
                        dtype=dtype, device=cuda)
    n0 = a00.LAUNCHES.n
    yk = a00.a00_apply(op, x)
    assert a00.LAUNCHES.n == n0 + 1
    yp = a00.a00_apply_plain(op, x)
    torch.cuda.synchronize()
    assert float((yk - yp).abs().max()) <= TOL[dtype] * float(
        yp.abs().max())
    # the colour sweep has no atomics: repeated applies are bitwise equal
    assert torch.equal(a00.a00_apply(op, x), yk)


@pytest.mark.gpu
def test_a00_kernel_refuses_bad_input(cuda):
    op = _operator(CASES[1], torch.float32, cuda)
    x = torch.zeros(op.nu, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="x is torch.float64"):
        a00.a00_apply(op, x)
    with pytest.raises(ValueError, match="shape"):
        a00.a00_apply(op, torch.zeros(op.nu + 1, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        a00.a00_apply(op, torch.zeros(2 * op.nu, device=cuda)[::2])


@pytest.mark.gpu
def test_driver_on_cuda_matches_cpu(cuda):
    """The driver's default device runs K1 and reproduces the CPU run's
    iteration count and history (float64, mx=4 pseudoice)."""
    argv = tdriver.ABF_OPTS + "-model 11 -size_x 0.1 -mx 4".split()
    n0 = a00.LAUNCHES.n
    g = tdriver.saddle_solve(Options.from_args(argv), 3,
                             log=lambda *a: None)
    assert a00.LAUNCHES.n > n0
    c = tdriver.saddle_solve(Options.from_args(argv + ["-device", "cpu"]),
                             3, log=lambda *a: None)
    assert g["its"] == c["its"] and g["reason"] == c["reason"]
    assert np.abs(np.array(g["history"]) - np.array(c["history"])).max() \
        <= 1e-8 * max(c["history"])
