"""The port's driver on the host KSP/PC route against the JAX driver, on the
3D regression trees of tests/test_regression_{3d,ildl}.py (the reference's
own argv strings) and on the abf.opts tree forced onto the host stack with
-tpu 0. Comparison rules:
test_torch_host_compare.py."""

import pytest
import torch

from exsaddle_tpu_torch import driver as tdriver
from test_torch_host_compare import check_same_output

torch.set_num_threads(1)

# (name, argv)
CASES = [
    ("3d_1", "-saddle_pc_type jacobi -diagnostics -model 1 "
     "-saddle_ksp_converged_reason -mx 4 -my 7 -mz 5 -saddle_ksp_max_it 10"),
    ("3d_mg_1", "-model 2 -sinker_n 1 -mx 8 -mg -nlevels 2 -diagnostics "
     "-saddle_ksp_type fgmres -saddle_mg_levels_ksp_type gmres "
     "-saddle_mg_levels_pc_type jacobi -saddle_mg_levels_ksp_max_it 10 "
     "-saddle_ksp_monitor_short "
     "-saddle_mg_coarse_pc_factor_mat_solver_type umfpack"),
    ("abf_host", " ".join(tdriver.ABF_OPTS) + " -model 11 -size_x 0.1 -mx 4 "
     "-tpu 0 -saddle_ksp_monitor_short -saddle_ksp_converged_reason"),
    ("3d_ilupack_1", "-saddle_pc_type ilupack -saddle_pc_ilupack_droptol "
     "1e-3 -saddle_pc_ilupack_condest 100 -saddle_pc_ilupack_droptolS 1e-4 "
     "-mx 4 -saddle_ksp_monitor_short"),
    ("ildl_exact", "-mx 3 -model 6 -saddle_ksp_monitor_short "
     "-saddle_pc_type ildl -saddle_pc_ildl_droptol 0.0 "
     "-saddle_ksp_pc_side right -saddle_ksp_max_it 5"),
]


@pytest.mark.parametrize("name,args", CASES, ids=[c[0] for c in CASES])
def test_host_driver_matches_jax_3d(name, args):
    lines, r = check_same_output(args, 3)
    if name == "abf_host":
        # -tpu 0 really took the host stack: a KSP tree, no ABF solver
        assert "solver" not in r and r["its"] == 21
