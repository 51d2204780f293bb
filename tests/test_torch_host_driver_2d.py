"""The port's driver on the host KSP/PC route against the JAX driver, on the
2D regression trees of tests/test_regression_{2d,asm,rank2,lame2d}.py (the
reference's own argv strings). Comparison rules:
test_torch_host_compare.py."""

import pytest
import torch

from test_torch_host_compare import check_same_output

torch.set_num_threads(1)

# (name, argv, lame, nranks)
CASES = [
    ("2d_1", "-model 0 -mx 4 -diagnostics -saddle_ksp_max_it 100 "
     "-saddle_ksp_converged_reason -saddle_pc_type jacobi", False, 1),
    ("2d_fs_1", "-model 0 -fs -mx 6 -diagnostics -saddle_ksp_monitor_short",
     False, 1),
    ("2d_mms_1", "-saddle_pc_type lu -saddle_pc_factor_mat_solver_type "
     "umfpack -model 101 -check_solution -saddle_ksp_monitor_short -mx 16 "
     "-constant_pressure_nullspace", False, 1),
    ("2d_asm_1", "-mx 12 -saddle_pc_type asm -saddle_pc_asm_dm_subdomains "
     "-set_ksp_dm -options_left -saddle_ksp_monitor_short "
     "-saddle_sub_ksp_type preonly -saddle_sub_pc_type lu "
     "-saddle_sub_pc_factor_mat_solver_type umfpack -dmdafe_overlap 1 "
     "-saddle_ksp_rtol 1e-4", False, 9),
    ("2d_fs_2", "-model 0 -fs -mx 6 -diagnostics -saddle_ksp_monitor_short",
     False, 2),
    ("2d_lame_mg_1", "-mx 16 -mg -nlevels 3 -diagnostics "
     "-saddle_ksp_type fgmres -saddle_mg_levels_ksp_type gmres "
     "-saddle_mg_levels_pc_type jacobi -saddle_mg_levels_ksp_max_it 10 "
     "-saddle_ksp_monitor_short "
     "-saddle_mg_coarse_pc_factor_mat_solver_type umfpack", True, 1),
]


@pytest.mark.parametrize("name,args,lame,nranks", CASES,
                         ids=[c[0] for c in CASES])
def test_host_driver_matches_jax_2d(name, args, lame, nranks):
    check_same_output(args, 2, lame=lame, nranks=nranks)
