"""-saddle_ksp_view: the port's solver-tree printer against the JAX driver's.

Each argv goes through both drivers on the CPU (the port with -device cpu;
the view sends both to the host KSP/PC route). The whole printed output
must agree by the rules of test_torch_host_compare.py, and the tree itself
line for line: every line identical, except the two runtime-value classes
of tests/test_regression_abf.py:38-53 (the Chebyshev 'eigenvalues estimate
via gmres' and 'eigenvalue estimates used' lines), whose numbers agree to
1e-5 relative."""

import re

import pytest
import torch

from exsaddle_tpu_torch import driver as tdriver

from test_torch_host_compare import _same_line, check_same_output
from exsaddle_tpu_torch.options import Options as TOptions

torch.set_num_threads(1)

_ESTEIG = re.compile(r"eigenvalues estimate via gmres|eigenvalue estimates "
                     r"used")

ARGV = {
    # the flagship abf.opts tree (tests/test_regression_abf.py:60-61) at
    # mx=4, cut to 3 outer its
    "abf_pseudoice": " ".join(tdriver.ABF_OPTS)
    + " -saddle_ksp_view -model 11 -size_x 0.1 -mx 4 "
      "-saddle_ksp_monitor_short -saddle_ksp_max_it 3",
    # tests/test_regression_3d.py:89-98, the -fs_coarse tree inside MG
    # (its coarse FGMRES capped at 5 its to keep the JAX run short)
    "3d_mg_fs_coarse": "-saddle_ksp_view -mx 2 -mg -nlevels 2 -fs_coarse "
    "-saddle_mg_levels_ksp_type gmres -saddle_ksp_monitor_short "
    "-saddle_ksp_converged_reason "
    "-saddle_mg_coarse_fieldsplit_u_pc_type jacobi "
    "-saddle_mg_coarse_fieldsplit_p_pc_type jacobi "
    "-saddle_mg_coarse_ksp_type fgmres "
    "-saddle_mg_coarse_ksp_convergence_test default "
    "-saddle_mg_levels_pc_type jacobi -saddle_ksp_max_it 1 "
    "-saddle_mg_coarse_ksp_max_it 5",
    # an MG tree whose coarse LU names its factor package (umfpack)
    "3d_mg_umfpack": "-saddle_ksp_view -model 2 -sinker_n 1 -mx 4 -mg "
    "-nlevels 2 -saddle_ksp_type fgmres -saddle_mg_levels_ksp_type gmres "
    "-saddle_mg_levels_pc_type jacobi -saddle_mg_levels_ksp_max_it 10 "
    "-saddle_mg_coarse_pc_factor_mat_solver_type umfpack "
    "-saddle_ksp_monitor_short",
    # tests/test_regression_ildl.py:44-46 at mx=4
    "ildl": "-saddle_ksp_view -mx 4 -model 6 -eta1 100 -eta0 1 "
    "-saddle_ksp_monitor_short -saddle_pc_type ildl "
    "-saddle_pc_ildl_droptol 1e-3 -saddle_ksp_pc_side right",
    # tests/test_regression_ildl.py:85-87
    "ilupack": "-saddle_ksp_view -saddle_pc_type ilupack "
    "-saddle_pc_ilupack_droptol 1e-3 -saddle_pc_ilupack_condest 100 "
    "-saddle_pc_ilupack_droptolS 1e-4 -mx 4 -saddle_ksp_monitor_short",
}


def _tree(lines):
    """The -ksp_view block: from the top KSP object to the end."""
    start = lines.index("KSP Object: (saddle_) 1 MPI processes")
    return lines[start:]


@pytest.mark.parametrize("name", sorted(ARGV))
def test_ksp_view_tree_matches_jax(name):
    tl, _, jl = check_same_output(ARGV[name], 3)
    tt, jt = _tree(tl), _tree(jl)
    assert len(tt) == len(jt) > 10
    for a, b in zip(tt, jt):
        if _ESTEIG.search(b):
            assert _same_line(a, b), f"\ntorch: {a}\njax:   {b}"
        else:
            assert a == b, f"\ntorch: {a}\njax:   {b}"


def test_ksp_view_runs_on_the_abf_tree_argv():
    """-saddle_ksp_view on the abf.opts argv takes the host route in the
    port (as in the JAX driver) and prints the fieldsplit/MG tree."""
    lines = []
    r = tdriver.saddle_solve(TOptions.from_args(
        ARGV["abf_pseudoice"].split() + ["-device", "cpu"]), 3,
        log=lines.append)
    assert "history" not in r           # the host route's result keys
    txt = "\n".join(lines)
    for frag in ("FieldSplit with Schur preconditioner, factorization UPPER",
                 "type is MULTIPLICATIVE, levels=3 cycles=v",
                 "restarts performed =",
                 "eigenvalues estimate via gmres min"):
        assert frag in txt, frag
