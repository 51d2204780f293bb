"""-ksp_view: PETSc-format solver-tree printer (the port's copy of
exsaddle_tpu/ksp_view.py, over the port's KSP/PC objects; host code only).

Structural equivalent of KSPView/PCView as exercised by the reference
(testref/exSaddle3d_pseudoice_1.ref:27-360, exSaddle3d_ilupack_1.ref):
prints the nested KSP/PC/Mat object tree in PETSc's wording, indentation
and float formatting ('%g' with a trailing '.' on integral reals).

The full pseudoice tree is line-diffed against the reference
(tests/test_regression_abf.py), so this printer reproduces:
  - nested sub-KSP views (fieldsplit splits, MG coarse/levels, bjacobi
    blocks, Chebyshev esteig) with numbered level prefixes;
  - Mat stat lines: rows/cols, block size, nonzeros + ALLOCATED nonzeros
    (the reference's preallocation estimate, matfree.allocated_nnz),
    I-node summaries (velocity dof-triples coalesce; pressure rows do not);
  - factored-matrix blocks for LU/ILU including the configured factor
    package (umfpack stand-in: stable dense LU, precond.PCLU) and
    UMFPACK's static run-parameter table;
  - the schurcomplement operator view ('linear system matrix followed by
    preconditioner matrix') including the embedded 'KSP of A00' re-view.

Values PETSc derives from its own runtime internals (Chebyshev eigenvalue
estimates from the noisy-RHS esteig solve, GCR 'restarts performed') are
computed from this framework's equivalents and may differ in low digits;
the regression test compares them with a documented tolerance."""

from exsaddle_tpu_torch import precond, precond_mg


def _g(v):
    """PETSc '%g' real formatting: trailing '.' when no decimal point or
    exponent appears (PetscViewerASCIIPrintf %g convention: '10000.',
    '0.', '0.2', '1e-05')."""
    s = f"{float(v):g}"
    if "." not in s and "e" not in s and "n" not in s:
        s += "."
    return s


_UMFPACK_PARAMS = """UMFPACK run parameters:
  Control[UMFPACK_PRL]: 1.
  Control[UMFPACK_STRATEGY]: 0.
  Control[UMFPACK_DENSE_COL]: 0.2
  Control[UMFPACK_DENSE_ROW]: 0.2
  Control[UMFPACK_AMD_DENSE]: 10.
  Control[UMFPACK_BLOCK_SIZE]: 32.
  Control[UMFPACK_FIXQ]: 0.
  Control[UMFPACK_AGGRESSIVE]: 1.
  Control[UMFPACK_PIVOT_TOLERANCE]: 0.1
  Control[UMFPACK_SYM_PIVOT_TOLERANCE]: 0.001
  Control[UMFPACK_SCALE]: 1.
  Control[UMFPACK_ALLOC_INIT]: 0.7
  Control[UMFPACK_DROPTOL]: 0.
  Control[UMFPACK_IRSTEP]: 0.
  Control[UMFPACK_ORDERING]: AMD (not using the PETSc ordering)"""


def _vi(mat, key, default=None):
    info = getattr(mat, "view_info", None) or {}
    return info.get(key, default)


def _ksp_header(ksp, log, indent, nranks):
    """The KSP-object header block (shared by full views and the esteig
    sub-view, which has no PC part)."""
    sp = " " * indent
    cfg = ksp.cfg
    pre = f"({cfg.prefix}) " if cfg.prefix else ""
    log(f"{sp}KSP Object: {pre}{nranks} MPI processes")
    log(f"{sp}  type: {cfg.type}")
    if cfg.type in ("gmres", "fgmres"):
        log(f"{sp}    restart={cfg.restart}, using Classical (unmodified) "
            "Gram-Schmidt Orthogonalization with no iterative refinement")
        log(f"{sp}    happy breakdown tolerance 1e-30")
    elif cfg.type == "gcr":
        log(f"{sp}    restart = {cfg.restart} ")
        log(f"{sp}    restarts performed = "
            f"{getattr(ksp, 'gcr_restarts', 0)} ")
    elif cfg.type == "chebyshev":
        used = getattr(ksp, "_cheb_eigs", None)
        est = getattr(ksp, "cheb_eig_estimates", None)
        if used is not None:
            log(f"{sp}    eigenvalue estimates used:  min = {_g(used[0])}, "
                f"max = {_g(used[1])}")
        if est is not None:
            log(f"{sp}    eigenvalues estimate via gmres min {_g(est[0])}, "
                f"max {_g(est[1])}")
        if cfg.cheb_esteig:
            t = cfg.cheb_esteig_transform
            log(f"{sp}    eigenvalues estimated using gmres with "
                f"translations  [{_g(t[0])} {_g(t[1])}; "
                f"{_g(t[2])} {_g(t[3])}]")
            # the esteig sub-KSP (KSPChebyshevEstEig defaults,
            # krylov.KSP._estimate_eigenvalues)
            esp = " " * (indent + 4)
            epre = f"({cfg.prefix}esteig_) " if cfg.prefix else "(esteig_) "
            log(f"{esp}KSP Object: {epre}{nranks} MPI processes")
            log(f"{esp}  type: gmres")
            log(f"{esp}    restart=30, using Classical (unmodified) "
                "Gram-Schmidt Orthogonalization with no iterative "
                "refinement")
            log(f"{esp}    happy breakdown tolerance 1e-30")
            log(f"{esp}  maximum iterations=10, initial guess is zero")
            log(f"{esp}  tolerances:  relative=1e-12, absolute=1e-50, "
                f"divergence={_g(10000.0)}")
            log(f"{esp}  left preconditioning")
            log(f"{esp}  using PRECONDITIONED norm type for convergence "
                "test")
            log(f"{sp}    estimating eigenvalues using noisy right hand "
                "side")
    guess = ("nonzero initial guess" if cfg.initial_guess_nonzero
             else "initial guess is zero")
    log(f"{sp}  maximum iterations={cfg.max_it}, {guess}")
    log(f"{sp}  tolerances:  relative={_g(cfg.rtol)}, "
        f"absolute={_g(cfg.abstol)}, divergence={_g(cfg.dtol)}")
    log(f"{sp}  {cfg.resolved_pc_side()} preconditioning")
    shown_norm = (getattr(cfg, "view_norm_type", None)
                  or cfg.resolved_norm_type())
    log(f"{sp}  using {shown_norm.upper()} norm type for "
        "convergence test")


def view_ksp(ksp, log=print, indent=0, nranks=1, mat_label=None):
    _ksp_header(ksp, log, indent, nranks)
    view_pc(ksp.pc, ksp.cfg.prefix, log, indent, nranks,
            pmat=getattr(ksp, "pmat", None), amat=getattr(ksp, "amat", None),
            mat_label=mat_label)


def _mat_lines(mat, log, indent, nranks, name=None):
    """The seqaij/mpiaij Mat stat block."""
    sp = " " * indent
    if mat is None:
        return
    nm = name if name is not None else _vi(mat, "name")
    nm = f"{nm} " if nm else ""
    log(f"{sp}Mat Object: {nm}{nranks} MPI processes")
    log(f"{sp}  type: {'seqaij' if nranks == 1 else 'mpiaij'}")
    n = getattr(mat, "n", None)
    nnz = None
    A = getattr(mat, "_csr", None)
    if A is not None:
        if callable(A):
            A = mat.csr()
        nnz = A.nnz
    bs = _vi(mat, "bs")
    bss = f", bs={bs}" if bs else ""
    log(f"{sp}  rows={n}, cols={n}{bss}")
    if nnz is not None:
        alloc = _vi(mat, "allocated", nnz)
        log(f"{sp}  total: nonzeros={nnz}, allocated nonzeros={alloc}")
    log(f"{sp}  total number of mallocs used during MatSetValues calls=0")
    inode = _vi(mat, "inode")
    if inode:
        log(f"{sp}    using I-node routines: found {inode} nodes, "
            "limit used is 5")
    else:
        log(f"{sp}    not using I-node routines")


def _factored_block(log, indent, nranks, package, rows, nnz=None,
                    inode=None):
    """'Factored matrix follows:' block of PCView_LU/ILU."""
    sp = " " * indent
    log(f"{sp}Factored matrix follows:")
    log(f"{sp}  Mat Object: {nranks} MPI processes")
    if package == "umfpack":
        log(f"{sp}    type: umfpack")
        log(f"{sp}    rows={rows}, cols={rows}")
        log(f"{sp}    package used to perform factorization: umfpack")
        log(f"{sp}    total: nonzeros=0, allocated nonzeros=0")
        log(f"{sp}    total number of mallocs used during MatSetValues "
            "calls=0")
        for ln in _UMFPACK_PARAMS.split("\n"):
            log(f"{sp}      {ln}")
    else:
        log(f"{sp}    type: seqaij")
        log(f"{sp}    rows={rows}, cols={rows}")
        log(f"{sp}    package used to perform factorization: petsc")
        nz = nnz if nnz is not None else 0
        log(f"{sp}    total: nonzeros={nz}, allocated nonzeros={nz}")
        log(f"{sp}    total number of mallocs used during MatSetValues "
            "calls=0")
        if inode:
            log(f"{sp}      using I-node routines: found {inode} nodes, "
                "limit used is 5")
        else:
            log(f"{sp}      not using I-node routines")


def _schurcomplement_lines(pc, prefix, log, indent, nranks):
    """MatView of a MATSCHURCOMPLEMENT operator (the fieldsplit-Schur
    split-1 amat), including the embedded 'KSP of A00' re-view."""
    sp = " " * indent
    info = getattr(pc, "schur_view", None)
    pre = f"({prefix}) " if prefix else ""
    np_ = info["A11"].n if info else None
    nu = info["A00_n"] if info else None
    log(f"{sp}Mat Object: {pre}{nranks} MPI processes")
    log(f"{sp}  type: schurcomplement")
    log(f"{sp}  rows={np_}, cols={np_}")
    log(f"{sp}    Schur complement A11 - A10 inv(A00) A01")
    log(f"{sp}    A11")
    _mat_lines(info["A11"], log, indent + 6, nranks)
    log(f"{sp}    A10")
    a10 = info.get("A10_nnz")
    log(f"{sp}      Mat Object: {nranks} MPI processes")
    log(f"{sp}        type: {'seqaij' if nranks == 1 else 'mpiaij'}")
    log(f"{sp}        rows={np_}, cols={nu}")
    log(f"{sp}        total: nonzeros={a10}, allocated nonzeros={a10}")
    log(f"{sp}        total number of mallocs used during MatSetValues "
        "calls=0")
    log(f"{sp}          not using I-node routines")
    log(f"{sp}    KSP of A00")
    view_ksp(pc.ksp_A00, log, indent + 6, nranks)
    log(f"{sp}    A01")
    log(f"{sp}      Mat Object: {nranks} MPI processes")
    log(f"{sp}        type: {'seqaij' if nranks == 1 else 'mpiaij'}")
    log(f"{sp}        rows={nu}, cols={np_}")
    log(f"{sp}        total: nonzeros={a10}, allocated nonzeros={a10}")
    log(f"{sp}        total number of mallocs used during MatSetValues "
        "calls=0")
    inode = info.get("A01_inode")
    if inode:
        log(f"{sp}          using I-node routines: found {inode} nodes, "
            "limit used is 5")
    else:
        log(f"{sp}          not using I-node routines")


def view_pc(pc, prefix, log=print, indent=0, nranks=1, pmat=None, amat=None,
            mat_label=None):
    sp = " " * indent
    pre = f"({prefix}) " if prefix else ""
    log(f"{sp}PC Object: {pre}{nranks} MPI processes")

    def mat_footer():
        if (amat is not None and pmat is not None and amat is not pmat
                and isinstance(pc, (precond.PCBJacobi, precond.PCJacobi,
                                    precond.PCILU, precond.PCLU,
                                    precond.PCNone))
                and getattr(amat, "schur_of", None) is not None):
            log(f"{sp}  linear system matrix followed by preconditioner "
                "matrix:")
            _schurcomplement_lines(amat.schur_of, prefix, log, indent + 2,
                                   nranks)
            _mat_lines(pmat, log, indent + 2, nranks, name=mat_label)
        else:
            log(f"{sp}  linear system matrix = precond matrix:")
            _mat_lines(pmat, log, indent + 2, nranks, name=mat_label)

    if isinstance(pc, precond.PCNone):
        log(f"{sp}  type: none")
        mat_footer()
    elif isinstance(pc, precond.PCJacobi):
        log(f"{sp}  type: jacobi")
        mat_footer()
    elif isinstance(pc, precond.PCILU):
        log(f"{sp}  type: ilu")
        log(f"{sp}    out-of-place factorization")
        log(f"{sp}    0 levels of fill")
        log(f"{sp}    tolerance for zero pivot 2.22045e-14")
        log(f"{sp}    matrix ordering: natural")
        log(f"{sp}    factor fill ratio given {_g(1)}, needed {_g(1)}")
        nnz = None
        if pmat is not None and getattr(pmat, "_csr", None) is not None:
            nnz = pmat.csr().nnz
        _factored_block(log, indent + 6, nranks, "petsc",
                        getattr(pmat, "n", pc.n), nnz=nnz,
                        inode=_vi(pmat, "inode") if pmat else None)
        mat_footer()
    elif isinstance(pc, precond.PCLU):
        pkg = getattr(pc, "factor_package", None) or "petsc"
        log(f"{sp}  type: lu")
        log(f"{sp}    out-of-place factorization")
        log(f"{sp}    tolerance for zero pivot 2.22045e-14")
        if pkg == "umfpack":
            log(f"{sp}    using diagonal shift on blocks to prevent zero "
                "pivot [INBLOCKS]")
        log(f"{sp}    matrix ordering: nd")
        if pkg == "umfpack":
            log(f"{sp}    factor fill ratio given {_g(0)}, needed {_g(0)}")
            _factored_block(log, indent + 6, nranks, "umfpack",
                            getattr(pmat, "n", None))
        mat_footer()
    elif isinstance(pc, precond.PCBJacobi):
        log(f"{sp}  type: bjacobi")
        log(f"{sp}    number of blocks = {len(pc.subs)}")
        log(f"{sp}    Local solve is same for all blocks, in the following "
            "KSP and PC objects:")
        view_ksp(pc.subs[0], log, indent + 4, 1, mat_label=mat_label)
        mat_footer()
    elif isinstance(pc, precond.PCASM):
        log(f"{sp}  type: asm")
        log(f"{sp}    total subdomain blocks = {len(pc.subksps)}, "
            f"amount of overlap = {getattr(pc, 'overlap', 0)}")
        log(f"{sp}    restriction/interpolation type - RESTRICT")
        log(f"{sp}    Local solve is same for all blocks, in the following "
            "KSP and PC objects:")
        view_ksp(pc.subksps[0], log, indent + 4, 1)
        mat_footer()
    elif isinstance(pc, precond.PCFieldSplitSchurUpper):
        log(f"{sp}  type: fieldsplit")
        log(f"{sp}    FieldSplit with Schur preconditioner, "
            "factorization UPPER")
        log(f"{sp}    Preconditioner for the Schur complement formed from "
            "user provided matrix")
        log(f"{sp}    Split info:")
        log(f"{sp}    Split number 0 Defined by IS")
        log(f"{sp}    Split number 1 Defined by IS")
        log(f"{sp}    KSP solver for A00 block")
        view_ksp(pc.ksp_A00, log, indent + 6, nranks)
        log(f"{sp}    KSP solver for S = A11 - A10 inv(A00) A01 ")
        # the Schur-pre matrix's own name: "Mpscaled" on the fine level,
        # "Mpscaled_coarse" inside -fs_coarse (exSaddle.c:316,369)
        view_ksp(pc.ksp_schur, log, indent + 6, nranks)
        mat_footer()
    elif isinstance(pc, precond.PCFieldSplitAdditive):
        log(f"{sp}  type: fieldsplit")
        log(f"{sp}    FieldSplit with ADDITIVE composition: total splits = "
            f"{len(pc.splits)}")
        for i, (idx, sub) in enumerate(pc.splits):
            log(f"{sp}    Split number {i} Defined by IS")
        for i, (idx, sub) in enumerate(pc.splits):
            log(f"{sp}    KSP solver for split {i}")
            view_ksp(sub, log, indent + 6, nranks)
        mat_footer()
    elif isinstance(pc, precond_mg.PCMG):
        log(f"{sp}  type: mg")
        log(f"{sp}    type is MULTIPLICATIVE, levels={pc.nlevels} cycles=v")
        log(f"{sp}      Cycles per PCApply=1")
        if getattr(pc, "galerkin", False):
            log(f"{sp}      Using Galerkin computed coarse grid matrices")
        else:
            log(f"{sp}      Not using Galerkin computed coarse grid "
                "matrices")
        log(f"{sp}  Coarse grid solver -- level "
            "-------------------------------")
        view_ksp(pc.coarse_ksp, log, indent + 4, nranks)
        for k, lvl in enumerate(pc.levels):
            log(f"{sp}  Down solver (pre-smoother) on level {k + 1} "
                "-------------------------------")
            view_ksp(lvl.smoother, log, indent + 4, nranks)
            log(f"{sp}  Up solver (post-smoother) same as down solver "
                "(pre-smoother)")
        mat_footer()
    elif isinstance(pc, precond.PCILDL):
        log(f"{sp}  type: ildl")
        log(f"{sp}    ILDL: incomplete LDL^T with drop tolerance")
        log(f"{sp}    factor nonzeros (incl. diagonal) = {pc.fact.nnz}")
        mat_footer()
    elif isinstance(pc, precond.PCILUPACK):
        log(f"{sp}  type: ilupack")
        log(f"{sp}    ILUPACK: droptol  : {_g(pc.droptol)}")
        log(f"{sp}    ILUPACK: droptolS : {_g(pc.droptolS)}")
        log(f"{sp}    ILUPACK: condest  : {_g(pc.condest)}")
        mat_footer()
    else:
        log(f"{sp}  type: {type(pc).__name__}")
        mat_footer()
