"""Physics models: coefficient fields, boundary conditions, reference solutions.

Capability parity with the reference's models.c:
  - Stokes coefficient models (dispatch models.c:1482-1525): SolCx (0),
    ThreeSinker (1), XSinker (2), SolCx3d (5, 3D), OneSinker (6),
    SinkerPtatin (7, 3D), PseudoIce (11, 3D), MMS1 (101, 2D).
  - Lame coefficient models (dispatch models.c:855-881): XSinker (2),
    OneSinker (6/8/10/12), Homogeneous (9).
  - BC lists (dispatch models.c:610-648): SolCx free-slip-style normal
    constraints, FixedBase, Compression, Compression2, StokesMMS1.
  - MMS1 reference solution (models.c:1534-1624).

Coefficient evaluation is vectorized over arrays of points (the reference
evaluates point-by-point in C loops). Model banners reproduce the reference's
one-shot "been_here" prints byte-for-byte (e.g. testref/exSaddle2d_1.ref:1-6).
"""

import numpy as np

# models.h:9-13: DEFAULT_MODEL is 6 (one sinker) for Lame, 2 (XSinker) for
# Stokes
DEFAULT_MODEL_LAME = 6
DEFAULT_MODEL_STOKES = 2

# Fixed sinker positions (models.c:1012-1015, 728-731)
_POSX = np.array([0.27, 0.6, 0.7, 0.2, 0.85, 0.4, 0.16, 0.55])
_POSY = np.array([0.63, 0.83, 0.33, 0.2, 0.65, 0.3, 0.84, 0.54])
_POSZ = np.array([0.50, 0.40, 0.30, 0.70, 0.65, 0.4, 0.8, 0.50])


class ModelContext:
    """Holds options + one-shot banner state for a single solve, mirroring the
    reference's static `been_here` variables (e.g. models.c:20-27)."""

    def __init__(self, opts, ndim, lame=False, log=print):
        self.opts = opts
        self.ndim = ndim
        self.lame = lame
        self.log = log
        self._printed = set()
        self.model = opts.get_int(
            "model", DEFAULT_MODEL_LAME if lame else DEFAULT_MODEL_STOKES)
        self._ptatin_centroids = None

    def once(self, key, lines):
        if key not in self._printed:
            for ln in lines:
                self.log(ln)
            self._printed.add(key)


def _fmt(x):
    return f"{x:1.4e}"


# --------------------------------------------------------------------------
# Stokes coefficient models. Each returns (eta, Fu, Fp) with
# eta: (n,), Fu: (n, ndim), Fp: (n,) for points x: (n, ndim).
# --------------------------------------------------------------------------

def _stokes_solcx(ctx, x):
    o = ctx.opts
    eta0 = o.get_real("eta0", 1.0)
    eta1 = o.get_real("eta1", 1.0)
    xc = o.get_real("solcx_xc", 0.5)
    nz = o.get_int("solcx_nz", 1)
    ctx.once("model", ["ModelType: StokesSolCx",
                       f"  params: eta0 {_fmt(eta0)}",
                       f"  params: eta1 {_fmt(eta1)}",
                       f"  params: xc   {_fmt(xc)}",
                       f"  params: nz   {nz}"])
    eta = np.where(x[:, 0] > xc, eta1, eta0)
    Fu = np.zeros_like(x)
    Fu[:, 1] = np.sin(nz * np.pi * x[:, 1]) * np.cos(np.pi * x[:, 0])
    return eta, Fu, np.zeros(len(x))


def _stokes_solcx3d(ctx, x):
    o = ctx.opts
    eta0 = o.get_real("eta0", 1.0)
    eta1 = o.get_real("eta1", 1.0)
    xc = o.get_real("solcx_xc", 0.5)
    nz = o.get_int("solcx_nz", 1)
    nz2 = 1
    ctx.once("model", ["ModelType: StokesSolCx3d",
                       f"  params: eta0 {_fmt(eta0)}",
                       f"  params: eta1 {_fmt(eta1)}",
                       f"  params: xc   {_fmt(xc)}",
                       f"  params: nz   {nz}",
                       f"  params: nz2  {nz2}"])
    eta = np.where(x[:, 0] > xc, eta1, eta0)
    Fu = np.zeros_like(x)
    Fu[:, 1] = (np.sin(nz * np.pi * x[:, 1]) * np.cos(np.pi * x[:, 0])
                * np.sin(nz2 * np.pi * x[:, 2]))
    return eta, Fu, np.zeros(len(x))


def _inside_spheres(x, centers, rad):
    """Boolean mask: point within distance rad of any center (strict <)."""
    d2 = ((x[:, None, :] - centers[None, :, :]) ** 2).sum(axis=2)
    return (d2 < rad * rad).any(axis=1)


def _sinker_common(x, inside, eta0, eta1, rho_in):
    eta = np.where(inside, eta1, eta0)
    rho = np.where(inside, rho_in, 1.0)
    Fu = np.zeros_like(x)
    Fu[:, 1] = -rho
    return eta, Fu, np.zeros(len(x))


def _stokes_three_sinker(ctx, x):
    o = ctx.opts
    eta0 = o.get_real("eta0", 1.0)
    eta1 = o.get_real("eta1", 1.0)
    rad = o.get_real("sinker_r", 0.1)
    ctx.once("model", ["ModelType: StokesThreeSinker",
                       f"  params: eta0 {_fmt(eta0)}",
                       f"  params: eta1 {_fmt(eta1)}",
                       f"  params: rad  {_fmt(rad)}"])
    if ctx.ndim == 2:
        centers = np.array([[0.27, 0.63], [0.6, 0.83], [0.7, 0.33]])
    else:
        centers = np.array([[0.27, 0.63, 0.5], [0.6, 0.83, 0.5],
                            [0.7, 0.33, 0.5]])
    inside = _inside_spheres(x, centers, rad)
    return _sinker_common(x, inside, eta0, eta1, 1.1)


def _stokes_x_sinker(ctx, x):
    o = ctx.opts
    eta0 = o.get_real("eta0", 1.0)
    eta1 = o.get_real("eta1", 1.0)
    rad = o.get_real("sinker_r", 0.05)
    n = o.get_int("sinker_n", 3)
    ctx.once("model", ["ModelType: StokesXSinker",
                       f"  params: eta0 {_fmt(eta0)}",
                       f"  params: eta1 {_fmt(eta1)}",
                       f"  params: num sinkers {n}",
                       f"  params: sinker radius {_fmt(rad)}"])
    if n > 8:
        raise ValueError("Too many sinkers")
    if rad > 0.05:
        raise ValueError("Sinker Radius too big")
    if ctx.ndim == 2:
        centers = np.stack([_POSX[:n], _POSY[:n]], axis=1)
    else:
        centers = np.stack([_POSX[:n], _POSY[:n], _POSZ[:n]], axis=1)
    inside = _inside_spheres(x, centers, rad)
    return _sinker_common(x, inside, eta0, eta1, 1.1)


def _stokes_one_sinker(ctx, x):
    o = ctx.opts
    eta0 = o.get_real("eta0", 1.0)
    eta1 = o.get_real("eta1", 1.0)
    rad = o.get_real("sinker_r", 0.25)
    cx = o.get_real("sinker_x", 0.5)
    cy = o.get_real("sinker_y", 0.5)
    lines = ["ModelType: StokesOneSinker",
             f"  params: eta0 {_fmt(eta0)}",
             f"  params: eta1 {_fmt(eta1)}",
             f"  params: x {_fmt(cx)}",
             f"  params: y {_fmt(cy)}"]
    if ctx.ndim == 3:
        cz = o.get_real("sinker_z", 0.5)
        lines.append(f"  params: z {_fmt(cz)}")
        center = np.array([[cx, cy, cz]])
    else:
        center = np.array([[cx, cy]])
    lines.append(f"  params: rad {_fmt(rad)}")
    ctx.once("model", lines)
    inside = _inside_spheres(x, center, rad)
    return _sinker_common(x, inside, eta0, eta1, 1.1)


def _generate_inclusion_origins(ctx, n, rmax, L, min_sep_wall, min_sep_region):
    """Rejection-sampled inclusion centers (models.c:1168-1264).

    Mirrors the reference's srand(0)/rand() sequence using glibc's rand(),
    via a local reimplementation of the glibc TYPE_3 additive generator, so
    inclusion positions match the reference bit-for-bit.
    """
    o = ctx.opts
    max_attempts = o.get_int("max_attempts", 50000)
    ctx.log("# GenerateInclusionOrigins:")
    ctx.log(f"#   nregions       {n}")
    ctx.log(f"#   radius         {_fmt(rmax)}")
    ctx.log(f"#   Lx,Ly,Lz       {_fmt(L[0])},{_fmt(L[1])},{_fmt(L[2])}")
    ctx.log(f"#   min_sep        {_fmt(min_sep_region / rmax)}"
            " (in terms of region radii)")
    ctx.log(f"#   min_wall sep   {_fmt(min_sep_wall / rmax)}"
            " (in terms of region radii)")

    rng = _GlibcRand(0)
    RAND_MAX = 2147483647
    pos = np.zeros((n, 3))
    loops = 0
    while True:
        loops += 1
        found = 0
        attempt = 0
        restart = False
        while found < n:
            if attempt == max_attempts:
                restart = True
                break
            p = np.array([rng.next() / RAND_MAX * L[0],
                          rng.next() / RAND_MAX * L[1],
                          rng.next() / RAND_MAX * L[2]])
            attempt += 1
            dw = min_sep_wall * rmax
            if (p - dw < 0).any() or (p + dw > L).any():
                continue
            if found and (np.linalg.norm(pos[:found] - p, axis=1)
                          < 2.0 * rmax + min_sep_region * rmax).any():
                continue
            pos[found] = p
            found += 1
        if not restart:
            break
    ctx.log(f"# GenerateInclusionOrigins: performed {loops} loops: made "
            f"{attempt} attempts and correctly defined {n} inclusions")
    return pos


class _GlibcRand:
    """glibc rand() (TYPE_3 additive feedback generator, 128-byte state).

    Reproduces the exact srand(seed)/rand() sequence the reference relies on
    for SinkerPtatin (models.c:1188, srand(0)).
    """

    def __init__(self, seed):
        if seed == 0:
            seed = 1
        r = [0] * 344
        r[0] = seed & 0xFFFFFFFF
        for i in range(1, 31):
            r[i] = (16807 * r[i - 1]) % 2147483647
            if r[i] < 0:
                r[i] += 2147483647
        for i in range(31, 34):
            r[i] = r[i - 31]
        for i in range(34, 344):
            r[i] = (r[i - 31] + r[i - 3]) & 0xFFFFFFFF
        self.r = r
        self.i = 344

    def next(self):
        r = self.r
        v = (r[self.i - 31] + r[self.i - 3]) & 0xFFFFFFFF
        r.append(v)
        self.i += 1
        return v >> 1


def _stokes_sinker_ptatin(ctx, x):
    o = ctx.opts
    eta0 = o.get_real("eta0", 1.0)
    eta1 = o.get_real("eta1", 1.1)
    rad = o.get_real("sinker_r", 0.05)
    n = o.get_int("sinker_n", 3)
    first = "model" not in ctx._printed
    ctx.once("model", ["ModelType: SinkerPtatin",
                       f"  params: eta0 {_fmt(eta0)}",
                       f"  params: eta1 {_fmt(eta1)}"])
    if first:
        ctx._ptatin_centroids = _generate_inclusion_origins(
            ctx, n, rad, np.array([1.0, 1.0, 1.0]), 1.5, 1.5)
    inside = _inside_spheres(x, ctx._ptatin_centroids[:, :ctx.ndim], rad)
    return _sinker_common(x, inside, eta0, eta1, 1.1)


def _stokes_pseudoice(ctx, x):
    o = ctx.opts
    eta0 = o.get_real("eta0", 1.0)
    eta1 = o.get_real("eta1", 10000.0)
    ctx.once("model", ["ModelType: PseudoIce",
                       f"  params: eta0 {_fmt(eta0)}",
                       f"  params: eta1 {_fmt(eta1)}"])
    size_x = o.get_real("size_x", 1.0)  # same hack as models.c:1465
    xrel = x[:, 0] / size_x
    eta = xrel * eta0 + (1 - xrel) * eta1
    Fu = np.zeros_like(x)
    Fu[:, 2] = 1.0
    return eta, Fu, np.zeros(len(x))


def _stokes_mms1(ctx, x):
    ctx.once("model", ["ModelType: StokesMMS1"])
    return np.ones(len(x)), np.zeros_like(x), np.zeros(len(x))


def mms1_solution(x, y):
    """Exact MMS1 fields (models.c:462-464): u=20xy^3, v=5(x^4-y^4),
    p=60x^2 y - 20y^3."""
    return (20.0 * x * y ** 3,
            5.0 * (x ** 4 - y ** 4),
            60.0 * x * x * y - 20.0 * y ** 3)


def stokes_coefficients(ctx, x):
    m = ctx.model
    if m == 0:
        return _stokes_solcx(ctx, x)
    if m == 1:
        return _stokes_three_sinker(ctx, x)
    if m == 2:
        return _stokes_x_sinker(ctx, x)
    if m == 5 and ctx.ndim == 3:
        return _stokes_solcx3d(ctx, x)
    if m == 6:
        return _stokes_one_sinker(ctx, x)
    if m == 7 and ctx.ndim == 3:
        return _stokes_sinker_ptatin(ctx, x)
    if m == 11 and ctx.ndim == 3:
        return _stokes_pseudoice(ctx, x)
    if m == 101 and ctx.ndim == 2:
        return _stokes_mms1(ctx, x)
    raise ValueError(f"Stokes Model {m} not implemented")


# --------------------------------------------------------------------------
# Lame coefficient models: return (mu, lam, Fu, Fp).
# --------------------------------------------------------------------------

def _lame_one_sinker(ctx, x):
    o = ctx.opts
    mu0 = o.get_real("mu0", 1.0)
    mu1 = o.get_real("mu1", 1.0)
    l0 = o.get_real("lambda0", 1.0)
    l1 = o.get_real("lambda1", 2.0)
    rad = o.get_real("sinker_r", 0.25)
    ctx.once("model", ["ModelType: LameOneSinker",
                       f"  params: mu0 {_fmt(mu0)}",
                       f"  params: mu1 {_fmt(mu1)}",
                       f"  params: lambda0 {_fmt(l0)}",
                       f"  params: lambda1 {_fmt(l1)}",
                       f"  params: rad {_fmt(rad)}"])
    center = np.full((1, ctx.ndim), 0.5)
    inside = _inside_spheres(x, center, rad)
    mu = np.where(inside, mu1, mu0)
    lam = np.where(inside, l1, l0)
    rho = np.where(inside, 2.0, 1.0)  # 2x density inside (models.c:698)
    Fu = np.zeros_like(x)
    Fu[:, 1] = -rho
    return mu, lam, Fu, np.zeros(len(x))


def _lame_x_sinker(ctx, x):
    o = ctx.opts
    mu0 = o.get_real("mu0", 1.0)
    mu1 = o.get_real("mu1", 1.0)
    l0 = o.get_real("lambda0", 1.0)
    l1 = o.get_real("lambda1", 1.0)
    rad = o.get_real("sinker_r", 0.05)
    n = o.get_int("sinker_n", 3)
    ctx.once("model", ["ModelType: LameXSinker",
                       f"  params: mu0 {_fmt(mu0)}",
                       f"  params: mu1 {_fmt(mu1)}",
                       f"  params: lambda0 {_fmt(l0)}",
                       f"  params: lambda1 {_fmt(l1)}",
                       f"  params: num sinkers {n}",
                       f"  params: sinker radius {_fmt(rad)}"])
    if n > 8:
        raise ValueError("Too many sinkers")
    if rad > 0.05:
        raise ValueError("Sinker Radius too big")
    if ctx.ndim == 2:
        centers = np.stack([_POSX[:n], _POSY[:n]], axis=1)
    else:
        centers = np.stack([_POSX[:n], _POSY[:n], _POSZ[:n]], axis=1)
    inside = _inside_spheres(x, centers, rad)
    mu = np.where(inside, mu1, mu0)
    lam = np.where(inside, l1, l0)
    rho = np.where(inside, 1.1, 1.0)
    Fu = np.zeros_like(x)
    Fu[:, 1] = -rho
    return mu, lam, Fu, np.zeros(len(x))


def _lame_homogeneous(ctx, x):
    o = ctx.opts
    mu0 = o.get_real("mu0", 1.0)
    l0 = o.get_real("lambda0", 1.0)
    ctx.once("model", ["ModelType: LameHomogeneous",
                       f"  params: mu0 {_fmt(mu0)}",
                       f"  params: lambda0 {_fmt(l0)}"])
    n = len(x)
    Fu = np.zeros_like(x)
    Fu[:, 1] = -1.0
    return np.full(n, mu0), np.full(n, l0), Fu, np.zeros(n)


def lame_coefficients(ctx, x):
    m = ctx.model
    if m == 2:
        return _lame_x_sinker(ctx, x)
    if m in (6, 8, 10, 12):
        return _lame_one_sinker(ctx, x)
    if m == 9:
        return _lame_homogeneous(ctx, x)
    raise ValueError(f"Elasticity Model {m} not implemented")


def evaluate_coefficients(ctx, x):
    """Evaluate model coefficients at points x: (n, ndim).

    Returns a (n, ncoeff) array with the reference's coefficient layout
    (femixedspace.c:1984-2001):
      Stokes: [eta, Fu0, Fu1, Fp (, Fu2)]       ncoeff = ndim + 2
      Lame:   [mu, Fu0, Fu1, Fp, lambda (, Fu2)] ncoeff = ndim + 3
    """
    if ctx.lame:
        mu, lam, Fu, Fp = lame_coefficients(ctx, x)
        cols = [mu, Fu[:, 0], Fu[:, 1], Fp, lam]
        if ctx.ndim == 3:
            cols.append(Fu[:, 2])
    else:
        eta, Fu, Fp = stokes_coefficients(ctx, x)
        cols = [eta, Fu[:, 0], Fu[:, 1], Fp]
        if ctx.ndim == 3:
            cols.append(Fu[:, 2])
    return np.stack(cols, axis=1)


def unpack_coefficients(ctx, c):
    """Invert evaluate_coefficients' layout: return dict with eta-or-(mu,
    lambda), Fu (n, ndim), Fp."""
    n = len(c)
    Fu = np.zeros((n, ctx.ndim))
    Fu[:, 0] = c[:, 1]
    Fu[:, 1] = c[:, 2]
    if ctx.lame:
        if ctx.ndim == 3:
            Fu[:, 2] = c[:, 5]
        return {"mu": c[:, 0], "lambda": c[:, 4], "Fu": Fu, "Fp": c[:, 3]}
    if ctx.ndim == 3:
        Fu[:, 2] = c[:, 4]
    return {"eta": c[:, 0], "Fu": Fu, "Fp": c[:, 3]}


# --------------------------------------------------------------------------
# Boundary conditions. Each builder returns (u_dof_indices, values) as numpy
# arrays, indices into the velocity dof block (ndim*node + component).
# --------------------------------------------------------------------------

def _face_nodes(mesh, dim, end):
    return mesh.u_face_nodes(dim, end)


def _solcx_bcs(ctx, mesh):
    ctx.once("bc", ["Boundary Conditions: SolCx"])
    free_slip = ctx.opts.get_bool("freesliphack", False)
    nd = mesh.ndim
    idx = []
    # normal components on min faces (x=0 -> u, y=0 -> v, z=0 -> w)
    for d in range(nd):
        idx.append(nd * _face_nodes(mesh, d, 0) + d)
    # x on x=max
    idx.append(nd * _face_nodes(mesh, 0, 1) + 0)
    # y on y=max only with -freesliphack
    if free_slip:
        idx.append(nd * _face_nodes(mesh, 1, 1) + 1)
    # z on z=max (3D)
    if nd == 3:
        idx.append(nd * _face_nodes(mesh, 2, 1) + 2)
    idx = np.concatenate(idx)
    return idx.astype(np.int64), np.zeros(len(idx))


def _fixed_base_bcs(ctx, mesh):
    ctx.once("bc", ["Boundary Conditions: FixedBase"])
    nd = mesh.ndim
    nodes = _face_nodes(mesh, 1, 0)  # y = 0 face
    idx = np.concatenate([nd * nodes + d for d in range(nd)])
    return idx.astype(np.int64), np.zeros(len(idx))


def _compression_bcs(ctx, mesh):
    ctx.once("bc", ["Boundary Conditions: Compression"])
    nd = mesh.ndim
    disp = 0.1
    idx, vals = [], []
    for end, sign in ((0, +1.0), (1, -1.0)):
        nodes = _face_nodes(mesh, 0, end)
        for d in range(nd):
            idx.append(nd * nodes + d)
            v = np.zeros(len(nodes))
            if d == 0:
                v[:] = sign * disp
            vals.append(v)
    return np.concatenate(idx).astype(np.int64), np.concatenate(vals)


def _compression2_bcs(ctx, mesh):
    ctx.once("bc", ["Boundary Conditions: Compression2"])
    nd = mesh.ndim
    disp = 0.1
    idx, vals = [], []
    for end, sign in ((0, +1.0), (1, -1.0)):  # +/- x displacement on x faces
        nodes = _face_nodes(mesh, 0, end)
        idx.append(nd * nodes + 0)
        vals.append(np.full(len(nodes), sign * disp))
    nodes = _face_nodes(mesh, 1, 0)           # free slip bottom
    idx.append(nd * nodes + 1)
    vals.append(np.zeros(len(nodes)))
    for end in (0, 1):                        # free slip back/front (z faces)
        nodes = _face_nodes(mesh, 2, end)
        idx.append(nd * nodes + 2)
        vals.append(np.zeros(len(nodes)))
    return np.concatenate(idx).astype(np.int64), np.concatenate(vals)


def _mms1_bcs(ctx, mesh):
    ctx.once("bc", ["Boundary Conditions: StokesMMS1"])
    nd = mesh.ndim
    idx, vals = [], []
    for d in range(2):
        for end in (0, 1):
            nodes = _face_nodes(mesh, d, end)
            c = mesh.u_coords[nodes]
            ux, uy, _ = mms1_solution(c[:, 0], c[:, 1])
            idx.append(nd * nodes + 0)
            vals.append(ux)
            idx.append(nd * nodes + 1)
            vals.append(uy)
    return np.concatenate(idx).astype(np.int64), np.concatenate(vals)


def create_bc_list(ctx, mesh):
    """Dispatch like models.c:610-648."""
    m = ctx.model
    if ctx.lame and m == 8:
        return _fixed_base_bcs(ctx, mesh)
    if ctx.lame and m in (9, 10):
        return _compression_bcs(ctx, mesh)
    if mesh.ndim == 3 and not ctx.lame and m == 11:
        return _fixed_base_bcs(ctx, mesh)
    if ctx.lame and mesh.ndim == 3 and m == 12:
        return _compression2_bcs(ctx, mesh)
    if not ctx.lame and mesh.ndim == 2 and m == 101:
        return _mms1_bcs(ctx, mesh)
    return _solcx_bcs(ctx, mesh)


def compute_reference_solution(ctx, mesh):
    """Nodal reference solution, or None (models.c:1630-1651)."""
    if ctx.lame or ctx.ndim != 2 or ctx.model != 101:
        return None
    x = np.zeros(mesh.ndof)
    cu = mesh.u_coords
    ux, uy, _ = mms1_solution(cu[:, 0], cu[:, 1])
    x[0:mesh.nu:2] = ux
    x[1:mesh.nu:2] = uy
    cp = mesh.p_coords
    _, _, p = mms1_solution(cp[:, 0], cp[:, 1])
    x[mesh.nu:] = p
    return x
