"""Diagnostics and output, byte-matching the reference's formats (a numpy
copy of exsaddle_tpu/io.py).

Capability parity with exSaddle_io.c: SaddleReportSolutionDiagnostics
(per-component solution norms, exSaddle_io.c:7-58), solution/operator dumps
(numpy .npy/.npz in place of PETSc binary), and VTK structured-grid output
(ViewFields, exSaddle_io.c:129-177). Vectors arrive as numpy arrays or
tensors on any device; they are written from host numpy."""

import os

import numpy as np
import torch


def _host(x):
    """A tensor (any device) or array as a numpy array."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def report_solution_diagnostics(mesh, X, log=print):
    """-diagnostics output (exSaddle_io.c:7-58), exact PETSc formats.
    X: numpy array (ndof,)."""
    nd = mesh.ndim
    Xu = np.asarray(X[: mesh.nu]).reshape(-1, nd)
    Xp = np.asarray(X[mesh.nu:])

    def f(v):
        return f"{v:+1.6e}"

    n1 = np.abs(Xu).sum(axis=0)
    n2 = np.sqrt((Xu ** 2).sum(axis=0))
    ninf = np.abs(Xu).max(axis=0)
    vmin = Xu.min(axis=0)
    vmax = Xu.max(axis=0)
    if nd == 2:
        log(f"|u,v|_1   {f(n1[0])} , {f(n1[1])} ")
        log(f"|u,v|_2   {f(n2[0])} , {f(n2[1])} ")
        log(f"|u,v|_inf {f(ninf[0])} , {f(ninf[1])} ")
        log(f"|u,v|_min {f(vmin[0])} , {f(vmin[1])} ")
        log(f"|u,v|_max {f(vmax[0])} , {f(vmax[1])} ")
    else:
        log(f"|u,v,w|_1   {f(n1[0])} , {f(n1[1])} , {f(n1[2])}")
        log(f"|u,v,w|_2   {f(n2[0])} , {f(n2[1])} , {f(n2[2])}")
        log(f"|u,v,w|_inf {f(ninf[0])} , {f(ninf[1])} , {f(ninf[2])}")
        log(f"|u,v,w|_min {f(vmin[0])} , {f(vmin[1])} , {f(vmin[2])}")
        log(f"|u,v,w|_max {f(vmax[0])} , {f(vmax[1])} , {f(vmax[2])}")
    log(f"|p|_1          {f(np.abs(Xp).sum())}")
    log(f"|p|_2          {f(np.sqrt((Xp ** 2).sum()))}")
    log(f"|p|_inf        {f(np.abs(Xp).max())}")
    log(f"|p|_min        {f(Xp.min())}")
    log(f"|p|_max        {f(Xp.max())}")


def dump_solution(X, name, log=print):
    """-dump_solution (numpy format in place of PETSc binary)."""
    log(f"Dumping solution vector to {name}.")
    np.save(name, _host(X))
    log(f"Finished dumping vector to {name}.")


def dump_operator(A_csr, name, log=print):
    """-dump_operator: CSR arrays in an .npz."""
    log(f"Dumping operator to {name}. This could be very slow!")
    np.savez(name, data=A_csr.data, indices=A_csr.indices,
             indptr=A_csr.indptr, shape=A_csr.shape)
    log(f"Finished dumping operator to {name}.")


def _vts_scalar_block(name, values):
    vals = " ".join(f"{v:.6e}" for v in values)
    return (f'        <DataArray type="Float64" Name="{name}" '
            f'format="ascii">\n          {vals}\n        </DataArray>\n')


def _extent_str(nn, ndim, lo=None):
    lo = lo or (0,) * ndim
    hi = [lo[d] + nn[d] - 1 for d in range(ndim)]
    parts = [f"{lo[d]} {hi[d]}" for d in range(ndim)]
    if ndim == 2:
        parts.append("0 0")
    return " ".join(parts)


def write_vts(fname, nn, coords, fields, origin=None, whole_nn=None):
    """Minimal VTK XML StructuredGrid writer (ViewFields equivalent).

    nn: node counts per dim; coords: (nnodes, ndim); fields: {name: (nnodes,)}
    origin/whole_nn: node offset and global node counts when this file is
    one piece of a .pvts set (DAView3DPVTS pieces, ex42mod.c:1033-1337).
    """
    ndim = len(nn)
    ext = _extent_str(nn, ndim, origin)
    wext = _extent_str(whole_nn, ndim) if whole_nn is not None else ext
    with open(fname, "w") as fp:
        fp.write('<?xml version="1.0"?>\n')
        fp.write('<VTKFile type="StructuredGrid" version="0.1" '
                 'byte_order="LittleEndian">\n')
        fp.write(f'  <StructuredGrid WholeExtent="{wext}">\n')
        fp.write(f'    <Piece Extent="{ext}">\n')
        fp.write('      <Points>\n')
        pts = np.zeros((len(coords), 3))
        pts[:, :ndim] = coords
        flat = " ".join(f"{v:.6e}" for v in pts.ravel())
        fp.write('        <DataArray type="Float64" '
                 'NumberOfComponents="3" format="ascii">\n')
        fp.write(f"          {flat}\n        </DataArray>\n")
        fp.write('      </Points>\n')
        fp.write('      <PointData>\n')
        for name, vals in fields.items():
            fp.write(_vts_scalar_block(name, _host(vals)))
        fp.write('      </PointData>\n')
        fp.write('    </Piece>\n  </StructuredGrid>\n</VTKFile>\n')


def view_fields(mesh, X, tag="", log=print):
    """-view_fields: u/v(/w) on the Q2 grid, p on the Q1 grid
    (exSaddle_io.c:129-177)."""
    nd = mesh.ndim
    X = _host(X)
    Xu = X[: mesh.nu].reshape(-1, nd)
    fields = {"u": Xu[:, 0], "v": Xu[:, 1]}
    if nd == 3:
        fields["w"] = Xu[:, 2]
    name = f"{tag}uv.vts" if nd == 2 else f"{tag}uvw.vts"
    write_vts(name, mesh.nn_u, mesh.u_coords, fields)
    write_vts(f"{tag}p.vts", mesh.nn_p, mesh.p_coords, {"p": X[mesh.nu:]})


def _unit_coords(grids):
    """(nnodes, nd) coordinates of the tensor grid of 1D `grids`, x
    fastest."""
    if len(grids) == 3:
        kk, jj, ii = np.meshgrid(grids[2], grids[1], grids[0], indexing="ij")
        return np.stack([ii.ravel(), jj.ravel(), kk.ravel()], axis=1)
    jj, ii = np.meshgrid(grids[1], grids[0], indexing="ij")
    return np.stack([ii.ravel(), jj.ravel()], axis=1)


def write_vts_interleaved(fname, nn, X, names, log=print):
    """VTK output of an interleaved multi-dof nodal vector (the ex42
    DAView3DPVTS equivalent for serial runs, ex42mod.c:1033-1337)."""
    ndof = len(names)
    X = _host(X)
    coords = _unit_coords([np.arange(n) / max(n - 1, 1) for n in nn])
    fields = {nm: X[c::ndof] for c, nm in enumerate(names)}
    write_vts(fname, nn, coords, fields)
    log(f"Wrote {fname}")


def write_pvts_interleaved(base, nn, X, names, nranks=1, log=print):
    """Parallel VTK output: a .pvts master + one .vts piece per (virtual)
    rank, slab-decomposed along the slowest axis with the shared interface
    plane in both neighbors -- the ex42 DAView3DPVTS multi-piece writer
    (ex42mod.c:1033-1337, which hand-rolls exactly this file pair per
    MPI rank).

    base: output name without extension; X: interleaved (nnodes*ndof,)."""
    ndof = len(names)
    nd = len(nn)
    grids = [np.arange(n) / max(n - 1, 1) for n in nn]
    nz = nn[-1]
    nranks = max(1, min(nranks, nz - 1))
    # slab plane ranges [z0, z1] inclusive, interface planes shared
    cuts = [round(r * (nz - 1) / nranks) for r in range(nranks + 1)]
    gshape = tuple(reversed(nn))          # (z, y, x)
    Xg = _host(X).reshape(gshape + (ndof,))
    pieces = []
    for r in range(nranks):
        z0, z1 = cuts[r], cuts[r + 1]
        loc_nn = nn[:-1] + (z1 - z0 + 1,)
        coords = _unit_coords(grids[:-1] + [grids[-1][z0:z1 + 1]])
        flat = Xg[z0:z1 + 1].reshape(-1, ndof)
        fields = {nm: flat[:, c] for c, nm in enumerate(names)}
        piece = f"{base}-{r:04d}.vts"
        origin = (0,) * (nd - 1) + (z0,)
        write_vts(piece, loc_nn, coords, fields, origin=origin,
                  whole_nn=nn)
        pieces.append((piece, _extent_str(loc_nn, nd, origin)))
    wext = _extent_str(nn, nd)
    master = f"{base}.pvts"
    with open(master, "w") as fp:
        fp.write('<?xml version="1.0"?>\n')
        fp.write('<VTKFile type="PStructuredGrid" version="0.1" '
                 'byte_order="LittleEndian">\n')
        fp.write(f'  <PStructuredGrid WholeExtent="{wext}" '
                 'GhostLevel="0">\n')
        fp.write('    <PPoints>\n      <PDataArray type="Float64" '
                 'NumberOfComponents="3"/>\n    </PPoints>\n')
        fp.write('    <PPointData>\n')
        for nm in names:
            fp.write(f'      <PDataArray type="Float64" Name="{nm}"/>\n')
        fp.write('    </PPointData>\n')
        for piece, ext in pieces:
            fp.write(f'    <Piece Extent="{ext}" '
                     f'Source="{os.path.basename(piece)}"/>\n')
        fp.write('  </PStructuredGrid>\n</VTKFile>\n')
    log(f"Wrote {master} ({nranks} piece(s))")


def dump_dense_operator(apply_fn, n, name, device, log=print):
    """Explicit dense operator by applying to identity columns on `device`
    -- the PCComputeOperator / KSPComputeOperator path
    (exSaddle_io.c:91-126, 'could be very slow')."""
    log(f"Dumping operator to {name}. This could be very slow!")
    cols = []
    for j in range(n):
        e = torch.zeros(n, dtype=torch.float64, device=device)
        e[j] = 1.0
        cols.append(_host(apply_fn(e)))
    M = np.stack(cols, axis=1)
    np.savez(name, dense=M)
    log(f"Finished dumping operator to {name}.")
    return M
