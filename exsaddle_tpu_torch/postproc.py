"""Post-processing: spectrum + field plots from dump files (a numpy copy of
exsaddle_tpu/postproc.py; nothing here runs on the device).

The equivalent of the reference's MATLAB/Octave tooling (octave_demo.m,
plotfield.m): load the framework's dumps (.npy/.npz in place of PETSc
binary), compute the eigenspectrum of the explicit preconditioned operator,
and plot Q2 velocity / Q1 pressure fields. Usage:

    python -m exsaddle_tpu_torch.postproc -mx 20 [-solution solution.npy]
        [-preconditioned_operator preconditioned_operator_out.npz]
        [-out spectrum.png fields.png]
"""

import numpy as np


def load_operator(name):
    """Load a dump_operator .npz (CSR) or dump_dense_operator .npz."""
    d = np.load(name)
    if "dense" in d:
        return d["dense"]
    import scipy.sparse as sp
    return sp.csr_matrix((d["data"], d["indices"], d["indptr"]),
                         shape=tuple(d["shape"])).toarray()


def spectrum(BA):
    """Sorted real spectrum split into positive/negative parts
    (octave_demo.m:15-22)."""
    e = np.linalg.eigvals(np.asarray(BA))
    es = np.sort(e.real)
    return {"pos": es[es > 0], "neg": np.abs(es[es < 0]),
            "max_imag": float(np.abs(e.imag).max()),
            "nonsymmetry": float(np.abs(BA - BA.T).max())}


def split_fields_2d(v, mx, my=None):
    """plotfield.m:1-30: split a 2D saddle vector into (ux, uy, p) grids.
    Returns arrays shaped (ny_q2, nx_q2), (ny_q2, nx_q2), (ny_q1, nx_q1)."""
    if my is None:
        my = mx
    nxq2, nyq2 = 2 * mx + 1, 2 * my + 1
    nq2 = nxq2 * nyq2
    nxq1, nyq1 = mx + 1, my + 1
    if len(v) != 2 * nq2 + nxq1 * nyq1:
        raise ValueError("Size error: v incompatible with my and mx")
    ux = v[0:2 * nq2:2].reshape(nyq2, nxq2)
    uy = v[1:2 * nq2:2].reshape(nyq2, nxq2)
    p = v[2 * nq2:].reshape(nyq1, nxq1)
    return ux, uy, p


def plot_fields_2d(v, mx, my=None, fname="fields.png"):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    ux, uy, p = split_fields_2d(np.asarray(v), mx, my)
    umag = np.hypot(ux, uy)
    fig, ax = plt.subplots(2, 2, figsize=(10, 10))
    for a, (f, t) in zip(ax.ravel(),
                         [(ux, "u_x"), (uy, "u_y"), (umag, "|u|"),
                          (p, "p")]):
        im = a.imshow(f, origin="lower")
        a.set_title(t)
        fig.colorbar(im, ax=a)
    fig.savefig(fname, dpi=100)
    plt.close(fig)
    return fname


def plot_spectrum(BA, fname="spectrum.png", nfew=40):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    s = spectrum(BA)
    fig, ax = plt.subplots(1, 2, figsize=(10, 4))
    ax[0].semilogy(s["pos"], "r+")
    ax[0].semilogy(s["neg"], "bo")
    ax[0].set_title("All eigenvalues")
    ax[1].semilogy(s["pos"][:nfew], "r+")
    ax[1].semilogy(s["neg"][:nfew], "bo")
    ax[1].set_title("A few eigenvalues")
    fig.savefig(fname, dpi=100)
    plt.close(fig)
    return fname, s


def main(argv=None):
    import sys
    from exsaddle_tpu_torch.options import Options
    opts = Options.from_args(sys.argv[1:] if argv is None else argv)
    mx = opts.get_int("mx", 20)
    my = opts.get_int("my", mx)
    sol = opts.get_string("solution", "solution.npy")
    pop = opts.get_string("preconditioned_operator", None)
    v = np.load(sol)
    print(f"loaded {sol}: n = {len(v)}")
    print("wrote", plot_fields_2d(v, mx, my))
    if pop:
        BA = load_operator(pop)
        fname, s = plot_spectrum(BA)
        print("wrote", fname)
        print(f"max|imag(e)| = {s['max_imag']:g}, "
              f"nonsymmetry = {s['nonsymmetry']:g}")


if __name__ == "__main__":
    main()
