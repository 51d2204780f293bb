"""gram_schmidt_ms: the Krylov loops' orthogonalisation per solve, in ms
(K7): the device spans `gram_schmidt`, from the masked window dots through
the index_copy_ of the new basis vector, in treeops.DeviceGCR.step and
DeviceFGMRES.arnoldi_post. Device marks from the traced pass
(benchmark/traced.py), mean per solve. Moves solve_s."""

from benchmark import traced


def read(run):
    return traced.reading(run, "gram_schmidt_ms")
