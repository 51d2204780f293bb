"""One file per coefficient model of the reference's models.c, each with
`coefficients(flags, x)` -> (eta (n,), Fu (n, ndim), Fp (n,)) at the points
x (n, ndim) and `dirichlet(flags, mesh)` -> (velocity dof indices, values).
A configuration names its model file by its "model_file" key."""
