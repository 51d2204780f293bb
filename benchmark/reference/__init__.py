"""The benchmark's plain float64 reference: the Q2-Q1 saddle system worked
out again from the configuration (fem.py) and one model file per coefficient
model (models/). Imports neither jax, exsaddle_tpu nor exsaddle_tpu_torch."""
