"""Hand-written CUDA kernels of the port (sources in ../csrc/), each with a
plain PyTorch version beside it and a launch count.

  a00 -- K1, the fused velocity-block apply (replaces
         exsaddle_tpu/pallas_apply.py:make_pallas_mult_u)
"""
