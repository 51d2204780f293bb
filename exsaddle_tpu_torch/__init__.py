"""exsaddle_tpu_torch: the PyTorch/CUDA port of exsaddle_tpu for NVIDIA Hopper.

The port mirrors the JAX package's module names (mesh, assembly, models,
matfree, abf, treeops, driver, ...) so each counterpart is easy to find, and
is held against that package in the tests. It imports torch, numpy and scipy
only: the JAX package's __init__ imports jax, so nothing of it is importable
here and the numpy setup modules are carried as copies.

Device policy: every function that creates tensors takes an explicit
`device`; nothing probes for a GPU. Hand-written kernels (kernels/, sources
in csrc/) run on CUDA tensors; on CPU tensors the same wrappers run their
plain PyTorch versions.

Precision policy (set here, once, for the whole process): float32 matrix
products run in full float32, never TF32. Perturbing the operator and the
Gram-Schmidt dots at ~1e-3 (what TF32 or bf16 give) doubles the outer FGMRES
iteration count of the flagship solve (exsaddle_tpu/abf.py ABFConfig
matmul_precision notes), so speed bought that way is lost twice over.
Residuals for iterative refinement are computed in native float64.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
