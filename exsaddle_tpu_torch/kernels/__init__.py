"""Hand-written CUDA kernels of the port (sources in ../csrc/), each with a
plain PyTorch version beside it and a launch count.

  a00        -- K1, the fused velocity-block apply (replaces
                exsaddle_tpu/pallas_apply.py:make_pallas_mult_u), with the
                Dirichlet keep in its loads and, on the fine level, the
                mask terms and the Chebyshev update in its store
  stencil    -- K4, the 3^ndim-point block stencil apply of the deep MG
                levels (replaces exsaddle_tpu/abf.py:stencil_accum, an XLA
                fusion on the TPU), with the levels' Chebyshev update and
                residual as its epilogues
  mp         -- K3, the p-block's Mpscaled apply (replaces
                exsaddle_tpu/abf.py:mp_apply, an XLA fusion on the TPU),
                one launch per apply of its 3^ndim-point node stencil
                (built at setup), with the single-device p-block's
                Chebyshev update in its store
  transfer   -- K5, the MG transfers between the fine parity layout and
                the coarse grid and between the node grids of the deep
                levels, one launch each, with the V-cycle's correction add
                and fine residual fused, and each restriction into a
                smoothed level with that level's first Chebyshev step
                (replaces exsaddle_tpu/abf.py: prolong_parity,
                restrict_parity, prolong_grid, restrict_grid, XLA fusions
                on the TPU)
  cheb       -- K6, the Chebyshev smoother's vector update with a Jacobi
                preconditioner, one pass per step (replaces the loop body
                of exsaddle_tpu/treeops.py:cheb_smooth, an XLA fusion),
                and its masked forms for the cart path's fine level
  gram_schmidt -- K7, classical Gram-Schmidt of a Krylov step against the
                live rows of its window (the live count read on the
                device), GCR's two combinations in one pass (replaces
                exsaddle_tpu/treeops.py:buf_dots and buf_comb, XLA fusions
                on the TPU)
  krylov_ctl -- the Krylov control kernels: the scalar tails of the GCR,
                FGMRES and refinement loop bodies, run inside the solve's
                CUDA graph (the JAX package compiles them into its
                lax.while_loops)
"""
