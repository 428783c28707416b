"""Linear algebra: double-word arithmetic (``dd``), ELL and block-ELL
products (``sparse_ops``, ``bell``), the dense normal equations (``dense``),
the factor-once / solve-many mechanics every normal-equations backend shares
(``normal``: the dbound retry, the refined solve), the blocked Cholesky
(``chol``), Krylov refinement (``krylov``), and the builder (``cuda_build``)
and wrappers (``dd_cuda``, ``chol_cuda``) of the hand-written CUDA kernels
in ``csrc/``."""
