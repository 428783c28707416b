"""Linear algebra of the slice: double-word arithmetic (``dd``), its CUDA
kernels (``dd_cuda``, ``csrc/dd_matvec.cu``), the dense normal equations
(``dense``) and Krylov refinement (``krylov``)."""
