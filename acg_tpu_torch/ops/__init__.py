"""Device sparse formats (:mod:`.spmv`) and the hand-written CUDA kernels
(:mod:`.kernels`, built by :mod:`._build` from ``csrc/``)."""
