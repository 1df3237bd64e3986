"""cgbench: the benchmark of the PyTorch/CUDA port (``acg_tpu_torch``).

One command runs one cell of ``BENCHMARK.json`` once::

    python3 -m cgbench --workload NAME --seed N --seconds S --trace 0|1

Everything a cell is made of is a data file or a reader found by name:
``configs/<config>.json`` (the operator and its deployment),
``workloads/<traffic>.json`` (the solves a window makes),
``checks/<cell>.json`` (the numbers compared with the plain reference and
their limits) and ``metrics/<metric>.py`` (one reader per metric).  The
yardstick is frozen here: the input generator and the plain reference
(:mod:`cgbench.reference`), the byte counts (:mod:`cgbench.counts`) and
the reduction of the device trace (:mod:`cgbench.trace`).  Of the
program the benchmark takes only the solver under test
(:mod:`cgbench.program`) and the names of its kernels.
"""
