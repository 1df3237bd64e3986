"""acg-tpu-torch: the PyTorch/CUDA port of acg-tpu.

A second package beside ``acg_tpu`` (the JAX reference, which it never
imports): the same layout and names, in PyTorch idiom, with every TPU
kernel of the ported path rewritten by hand for Hopper (``csrc/``).

  L0  acg_tpu_torch.errors, .io.mtxfile, .fmtspec, ._device,
      ._native (the C++ host core)                            (foundation)
  L4  acg_tpu_torch.matrix, .ops.spmv, .ops.kernels           (sparse linalg)
  L5  acg_tpu_torch.solvers                                   (CG solvers)
  L7  acg_tpu_torch.cli, .tools                               (drivers)

Every entry point runs on the CUDA card unless the caller asks for the
CPU (``device="cpu"``, ``--device cpu``); with no card it raises.
"""

__version__ = "0.1.0"

from acg_tpu_torch.errors import AcgError, ErrorCode  # noqa: F401
from acg_tpu_torch.solvers import (SolverStats, StoppingCriteria,  # noqa: F401
                                   TorchCGSolver)
