from acg_tpu_torch.solvers.stats import SolverStats, StoppingCriteria  # noqa: F401
from acg_tpu_torch.solvers.cg import CGResult, TorchCGSolver  # noqa: F401
