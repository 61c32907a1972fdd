from fesom2_accelerate_tpu_torch.model.fct_ale import FctAleSolver, fct_ale_step
from fesom2_accelerate_tpu_torch.model.stress2rhs import Stress2RhsSolver

__all__ = ["FctAleSolver", "Stress2RhsSolver", "fct_ale_step"]
