from fesom2_accelerate_tpu_torch.model.fct_ale import FctAleSolver, fct_ale_step

__all__ = ["FctAleSolver", "fct_ale_step"]
