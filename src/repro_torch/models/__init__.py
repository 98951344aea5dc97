from repro_torch.models.model import build_model
from repro_torch.models.transformer import LMModel, compute_params

__all__ = ["LMModel", "build_model", "compute_params"]
