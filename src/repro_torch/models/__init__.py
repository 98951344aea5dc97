from repro_torch.models.model import (build_model, decode_state_specs,
                                      input_specs, params_specs,
                                      prefill_batch_specs, train_batch_specs)
from repro_torch.models.transformer import LMModel, compute_params

__all__ = ["LMModel", "build_model", "compute_params", "input_specs",
           "params_specs", "train_batch_specs", "prefill_batch_specs",
           "decode_state_specs"]
