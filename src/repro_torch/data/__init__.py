from repro_torch.data.pipeline import DataConfig, SyntheticLM, stub_frontend_batch

__all__ = ["DataConfig", "SyntheticLM", "stub_frontend_batch"]
