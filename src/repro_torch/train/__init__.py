from repro_torch.train.runner import TrainConfig, TrainRunner, canary_stages, model_stage_names

__all__ = ["TrainConfig", "TrainRunner", "canary_stages", "model_stage_names"]
