from fei_tpu_torch.models.configs import ModelConfig, get_model_config, MODEL_CONFIGS

__all__ = ["ModelConfig", "get_model_config", "MODEL_CONFIGS"]
