from fei_tpu_torch.engine.engine import (
    GenerationConfig,
    GenerationResult,
    InferenceEngine,
)

__all__ = ["GenerationConfig", "GenerationResult", "InferenceEngine"]
