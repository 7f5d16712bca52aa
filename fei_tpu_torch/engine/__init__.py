from fei_tpu_torch.engine.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from fei_tpu_torch.engine.engine import (
    GenerationConfig,
    GenerationResult,
    InferenceEngine,
)

__all__ = [
    "GenerationConfig",
    "GenerationResult",
    "InferenceEngine",
    "latest_step",
    "restore_checkpoint",
    "save_checkpoint",
]
