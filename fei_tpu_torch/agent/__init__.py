"""Agent runtime over the PyTorch engine. Only the providers are ported in
this slice; the assistant loop, conversation state and task executor are
roadmap module C6."""

from fei_tpu_torch.agent.providers import (
    MockProvider,
    Provider,
    ProviderResponse,
    ToolCall,
    TorchLocalProvider,
)

__all__ = [
    "MockProvider",
    "Provider",
    "ProviderResponse",
    "ToolCall",
    "TorchLocalProvider",
]
