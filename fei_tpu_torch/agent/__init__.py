"""Agent runtime over the PyTorch engine (counterpart of fei_tpu/agent):
providers, conversation state, the assistant loop and the task executor.
The LLM transport defaults to the in-tree engine on the local GPU
(``torch_local``). MCP (``agent/mcp.py``) is a later slice."""

from fei_tpu_torch.agent.assistant import Assistant
from fei_tpu_torch.agent.conversation import ConversationManager
from fei_tpu_torch.agent.providers import (
    MockProvider,
    Provider,
    ProviderManager,
    ProviderResponse,
    ToolCall,
)
from fei_tpu_torch.agent.task_executor import TaskExecutor

__all__ = [
    "Assistant",
    "ConversationManager",
    "MockProvider",
    "Provider",
    "ProviderManager",
    "ProviderResponse",
    "TaskExecutor",
    "ToolCall",
]
