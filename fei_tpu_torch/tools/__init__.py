"""Tool layer: registry, JSON-schema definitions, and implementations.

Capability parity with the reference's fei/tools package (SURVEY.md §2.1):
registry.py (schema validation + dispatch), definitions.py (15 tool
declarations), code.py (file/search/edit/shell machinery), handlers.py
(definition→impl wiring), repomap.py (repository mapper).

A copy of ``fei_tpu/tools/__init__.py`` that imports only the port.
"""

from fei_tpu_torch.tools.registry import Tool, ToolRegistry
from fei_tpu_torch.tools.definitions import TOOL_DEFINITIONS
from fei_tpu_torch.tools.handlers import create_code_tools

__all__ = ["Tool", "ToolRegistry", "TOOL_DEFINITIONS", "create_code_tools"]
