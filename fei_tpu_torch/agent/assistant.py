"""The agent loop: conversation → provider → tool execution → continuation.

Parity with the reference's Assistant (fei/core/assistant.py:320-673): one
user turn triggers a provider completion; if it contains tool calls they are
executed through the ToolRegistry and the results are sent back for a
continuation round, up to ``max_tool_rounds`` (the reference hardcodes a
single continuation; agent tasks routinely need more, so rounds are bounded
but configurable). Tool execution runs in a thread pool so an event loop
driving a UI stays responsive (reference assistant.py:524-530 pattern).

A copy of ``fei_tpu/agent/assistant.py`` that imports only the port.
"""

from __future__ import annotations

import asyncio
from typing import Any, Callable

from fei_tpu_torch.agent.conversation import ConversationManager
from fei_tpu_torch.agent.providers import Provider, ProviderManager, ProviderResponse, ToolCall
from fei_tpu_torch.utils.errors import ToolError
from fei_tpu_torch.utils.logging import get_logger
from fei_tpu_torch.utils.metrics import METRICS

log = get_logger("agent.assistant")

DEFAULT_SYSTEM_PROMPT = (
    "You are fei, a capable software engineering assistant running on a local "
    "GPU. Use the available tools to inspect and modify the user's "
    "code when needed; answer directly when a tool is unnecessary."
)


class ToolManager:
    """Formats registry schemas per provider and executes calls off-loop."""

    def __init__(self, registry=None):
        self.registry = registry

    def get_tools(self, format: str = "anthropic") -> list[dict]:
        if self.registry is None:
            return []
        return self.registry.get_schemas(format)

    def execute_tool(self, call: ToolCall) -> Any:
        if self.registry is None:
            return {"error": "no tool registry configured"}
        try:
            return self.registry.execute_tool(call.name, call.arguments)
        except ToolError as exc:
            return {"error": str(exc)}

    async def execute_tool_async(self, call: ToolCall) -> Any:
        """Dispatch on the registry's bounded pool (ToolRegistry owns the
        executor); ToolErrors become error payloads for the model."""
        if self.registry is None:
            return {"error": "no tool registry configured"}
        try:
            return await self.registry.execute_tool_async(call.name, call.arguments)
        except ToolError as exc:
            return {"error": str(exc)}


class Assistant:
    def __init__(
        self,
        provider: str | Provider | None = None,
        model: str | None = None,
        api_key: str | None = None,
        tool_registry=None,
        system_prompt: str | None = None,
        max_tool_rounds: int = 8,
        max_tokens: int = 4000,
        max_context_tokens: int | None = None,
        engine=None,
        on_text: Callable[[str], None] | None = None,
    ):
        if isinstance(provider, Provider):
            self.provider_manager = ProviderManager()
            self.provider_manager.set_provider(provider)
        else:
            self.provider_manager = ProviderManager(
                provider, model, api_key, engine=engine
            )
        self.tool_manager = ToolManager(tool_registry)
        self.conversation = ConversationManager(max_context_tokens)
        self.system_prompt = system_prompt or DEFAULT_SYSTEM_PROMPT
        self.max_tool_rounds = max_tool_rounds
        self.max_tokens = max_tokens
        self.on_text = on_text  # streaming callback (UI token sink)
        # per-turn token accounting, summed across tool rounds by chat()
        self.last_usage: dict = {"prompt_tokens": 0, "completion_tokens": 0}

    @property
    def provider(self) -> Provider:
        return self.provider_manager.get_provider()

    # -- core loop -----------------------------------------------------------

    async def chat(self, message: str, system_prompt: str | None = None) -> str:
        """One user turn: provider rounds until no tool calls remain."""
        self.conversation.add_user_message(message)
        system = system_prompt or self.system_prompt
        tools = self.tool_manager.get_tools()
        # identify pre-existing tool results by call id (counts break when
        # _trim prunes old tool messages mid-turn)
        seen_call_ids = {
            m.get("tool_call_id")
            for m in self.conversation.messages
            if m["role"] == "tool"
        }
        final_text: list[str] = []
        self.last_usage = {"prompt_tokens": 0, "completion_tokens": 0}
        for round_no in range(self.max_tool_rounds + 1):
            resp = await self._complete(system, tools)
            for k, v in (resp.usage or {}).items():
                self.last_usage[k] = self.last_usage.get(k, 0) + int(v)
                if k in ("prompt_tokens", "completion_tokens"):
                    METRICS.incr(f"agent.{k}", int(v))
            if resp.content:
                final_text.append(resp.content)
            self.conversation.add_assistant_message(resp.content, resp.tool_calls)
            if not resp.tool_calls:
                break
            if round_no == self.max_tool_rounds:
                log.warning("tool-round limit (%d) reached", self.max_tool_rounds)
                break
            results = []
            for call in resp.tool_calls:
                METRICS.incr("agent.tool_calls")
                result = await self.tool_manager.execute_tool_async(call)
                results.append((call, result))
            self.conversation.add_tool_results(results)
        text = "\n".join(t for t in final_text if t).strip()
        if not text:
            # salvage: surface the newest tool output — but only one produced
            # during THIS turn, never stale output from an earlier turn
            fresh = [
                m["content"]
                for m in self.conversation.messages
                if m["role"] == "tool" and m.get("tool_call_id") not in seen_call_ids
            ]
            if fresh:
                text = fresh[-1]
        return text

    def chat_sync(self, message: str, system_prompt: str | None = None) -> str:
        return asyncio.run(self.chat(message, system_prompt))

    async def _complete(self, system: str, tools: list[dict]) -> ProviderResponse:
        loop = asyncio.get_running_loop()
        with METRICS.span("agent.completion"):
            if self.on_text is not None:
                return await loop.run_in_executor(None, self._stream_once, system, tools)
            return await loop.run_in_executor(
                None,
                lambda: self.provider.complete(
                    self.conversation.messages, system, tools, self.max_tokens
                ),
            )

    def _stream_once(self, system: str, tools: list[dict]) -> ProviderResponse:
        gen = self.provider.stream(
            self.conversation.messages, system, tools, self.max_tokens
        )
        while True:
            try:
                delta = next(gen)
                if delta:
                    self.on_text(delta)
            except StopIteration as fin:
                return fin.value

    def reset(self) -> None:
        self.conversation.clear()
