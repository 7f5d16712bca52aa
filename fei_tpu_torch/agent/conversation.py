"""Conversation state: message history and tool-result bookkeeping.

Parity with the reference's ConversationManager
(fei/core/assistant.py:215-303), plus what it lacks for unbounded task loops
(SURVEY.md §3.2): an optional token-budgeted trim that drops the oldest
non-system turns when the estimated context exceeds ``max_context_tokens``.

A copy of ``fei_tpu/agent/conversation.py`` that imports only the port.
"""

from __future__ import annotations

from typing import Any

from fei_tpu_torch.agent.providers import ToolCall


def _estimate_tokens(text: str) -> int:
    return max(1, int(len(text.split()) * 1.3))


class ConversationManager:
    def __init__(self, max_context_tokens: int | None = None):
        self.messages: list[dict] = []
        self.max_context_tokens = max_context_tokens

    def add_user_message(self, content: str) -> None:
        self.messages.append({"role": "user", "content": content})
        self._trim()

    def add_assistant_message(
        self, content: str, tool_calls: list[ToolCall] | None = None
    ) -> None:
        msg: dict[str, Any] = {"role": "assistant", "content": content}
        if tool_calls:
            msg["tool_calls"] = [
                {"id": c.id, "name": c.name, "arguments": c.arguments}
                for c in tool_calls
            ]
        self.messages.append(msg)
        self._trim()

    def add_tool_results(self, results: list[tuple[ToolCall, Any]]) -> None:
        for call, result in results:
            self.messages.append(
                {
                    "role": "tool",
                    "tool_call_id": call.id,
                    "name": call.name,
                    "content": _stringify(result),
                }
            )
        self._trim()

    def last_assistant_message(self) -> str | None:
        for msg in reversed(self.messages):
            if msg["role"] == "assistant":
                return msg["content"]
        return None

    def last_tool_outputs(self, n: int = 5) -> list[str]:
        """The most recent tool-result payloads (newest last) — the
        reference salvages empty model responses from these
        (fei/core/task_executor.py:111-155)."""
        out = [m["content"] for m in self.messages if m["role"] == "tool"]
        return out[-n:]

    def clear(self) -> None:
        self.messages.clear()

    def token_estimate(self) -> int:
        return sum(_estimate_tokens(str(m.get("content", ""))) for m in self.messages)

    def _trim(self) -> None:
        if self.max_context_tokens is None:
            return
        while len(self.messages) > 2 and self.token_estimate() > self.max_context_tokens:
            # drop the oldest turn, but never orphan tool results: when an
            # assistant message carrying tool_calls goes, ALL consecutive
            # tool messages that follow it go too
            dropped = self.messages.pop(0)
            if dropped.get("tool_calls"):
                while self.messages and self.messages[0]["role"] == "tool":
                    self.messages.pop(0)


def _stringify(result: Any) -> str:
    if isinstance(result, str):
        return result
    import json

    try:
        return json.dumps(result, default=str)
    except (TypeError, ValueError):
        return str(result)
