"""LLM providers over the PyTorch engine (counterpart of
fei_tpu/agent/providers.py).

The provider contract is the JAX package's: (messages, system, tools) →
(text, tool_calls). Implementations here:

- ``TorchLocalProvider`` — the counterpart of ``JaxLocalProvider``: an
  ``InferenceEngine`` decoding on the local GPU; with ``[torch_local]
  paged = true`` the paged engine, whose scheduler batches concurrent
  requests. Tool calls are emitted as
  ``<tool_call>{json}</tool_call>`` blocks and parsed after generation
  (``[torch_local] constrain_tools = false``). Grammar-enforced tool calls
  (fei_tpu/engine/grammar.py) are not ported yet: with tools and
  ``constrain_tools`` on (the default), ``stream`` raises ``ProviderError``.
- ``MockProvider`` — scripted responses for hermetic tests.
"""

from __future__ import annotations

import json
import re
import time
import uuid
from dataclasses import dataclass, field
from typing import Sequence

from fei_tpu_torch.utils.config import get_config
from fei_tpu_torch.utils.errors import ProviderError
from fei_tpu_torch.utils.logging import get_logger
from fei_tpu_torch.utils.metrics import METRICS

log = get_logger("agent.providers")

DEFAULT_MODELS = {"torch_local": "llama3-1b"}


@dataclass
class ToolCall:
    id: str
    name: str
    arguments: dict


@dataclass
class ProviderResponse:
    content: str
    tool_calls: list[ToolCall] = field(default_factory=list)
    stop_reason: str = "stop"
    usage: dict = field(default_factory=dict)


class Provider:
    """Abstract transport: complete a conversation, possibly with tools."""

    name = "abstract"

    def complete(
        self,
        messages: list[dict],
        system: str | None = None,
        tools: list[dict] | None = None,
        max_tokens: int = 4000,
    ) -> ProviderResponse:
        raise NotImplementedError

    def stream(
        self,
        messages: list[dict],
        system: str | None = None,
        tools: list[dict] | None = None,
        max_tokens: int = 4000,
    ):
        """Yield text deltas, then return the final ProviderResponse via
        StopIteration.value. Default: no streaming, one chunk."""
        resp = self.complete(messages, system, tools, max_tokens)
        if resp.content:
            yield resp.content
        return resp


_TOOL_CALL_RX = re.compile(r"<tool_call>\s*(\{.*?\})\s*</tool_call>", re.DOTALL)
_OPEN_TAG = "<tool_call>"
_CLOSE_TAG = "</tool_call>"


def stream_visible(text: str, open_tag: str = _OPEN_TAG) -> str:
    """The portion of a partially-decoded response that is safe to show:
    completed tool-call blocks are removed, an unfinished block or a
    trailing partial ``open_tag`` is held back. Monotonic in ``text``
    growth, so a streaming UI can emit deltas of it."""
    out: list[str] = []
    pos = 0
    while True:
        i = text.find(open_tag, pos)
        if i < 0:
            rest = text[pos:]
            for k in range(min(len(open_tag) - 1, len(rest)), 0, -1):
                if rest.endswith(open_tag[:k]):
                    rest = rest[:-k]
                    break
            out.append(rest)
            break
        out.append(text[pos:i])
        j = text.find(_CLOSE_TAG, i)
        if j < 0:
            break  # block still streaming in: hold everything after the tag
        pos = j + len(_CLOSE_TAG)
    return "".join(out)


def extract_tool_calls(
    text: str, open_tag: str = _OPEN_TAG
) -> tuple[str, list[ToolCall]]:
    """Parse ``<tool_call>{...}</tool_call>`` blocks out of model text;
    the close tag is always ``</tool_call>``."""
    calls: list[ToolCall] = []
    rx = (
        _TOOL_CALL_RX
        if open_tag == _OPEN_TAG
        else re.compile(
            re.escape(open_tag) + r"\s*(\{.*?\})\s*" + re.escape(_CLOSE_TAG),
            re.DOTALL,
        )
    )

    def _strip(m: re.Match) -> str:
        try:
            obj = json.loads(m.group(1))
        except json.JSONDecodeError:
            log.warning("malformed tool call ignored: %s", m.group(1)[:200])
            return ""
        name = obj.get("name")
        if not name:
            return ""
        calls.append(
            ToolCall(
                id=f"call_{uuid.uuid4().hex[:12]}",
                name=str(name),
                arguments=obj.get("arguments", obj.get("input", {})) or {},
            )
        )
        return ""

    cleaned = rx.sub(_strip, text).strip()
    return cleaned, calls


def render_tool_prompt(tools: list[dict], open_tag: str = _OPEN_TAG) -> str:
    """System-prompt section teaching the tool-call emission protocol."""
    lines = [
        "You can call tools. To call one, emit exactly:",
        f'{open_tag}{{"name": "<tool name>", "arguments": {{...}}}}'
        f"{_CLOSE_TAG}",
        "Tool results arrive in the next turn. Available tools:",
    ]
    for t in tools:
        schema = t.get("input_schema", t.get("parameters", {}))
        props = ", ".join(schema.get("properties", {}).keys()) or "none"
        lines.append(f"- {t['name']}: {t.get('description', '')[:160]} (args: {props})")
    return "\n".join(lines)


class TorchLocalProvider(Provider):
    """The in-tree GPU decoder as an agent transport."""

    name = "torch_local"
    # the serving endpoint may pass per-request sampling knobs
    supports_gen_overrides = True

    def __init__(
        self,
        model: str | None = None,
        engine=None,
        gen_overrides: dict | None = None,
        device: str = "cuda",
    ):
        import torch

        from fei_tpu_torch.engine import GenerationConfig, InferenceEngine

        self._GenerationConfig = GenerationConfig
        cfg = get_config()
        if engine is not None:
            self.engine = engine
        else:
            model = model or cfg.get("torch_local", "model", DEFAULT_MODELS["torch_local"])
            ckpt = cfg.get("torch_local", "checkpoint_dir", None) or None
            tokenizer = cfg.get("torch_local", "tokenizer", None)
            if tokenizer is None:
                tokenizer = ckpt if ckpt else "byte"
            if not ckpt:
                log.warning(
                    "torch_local provider has no checkpoint_dir configured — "
                    "decoding with RANDOM %s weights (output will be noise). "
                    "Set [torch_local] checkpoint_dir (or "
                    "FEI_TPU_TORCH_LOCAL_CHECKPOINT_DIR) to a local HF "
                    "safetensors directory.", model,
                )
            # settings pass through unfiltered: a bad mode surfaces the
            # engine's own loud error
            self.engine = InferenceEngine.from_config(
                model,
                dtype=torch.bfloat16,
                tokenizer=tokenizer,
                checkpoint_dir=ckpt,
                max_seq_len=int(cfg.get("torch_local", "max_seq_len", 8192)),
                device=device,
                paged=cfg.get_bool("torch_local", "paged", False),
                batch_size=int(cfg.get("torch_local", "batch_size", 1)),
                quantize=cfg.get("torch_local", "quantize", None) or None,
                kv_quant=cfg.get("torch_local", "kv_quant", None) or None,
                prefix_cache=cfg.get_bool("torch_local", "prefix_cache", False),
            )
        self.gen_overrides = gen_overrides or {}
        # on by default, as in the JAX package; the grammar that enforces
        # it is not ported, so constrained tool turns raise (see stream)
        self.constrain_tools = cfg.get_bool("torch_local", "constrain_tools", True)
        self.tool_trigger = cfg.get("torch_local", "tool_trigger", _OPEN_TAG)
        self.last_ttft_s: float | None = None  # set per stream() call

    def _messages_with_system(
        self, messages: list[dict], system: str | None, tools: list[dict] | None
    ) -> list[dict]:
        sys_parts = [system] if system else []
        if tools:
            sys_parts.append(render_tool_prompt(tools, self.tool_trigger))
        out = []
        if sys_parts:
            out.append({"role": "system", "content": "\n\n".join(sys_parts)})
        for m in messages:
            role = m.get("role", "user")
            if role == "tool":
                out.append(
                    {"role": "user",
                     "content": f"<tool_result id={m.get('tool_call_id', '')}>"
                                f"{m.get('content', '')}</tool_result>"}
                )
            else:
                out.append({"role": role, "content": str(m.get("content", ""))})
        return out

    def complete(self, messages, system=None, tools=None, max_tokens=4000,
                 gen_overrides=None):
        gen = self.stream(messages, system, tools, max_tokens,
                          gen_overrides=gen_overrides)
        while True:
            try:
                next(gen)
            except StopIteration as fin:
                return fin.value

    def stream(self, messages, system=None, tools=None, max_tokens=4000,
               gen_overrides=None):
        """Yield visible text deltas; return the ProviderResponse.
        ``gen_overrides`` (per-request sampling knobs from the serving
        endpoint) layer over the provider-level defaults."""
        if tools and self.constrain_tools:
            raise ProviderError(
                "grammar-enforced tool calls need fei_tpu_torch.engine.grammar "
                "(the port of fei_tpu/engine/grammar.py, roadmap module A6), "
                "which is not ported yet; set [torch_local] constrain_tools = "
                "false for post-hoc tool-call parsing"
            )
        full = self._messages_with_system(messages, system, tools)
        ids = self.engine.tokenizer.apply_chat_template(full, add_generation_prompt=True)
        gen = self._GenerationConfig(
            max_new_tokens=max_tokens,
            **{**self.gen_overrides, **(gen_overrides or {})},
        )
        out_ids: list[int] = []
        # Incremental decode: decode a bounded pending window and fold it
        # into ``stable`` at every clean UTF-8 boundary (no trailing
        # U+FFFD), carrying a few tokens of context across the fold so
        # tokenizers that strip a leading space on the first decoded token
        # don't glue words together
        stable = ""
        ctx: list[int] = []
        ctx_text = ""
        pending: list[int] = []
        text_so_far = ""
        emitted = 0
        t_start = time.perf_counter()
        with METRICS.span("provider.torch_local"):
            for tok in self.engine.generate_stream(ids, gen):
                if not out_ids and self.last_ttft_s is None:
                    self.last_ttft_s = time.perf_counter() - t_start
                out_ids.append(tok)
                pending.append(tok)
                tail = self.engine.tokenizer.decode(ctx + pending)[len(ctx_text):]
                text_so_far = stable + tail
                if tail and not tail.endswith("�"):
                    stable, ctx, pending = text_so_far, (ctx + pending)[-8:], []
                    ctx_text = self.engine.tokenizer.decode(ctx)
                visible = stream_visible(text_so_far, self.tool_trigger)
                # hold back a trailing U+FFFD run: the next token may
                # complete that UTF-8 sequence in place
                safe = len(visible.rstrip("�"))
                if safe > emitted:
                    yield visible[emitted:safe]
                    emitted = safe
        visible = stream_visible(text_so_far, self.tool_trigger)
        if len(visible) > emitted:
            yield visible[emitted:]
        content, calls = extract_tool_calls(text_so_far, self.tool_trigger)
        return ProviderResponse(
            content=content,
            tool_calls=calls,
            stop_reason="tool_use" if calls else "stop",
            usage={"prompt_tokens": len(ids), "completion_tokens": len(out_ids)},
        )


class MockProvider(Provider):
    """Deterministic scripted provider for hermetic tests and demos."""

    name = "mock"

    def __init__(self, script: Sequence[ProviderResponse | str] | None = None):
        self.script = list(script or [])
        self.calls: list[dict] = []

    def complete(self, messages, system=None, tools=None, max_tokens=4000):
        self.calls.append(
            {"messages": list(messages), "system": system, "tools": tools}
        )
        if self.script:
            item = self.script.pop(0)
            if isinstance(item, str):
                content, calls = extract_tool_calls(item)
                return ProviderResponse(content, calls,
                                        "tool_use" if calls else "stop")
            return item
        last = messages[-1]["content"] if messages else ""
        return ProviderResponse(f"[mock] echo: {str(last)[:200]}")
