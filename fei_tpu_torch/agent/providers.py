"""LLM providers over the PyTorch engine (counterpart of
fei_tpu/agent/providers.py).

The provider contract is the JAX package's: (messages, system, tools) →
(text, tool_calls). Implementations here:

- ``TorchLocalProvider`` — the counterpart of ``JaxLocalProvider``: an
  ``InferenceEngine`` decoding on the local GPU; with ``[torch_local]
  paged = true`` the paged engine, whose scheduler batches concurrent
  requests. Tool calls are emitted as ``<tool_call>{json}</tool_call>``
  blocks and, by default, ENFORCED during generation by the
  registry-union tool-call grammar (engine/grammar.py;
  ``engine.generate_stream_toolcalls`` steps the DFA on the device), so an
  emitted call cannot be unparseable. ``[torch_local] constrain_tools =
  false`` parses the calls after generation instead.
- ``MockProvider`` — scripted responses for hermetic tests.
- ``RemoteProvider`` — an OpenAI-compatible ``/chat/completions``
  endpoint (litellm when installed), with bounded retries, backoff and
  ``Retry-After``.
- ``ProviderManager`` resolves a provider name; the default is
  ``torch_local``.
"""

from __future__ import annotations

import functools
import json
import os
import re
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Sequence

from fei_tpu_torch.utils.config import get_config
from fei_tpu_torch.utils.errors import (
    AuthenticationError,
    ProviderError,
    RateLimitError,
)
from fei_tpu_torch.utils.logging import get_logger
from fei_tpu_torch.utils.metrics import METRICS

log = get_logger("agent.providers")

DEFAULT_MODELS = {
    "torch_local": "llama3-1b",
    "anthropic": "claude-3-5-sonnet-20240620",
    "openai": "gpt-4o",
    "groq": "llama3-70b-8192",
}


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
        # grammar enforcement of tool calls, on by default as in the JAX
        # package; [torch_local] constrain_tools = false parses calls after
        # generation. The trigger is configurable so tests can drive the
        # constrained path with random weights.
        self.constrain_tools = cfg.get_bool("torch_local", "constrain_tools", True)
        self.tool_trigger = cfg.get("torch_local", "tool_trigger", _OPEN_TAG)
        self._grammar_cache: dict = {}
        self.last_ttft_s: float | None = None  # set per stream() call

    def _tool_grammar(self, tools: list[dict] | None):
        """Registry-union TokenGrammar for ``tools``, memoized per schema
        set (the lift costs seconds at 128k vocab, and its device tables
        are memoized on it, so a tool set is uploaded once). A grammar that
        fails to compile falls back to post-hoc parsing, with a warning."""
        if not tools or not self.constrain_tools:
            return None
        try:
            key = json.dumps(
                [{t["name"]: t.get("input_schema", t.get("parameters"))} for t in tools],
                sort_keys=True, default=str,
            )
        except (KeyError, TypeError) as exc:
            log.warning("unhashable tool list (%s); tool grammar disabled", exc)
            return None
        if key not in self._grammar_cache:
            from fei_tpu_torch.engine.faults import FAULTS
            from fei_tpu_torch.engine.grammar import compile_agent_tool_grammar
            from fei_tpu_torch.utils.errors import EngineError

            try:
                FAULTS.check("grammar.compile", tools=key)
                g = compile_agent_tool_grammar(tools, self.engine.tokenizer)
                log.info(
                    "tool-call grammar compiled: %d tools, %d states, "
                    "%.1f MB tables, lift %.2fs",
                    len(tools), g.table.shape[0], g.table_bytes / 1e6, g.lift_seconds,
                )
            except EngineError as exc:
                log.warning(
                    "tool grammar compile failed (%s); falling back to "
                    "post-hoc tool-call parsing", exc,
                )
                g = None
            self._grammar_cache[key] = g
        return self._grammar_cache[key]

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
               gen_overrides=None, resume=None):
        """Yield visible text deltas; return the ProviderResponse.
        ``gen_overrides`` (per-request sampling knobs from the serving
        endpoint) layer over the provider-level defaults. A tool turn
        decodes under the tool-call grammar (``generate_stream_toolcalls``).
        ``resume`` (a mid-stream failover payload) is refused for a grammar
        turn, as in the JAX package: its walk would restart from token 0;
        the port has no resumable plain route yet either (roadmap B4)."""
        grammar = self._tool_grammar(tools)
        if resume is not None:
            if grammar is not None:
                raise ProviderError(
                    "mid-stream resume is not supported for tool-grammar turns")
            raise ProviderError(
                "mid-stream resume needs the journal's keys (fei_tpu/engine/"
                "journal.py, roadmap module B4), which are not ported yet")
        if grammar is not None:
            stream_fn = functools.partial(
                self.engine.generate_stream_toolcalls,
                grammar=grammar, trigger=self.tool_trigger,
            )
        else:
            stream_fn = self.engine.generate_stream
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
            for tok in stream_fn(ids, gen):
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


class RemoteProvider(Provider):
    """Remote-API passthrough for comparison baselines (BASELINE config #1).

    Dispatches through litellm when installed (multi-provider, reference-
    equivalent: fei/core/assistant.py:524-530). Without litellm, an
    ``api_base`` pointing at any OpenAI-compatible ``/chat/completions``
    endpoint is served by a dependency-free urllib client — covering local
    deployments and the loopback client-path benchmark."""

    name = "remote"

    def __init__(self, provider: str = "anthropic", model: str | None = None,
                 api_key: str | None = None, api_base: str | None = None):
        cfg = get_config()
        self.api_base = (
            api_base
            or os.environ.get(f"{provider.upper()}_API_BASE")
            or cfg.get(provider, "api_base", None)
        )
        try:
            import litellm  # noqa: F401

            self._litellm = True
        except ImportError:
            self._litellm = False
            if not self.api_base:
                raise ProviderError(
                    "litellm is not installed and no api_base is configured; "
                    "RemoteProvider needs one or the other (the torch_local "
                    "provider needs no external packages)"
                ) from None
        self.provider = provider
        self.model = model or DEFAULT_MODELS.get(provider, provider)
        self.api_key = api_key or self._resolve_key(provider)
        if not self.api_key:
            if self.api_base and self._is_loopback(self.api_base):
                # self-hosted loopback endpoints are typically keyless; a
                # REMOTE api_base without a key still fails loudly here
                # rather than as an opaque 401 at first request
                self.api_key = "local"
            else:
                raise AuthenticationError(
                    f"no API key for provider {provider!r}: set "
                    f"{provider.upper()}_API_KEY or LLM_API_KEY"
                )

    @staticmethod
    def _is_loopback(base: str) -> bool:
        from urllib.parse import urlparse

        host = urlparse(base).hostname or ""
        return host in ("localhost", "127.0.0.1", "::1")

    @staticmethod
    def _resolve_key(provider: str) -> str | None:
        cfg = get_config()
        return (
            os.environ.get(f"{provider.upper()}_API_KEY")
            or os.environ.get("LLM_API_KEY")
            or cfg.get(provider, "api_key", None)
        )

    @staticmethod
    def _to_openai_messages(messages: list[dict]) -> list[dict]:
        """Conversation messages use an internal shape; litellm needs the
        OpenAI one (tool_calls wrapped in type/function, arguments as a JSON
        string, tool results keyed by tool_call_id)."""
        out: list[dict] = []
        for m in messages:
            role = m.get("role", "user")
            if role == "assistant" and m.get("tool_calls"):
                out.append({
                    "role": "assistant",
                    "content": m.get("content") or None,
                    "tool_calls": [
                        {"id": c["id"], "type": "function",
                         "function": {"name": c["name"],
                                      "arguments": json.dumps(c["arguments"])}}
                        for c in m["tool_calls"]
                    ],
                })
            elif role == "tool":
                out.append({
                    "role": "tool",
                    "tool_call_id": m.get("tool_call_id", ""),
                    "content": str(m.get("content", "")),
                })
            else:
                out.append({"role": role, "content": str(m.get("content", ""))})
        return out

    @staticmethod
    def _openai_tools(tools: list[dict] | None) -> list[dict] | None:
        if not tools:
            return None
        return [
            {"type": "function",
             "function": {"name": t["name"],
                          "description": t.get("description", ""),
                          "parameters": t.get("input_schema", {})}}
            for t in tools
        ]

    @staticmethod
    def _retry_after_s(headers) -> float | None:
        """Parse a Retry-After header (integer-seconds form only; the
        HTTP-date form is rare among API providers and falls back to the
        computed backoff)."""
        try:
            val = headers.get("Retry-After") if headers is not None else None
            return None if val is None else max(0.0, float(val))
        except (TypeError, ValueError):
            return None

    def _post_with_retries(self, req) -> dict:
        """POST ``req`` with bounded retries: connection errors and
        429/5xx statuses retry with exponential backoff + full jitter,
        honoring ``Retry-After`` when the server sends one. Other HTTP
        errors (auth, bad request) and malformed 200s fail immediately —
        retrying those just burns the budget. Each retry increments the
        ``provider.retries`` counter; the ``provider.http`` fault point
        sits inside the loop so injected transport faults exercise
        exactly this path."""
        import random
        import urllib.error
        import urllib.request

        from fei_tpu_torch.engine.faults import FAULTS

        retries = max(0, int(os.environ.get("FEI_TPU_PROVIDER_RETRIES", "3")))
        timeout = float(os.environ.get("FEI_TPU_PROVIDER_TIMEOUT_S", "120"))
        backoff = float(os.environ.get("FEI_TPU_PROVIDER_BACKOFF_S", "0.5"))
        last_exc: Exception | None = None
        for attempt in range(retries + 1):
            retry_after = None
            try:
                FAULTS.check("provider.http", attempt=attempt)
                with urllib.request.urlopen(req, timeout=timeout) as resp:
                    raw = resp.read()
                try:
                    return json.loads(raw)
                except ValueError as exc:  # malformed 200: not retryable
                    raise ProviderError(
                        f"remote completion failed: {exc}", cause=exc
                    ) from exc
            except urllib.error.HTTPError as exc:
                if exc.code != 429 and exc.code < 500:
                    raise ProviderError(
                        f"remote completion failed: {exc}", cause=exc
                    ) from exc
                retry_after = self._retry_after_s(exc.headers)
                last_exc = exc
            except (urllib.error.URLError, ConnectionError, OSError,
                    TimeoutError) as exc:
                last_exc = exc
            if attempt >= retries:
                break
            delay = retry_after
            if delay is None:
                # full jitter over the exponential envelope, capped: a
                # thundering herd of synchronized clients is exactly the
                # load shape the server-side breaker exists to survive
                delay = random.uniform(0, min(backoff * 2 ** attempt, 30.0))
            METRICS.incr("provider.retries")
            log.warning(
                "remote completion attempt %d/%d failed (%r); retrying "
                "in %.2fs", attempt + 1, retries + 1, last_exc, delay,
            )
            time.sleep(delay)
        import urllib.error as _ue

        if isinstance(last_exc, _ue.HTTPError) and last_exc.code == 429:
            raise RateLimitError(
                f"remote endpoint rate-limited after {retries + 1} "
                f"attempts: {last_exc}", cause=last_exc,
            ) from last_exc
        raise ProviderError(
            f"remote completion failed after {retries + 1} attempts: "
            f"{last_exc}", cause=last_exc,
        ) from last_exc

    def _complete_urllib(self, msgs, tools, max_tokens) -> "ProviderResponse":
        """OpenAI-compatible /chat/completions via urllib (no litellm)."""
        import urllib.request

        payload: dict[str, Any] = {
            "model": self.model, "messages": msgs, "max_tokens": max_tokens,
        }
        oa_tools = self._openai_tools(tools)
        if oa_tools:
            payload["tools"] = oa_tools
        req = urllib.request.Request(
            self.api_base.rstrip("/") + "/chat/completions",
            data=json.dumps(payload).encode("utf-8"),
            headers={
                "Content-Type": "application/json",
                "Authorization": f"Bearer {self.api_key}",
            },
            method="POST",
        )
        body = self._post_with_retries(req)
        try:
            # error-shaped 200s ({"error": {...}} or empty choices) are a
            # real pattern among OpenAI-compatible servers
            if "error" in body:
                raise ProviderError(
                    f"remote endpoint error: {body['error']}"
                )
            msg = body["choices"][0]["message"]
            calls = [
                ToolCall(
                    tc.get("id", f"call_{uuid.uuid4().hex[:12]}"),
                    tc["function"]["name"],
                    json.loads(tc["function"].get("arguments") or "{}"),
                )
                for tc in (msg.get("tool_calls") or [])
            ]
        except ProviderError:
            raise
        except Exception as exc:  # noqa: BLE001
            # covers transport errors AND malformed 200s (missing fields,
            # invalid tool-call argument JSON) — one error contract
            raise ProviderError(
                f"remote completion failed: {exc}", cause=exc
            ) from exc
        return ProviderResponse(
            content=msg.get("content") or "",
            tool_calls=calls,
            stop_reason="tool_use" if calls else "stop",
            usage=body.get("usage", {}),
        )

    def complete(self, messages, system=None, tools=None, max_tokens=4000):
        msgs = ([{"role": "system", "content": system}] if system else []) \
            + self._to_openai_messages(messages)
        if not self._litellm:
            return self._complete_urllib(msgs, tools, max_tokens)
        import litellm

        kwargs: dict[str, Any] = {
            "model": f"{self.provider}/{self.model}",
            "messages": msgs,
            "max_tokens": max_tokens,
            "api_key": self.api_key,
        }
        if self.api_base:
            kwargs["api_base"] = self.api_base
        oa_tools = self._openai_tools(tools)
        if oa_tools:
            kwargs["tools"] = oa_tools
        try:
            resp = litellm.completion(**kwargs)
        except Exception as exc:  # noqa: BLE001
            raise ProviderError(f"remote completion failed: {exc}", cause=exc) from exc
        choice = resp.choices[0]
        calls = [
            ToolCall(tc.id, tc.function.name, json.loads(tc.function.arguments or "{}"))
            for tc in (choice.message.tool_calls or [])
        ]
        return ProviderResponse(
            content=choice.message.content or "",
            tool_calls=calls,
            stop_reason="tool_use" if calls else "stop",
        )


class ProviderManager:
    """Resolve a provider name (+model/key) into a Provider instance.

    Parity with the reference's ProviderManager (fei/core/assistant.py:25-111)
    except the default provider is the local GPU engine, ``torch_local``.
    """

    def __init__(self, provider: str | None = None, model: str | None = None,
                 api_key: str | None = None, engine=None):
        cfg = get_config()
        self.provider_name = provider or cfg.get("agent", "provider", "torch_local")
        self.model = model
        self.api_key = api_key
        self._engine = engine
        self._provider: Provider | None = None

    def get_provider(self) -> Provider:
        if self._provider is None:
            name = self.provider_name
            if name == "torch_local":
                self._provider = TorchLocalProvider(self.model, engine=self._engine)
            elif name == "mock":
                self._provider = MockProvider()
            else:
                self._provider = RemoteProvider(name, self.model, self.api_key)
        return self._provider

    def set_provider(self, provider: Provider) -> None:
        self._provider = provider
