"""The port's agent layer against fei_tpu's:

- ``TorchLocalProvider`` and ``JaxLocalProvider`` over the same tiny
  weights, at the fixed-point trigger (the greedy prefix the model emits
  for the exact tool prompt), return the same grammar-enforced
  ``ToolCall``, through the dense engine and the paged one;
- ``Assistant`` and ``TaskExecutor`` over ``MockProvider`` give the same
  transcripts and tool results;
- ``RemoteProvider`` against a loopback endpoint retries 5xx/429, honours
  ``Retry-After`` and fails fast on 4xx as the reference does, and
  answers the ``openai_stub``;
- ``python -m fei_tpu_torch --message hi --provider mock`` exits 0 and
  prints what ``python -m fei_tpu`` prints; what the port lacks exits
  non-zero naming its roadmap module."""

import asyncio
import http.server
import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fei_tpu.agent import Assistant as JaxAssistant
from fei_tpu.agent import MockProvider as JaxMock
from fei_tpu.agent import ProviderResponse as JaxResponse
from fei_tpu.agent import TaskExecutor as JaxExecutor
from fei_tpu.agent import ToolCall as JaxToolCall
from fei_tpu.agent.providers import JaxLocalProvider
from fei_tpu.agent.providers import RemoteProvider as JaxRemote
from fei_tpu.engine.engine import InferenceEngine as JaxEngine
from fei_tpu.tools import ToolRegistry as JaxRegistry
from fei_tpu.tools import create_code_tools as jax_create
from fei_tpu.utils.errors import FeiError as JaxFeiError
from fei_tpu_torch.agent import (
    Assistant,
    MockProvider,
    ProviderManager,
    ProviderResponse,
    TaskExecutor,
    ToolCall,
)
from fei_tpu_torch.agent.providers import RemoteProvider, TorchLocalProvider
from fei_tpu_torch.engine.engine import InferenceEngine
from fei_tpu_torch.models.convert import params_from_jax
from fei_tpu_torch.tools import ToolRegistry, create_code_tools
from fei_tpu_torch.utils.errors import FeiError
from fei_tpu_torch.utils.metrics import METRICS
from fei_tpu_torch.utils.openai_stub import serve_openai_stub

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOOLS = [
    {"name": "GlobTool", "description": "find files", "input_schema": {
        "type": "object", "properties": {"pattern": {"type": "string"},
                                         "limit": {"type": "integer"}},
        "required": ["pattern"]}},
    {"name": "Glob", "description": "find files (short)", "input_schema": {
        "type": "object", "properties": {"pattern": {"type": "string"}},
        "required": ["pattern"]}},
    {"name": "Shell", "description": "run a command", "input_schema": {
        "type": "object", "properties": {"command": {"type": "string"},
                                         "timeout": {"type": "number"}},
        "required": ["command"]}},
]


# ---------------------------------------------------------------- providers

@pytest.fixture(scope="module")
def engines():
    ref = JaxEngine.from_config("tiny", dtype=jnp.float32, max_seq_len=1024, num_layers=2)
    # the LM head zeroed past the byte tokenizer's ids: the random model's
    # greedy picks decode to text, so a trigger can be found
    ref.params["lm_head"] = ref.params["lm_head"].at[:, ref.tokenizer.vocab_size:].set(0.0)
    params = params_from_jax(jax.tree.map(np.asarray, ref.params))
    mine = InferenceEngine.from_config("tiny", params=params, device="cpu",
                                       dtype=torch.float32, max_seq_len=1024, num_layers=2)
    return ref, mine


def _fixed_point_trigger(provider, messages, tools):
    """The trigger the model emits for the provider's EXACT prompt: the
    trigger appears in the rendered tool prompt, so iterate until the
    greedy prefix of the prompt that contains it is the trigger itself."""
    for _ in range(8):
        full = provider._messages_with_system(messages, None, tools)
        ids = provider.engine.tokenizer.apply_chat_template(full, add_generation_prompt=True)
        toks = []
        for tok in provider.engine.generate_stream(
                ids, provider._GenerationConfig(max_new_tokens=8, ignore_eos=True)):
            toks.append(tok)
        text = provider.engine.tokenizer.decode(toks)
        if not text:
            return None
        if text == provider.tool_trigger:
            return text
        provider.tool_trigger = text
    return None


def _constrained_call(provider, messages):
    before = METRICS.snapshot()["counters"].get("engine.grammar_fused_steps", 0)
    resp = provider.complete(messages, tools=TOOLS, max_tokens=96)
    fused = METRICS.snapshot()["counters"].get("engine.grammar_fused_steps", 0) - before
    return resp, fused


def test_local_providers_return_the_same_tool_call(engines):
    ref, mine = engines
    ours = TorchLocalProvider(engine=mine, gen_overrides={"ignore_eos": True})
    theirs = JaxLocalProvider(engine=ref, gen_overrides={"ignore_eos": True})
    assert ours.constrain_tools and theirs.constrain_tools  # on by default
    messages = None
    for content in ("list the python files", "grep for TODO", "run ls", "open README"):
        cand = [{"role": "user", "content": content}]
        if _fixed_point_trigger(ours, cand, TOOLS):
            messages = cand
            break
    assert messages is not None, "no prompt converges to a fixed-point trigger"
    theirs.tool_trigger = ours.tool_trigger
    resp, fused = _constrained_call(ours, messages)
    want = theirs.complete(messages, tools=TOOLS, max_tokens=96)
    assert fused > 0, "the provider did not run the fused grammar decode"
    assert resp.stop_reason == want.stop_reason == "tool_use"
    assert len(resp.tool_calls) == len(want.tool_calls) == 1
    call, ref_call = resp.tool_calls[0], want.tool_calls[0]
    assert (call.name, call.arguments) == (ref_call.name, ref_call.arguments)
    schema = next(t["input_schema"] for t in TOOLS if t["name"] == call.name)
    assert all(r in call.arguments for r in schema["required"])
    assert resp.content == want.content and resp.usage == want.usage
    # the tool set's grammar is memoized: a second turn lifts nothing
    assert ours._tool_grammar(TOOLS) is ours._tool_grammar(list(TOOLS))

    # the paged engine answers the same turn with the same call
    paged = InferenceEngine.from_config("tiny", params=mine.params, paged=True,
                                        page_size=16, batch_size=2, device="cpu",
                                        dtype=torch.float32, max_seq_len=1024, num_layers=2)
    try:
        pp = TorchLocalProvider(engine=paged, gen_overrides={"ignore_eos": True})
        pp.tool_trigger = ours.tool_trigger
        presp = pp.complete(messages, tools=TOOLS, max_tokens=96)
        assert [(c.name, c.arguments) for c in presp.tool_calls] == [(call.name, call.arguments)]
        with pytest.raises(FeiError, match="resume"):
            next(pp.stream(messages, tools=TOOLS, max_tokens=8, resume={"generated": [1]}))
    finally:
        paged.close()


def test_constrain_tools_off_parses_after_generation(engines):
    _, mine = engines
    p = TorchLocalProvider(engine=mine, gen_overrides={"ignore_eos": True})
    p.constrain_tools = False
    assert p._tool_grammar(TOOLS) is None
    resp = p.complete([{"role": "user", "content": "hi"}], tools=TOOLS, max_tokens=4)
    assert resp.usage["completion_tokens"] == 4


# ----------------------------------------------------------- agent loop

def _transcript(assistant):
    """Messages with the call ids (uuid4 per parse) numbered in order."""
    ids: dict = {}
    out = []
    for m in assistant.conversation.messages:
        m = json.loads(json.dumps(m, default=lambda o: o.__dict__))
        for c in m.get("tool_calls") or []:
            c["id"] = ids.setdefault(c["id"], len(ids))
        if "tool_call_id" in m:
            m["tool_call_id"] = ids.setdefault(m["tool_call_id"], len(ids))
        out.append(m)
    return out


SCRIPTS = {
    "plain": ["hello there"],
    "tool_round": ['<tool_call>{"name": "GlobTool", "arguments": {"pattern": "*.py", '
                   '"path": "{root}"}}</tool_call>', "I found one python file."],
    "tool_error": ['<tool_call>{"name": "View", "arguments": {"file_path": '
                   '"/definitely/missing"}}</tool_call>', "the file is missing"],
    "two_calls": ['<tool_call>{"name": "LS", "arguments": {"path": "{root}"}}</tool_call>'
                  '<tool_call>{"name": "GrepTool", "arguments": {"pattern": "x", '
                  '"path": "{root}"}}</tool_call>', ""],
    "unknown_tool": ['<tool_call>{"name": "Nope", "arguments": {}}</tool_call>', "ok"],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_assistant_transcript_matches_reference(name, tmp_path):
    (tmp_path / "a.py").write_text("x = 1\n")
    script = [s.replace("{root}", str(tmp_path)) for s in SCRIPTS[name]]
    got = []
    for assistant_cls, mock_cls, registry_cls, create in (
            (JaxAssistant, JaxMock, JaxRegistry, jax_create),
            (Assistant, MockProvider, ToolRegistry, create_code_tools)):
        reg = registry_cls()
        create(reg)
        provider = mock_cls(list(script))
        deltas = []
        a = assistant_cls(provider=provider, tool_registry=reg, max_tool_rounds=2,
                          on_text=deltas.append)
        out = asyncio.run(a.chat("what python files are there?"))
        got.append((out, _transcript(a), "".join(deltas), a.last_usage,
                    [c["tools"] == a.tool_manager.get_tools() for c in provider.calls]))
    assert got[0] == got[1]


@pytest.mark.parametrize("case", ["completes", "cap", "interactive"])
def test_task_executor_matches_reference(case):
    scripts = {
        "completes": ["step one done", "all finished [TASK_COMPLETE]"],
        "cap": ["still going"] * 10,
        "interactive": ["going"] * 10,
    }
    got = []
    for assistant_cls, mock_cls, resp_cls, executor_cls in (
            (JaxAssistant, JaxMock, JaxResponse, JaxExecutor),
            (Assistant, MockProvider, ProviderResponse, TaskExecutor)):
        provider = mock_cls([resp_cls(s) for s in scripts[case]])
        a = assistant_cls(provider=provider)
        ex = executor_cls(a, max_iterations=3 if case == "cap" else 5)
        if case == "interactive":
            ctx = asyncio.run(ex.execute_interactive(
                "t", confirm=lambda c, r: c.iterations < 2))
        else:
            ctx = asyncio.run(ex.execute_task("do it"))
        got.append((ctx.completed, ctx.iterations, ctx.responses, ctx.final_response,
                    [c["messages"] for c in provider.calls]))
    assert got[0] == got[1]


def test_tool_call_dataclasses_and_manager_defaults():
    assert ToolCall("i", "n", {}).__dict__ == JaxToolCall("i", "n", {}).__dict__
    assert ProviderManager().provider_name == "torch_local"
    assert ProviderManager("mock").get_provider().complete(
        [{"role": "user", "content": "x"}]).content == "[mock] echo: x"


# ------------------------------------------------------------- remote

def _flaky_server(codes, retry_after=None):
    state = {"calls": 0}

    class Flaky(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            i, state["calls"] = state["calls"], state["calls"] + 1
            if i < len(codes):
                self.send_response(codes[i])
                if retry_after is not None:
                    self.send_header("Retry-After", retry_after)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            body = json.dumps({"choices": [{"message": {"role": "assistant",
                                                        "content": "recovered"}}],
                               "usage": {"prompt_tokens": 1, "completion_tokens": 1}}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Flaky)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}/v1", state


@pytest.mark.parametrize("codes,retry_after,retries", [
    ([503, 429], "2", "3"),  # transient failures recover after Retry-After
    ([429] * 5, "1", "1"),  # exhaustion: RateLimitError after 1 + 1 attempts
    ([400], None, "3"),  # a client error is never retried
    ([503], "soon", "3"),  # an unparsable Retry-After: backoff instead
])
def test_remote_retries_match_reference(codes, retry_after, retries, monkeypatch):
    import time

    monkeypatch.setenv("FEI_TPU_PROVIDER_RETRIES", retries)
    monkeypatch.setenv("FEI_TPU_PROVIDER_BACKOFF_S", "0")
    got = []
    for remote_cls, err_cls in ((JaxRemote, JaxFeiError), (RemoteProvider, FeiError)):
        sleeps = []
        monkeypatch.setattr(time, "sleep", sleeps.append)
        server, base, state = _flaky_server(codes, retry_after)
        try:
            resp = remote_cls("openai", model="stub", api_base=base).complete(
                [{"role": "user", "content": "hi"}])
            outcome = ("ok", resp.content, resp.usage)
        except err_cls as exc:
            outcome = ("error", type(exc).__name__)
        finally:
            server.shutdown()
        got.append((outcome, state["calls"], sleeps))
    assert got[0] == got[1]


def test_remote_against_openai_stub():
    tools = [{"name": "GlobTool", "description": "find",
              "input_schema": {"type": "object", "properties": {}}}]

    def responder(payload):
        if payload.get("tools"):
            return ({"role": "assistant", "content": None, "tool_calls": [{
                "id": "call_1", "type": "function",
                "function": {"name": "GlobTool", "arguments": '{"pattern": "*.py"}'}}]},
                {"prompt_tokens": 5, "completion_tokens": 7})
        return {"role": "assistant", "content": "plain"}, {"completion_tokens": 3}

    server, base = serve_openai_stub(responder=responder)
    try:
        p = RemoteProvider("openai", model="stub", api_base=base)
        assert p.api_key == "local" or p.api_key  # keyless loopback allowed
        resp = p.complete([{"role": "user", "content": "find"}], system="sys", tools=tools)
        assert resp.stop_reason == "tool_use"
        assert (resp.tool_calls[0].name, resp.tool_calls[0].arguments) == (
            "GlobTool", {"pattern": "*.py"})
        assert server.last_payload["messages"][0] == {"role": "system", "content": "sys"}
        assert server.last_payload["tools"][0]["function"]["name"] == "GlobTool"
        assert p.complete([{"role": "user", "content": "hi"}]).content == "plain"
    finally:
        server.shutdown()


# ---------------------------------------------------------------- CLI

def _run(pkg, args, home):
    env = dict(os.environ, JAX_PLATFORMS="cpu", HOME=str(home),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", pkg, *args], capture_output=True,
                          text=True, timeout=300, env=env, cwd=REPO)


def test_message_cli_prints_what_the_reference_prints(tmp_path):
    args = ["--message", "hi", "--provider", "mock"]
    ours, theirs = _run("fei_tpu_torch", args, tmp_path / "a"), _run("fei_tpu", args, tmp_path / "b")
    assert ours.returncode == theirs.returncode == 0, ours.stderr[-800:]
    assert ours.stdout == theirs.stdout and "[mock] echo: hi" in ours.stdout
    # the turn went to the history file, as the reference's does
    hist = json.loads((tmp_path / "a" / ".fei_tpu" / "history.json").read_text())
    assert hist[-1]["prompt"] == "hi"


@pytest.mark.parametrize("args,module", [
    (["--textual"], "ui/textual_chat.py"),
    (["--memory-tools", "--provider", "mock", "--message", "hi"], "tools/memory_tools.py"),
    (["mcp", "list"], "agent/mcp.py"),
    (["search", "x"], "agent/mcp.py"),
])
def test_unported_cli_features_fail_loudly(args, module, tmp_path):
    out = _run("fei_tpu_torch", args, tmp_path)
    assert out.returncode != 0
    assert module in out.stderr
