"""CLI: interactive REPL, one-shot message, continuous task mode, subcommands
(a copy of fei_tpu/ui/cli.py that imports only the port).

The provider defaults to ``torch_local``, the engine on the local GPU, and
tokens stream to stdout as they decode. What the port does not have yet
fails loudly and names its roadmap module: the ``mcp`` subcommand and web
search (``search``; ``ask`` without ``--no-search`` says the search is
unavailable, as the JAX package does when its search fails) need
``agent/mcp.py``, and ``--memory-tools`` needs ``tools/memory_tools.py``.
At startup the MCP tools are reported unavailable, the route the JAX
package takes when its MCP manager cannot start.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time
from collections import deque

from fei_tpu_torch.utils.logging import get_logger, setup_logging

log = get_logger("ui.cli")

HISTORY_DIR = os.path.expanduser("~/.fei_tpu")
HISTORY_FILE = os.path.join(HISTORY_DIR, "history.json")
HISTORY_MAX = 100


class History:
    """Rolling JSON history of prompts/responses (parity: cli.py:68-137)."""

    def __init__(self, path: str | None = None, maxlen: int = HISTORY_MAX):
        # resolved at call time so tests can repoint HISTORY_FILE
        self.path = path or HISTORY_FILE
        self.entries: deque = deque(maxlen=maxlen)
        self._load()

    def _load(self) -> None:
        try:
            with open(self.path) as fh:
                for entry in json.load(fh):
                    self.entries.append(entry)
        except (OSError, ValueError):
            pass

    def save(self) -> None:
        try:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            with open(self.path, "w") as fh:
                json.dump(list(self.entries), fh, indent=1)
        except OSError as exc:
            log.warning("could not persist history: %s", exc)

    def add(self, prompt: str, response: str) -> None:
        self.entries.append(
            {"ts": time.time(), "prompt": prompt, "response": response[:4000]}
        )
        self.save()


# what the port has not ported yet, by roadmap module
MCP_MISSING = ("MCP (fei_tpu/agent/mcp.py) is not ported to fei_tpu_torch yet "
               "(roadmap module agent/mcp.py)")
MEMORY_TOOLS_MISSING = ("--memory-tools needs fei_tpu/tools/memory_tools.py, which is "
                        "not ported to fei_tpu_torch yet (roadmap module "
                        "tools/memory_tools.py)")
TEXTUAL_MISSING = ("--textual needs fei_tpu/ui/textual_chat.py, which is not ported "
                   "to fei_tpu_torch yet (roadmap module ui/textual_chat.py)")


class NotPortedError(RuntimeError):
    """A CLI feature whose module the port does not have yet."""


def build_assistant(args):
    from fei_tpu_torch.agent import Assistant
    from fei_tpu_torch.tools import ToolRegistry, create_code_tools

    if getattr(args, "memory_tools", False):
        raise NotPortedError(MEMORY_TOOLS_MISSING)
    registry = ToolRegistry()
    create_code_tools(registry)
    log.warning("mcp tools unavailable: %s", MCP_MISSING)
    streamed: list[str] = []
    on_text = None
    if not getattr(args, "no_stream", False):
        def on_text(delta: str) -> None:
            streamed.append(delta)
            sys.stdout.write(delta)
            sys.stdout.flush()
    assistant = Assistant(
        provider=args.provider,
        model=args.model,
        tool_registry=registry,
        max_tool_rounds=args.max_tool_rounds,
        max_tokens=args.max_tokens,
        on_text=on_text,
    )
    assistant._streamed = streamed
    return assistant


def emit_final(assistant, response: str) -> None:
    """Print a turn's final text, accounting for what streaming already
    showed: in streaming mode, text that never went through on_text (salvaged
    tool output, post-tool-round content) is still printed."""
    if assistant.on_text is None:
        print(response)
        return
    streamed = "".join(getattr(assistant, "_streamed", []))
    print()
    # whitespace-normalized containment: multi-round responses join with
    # newlines the stream never carried
    norm = lambda s: " ".join(s.split())  # noqa: E731
    if response.strip() and norm(response) not in norm(streamed):
        print(response)
    getattr(assistant, "_streamed", []).clear()


def process_single_message(assistant, message: str, history: History) -> int:
    response = asyncio.run(assistant.chat(message))
    emit_final(assistant, response)
    history.add(message, response)
    return 0


def process_continuous_task(assistant, task: str, max_iterations: int,
                            history: History) -> int:
    from fei_tpu_torch.agent import TaskExecutor

    # Task mode prints each iteration's cleaned response instead of streaming
    # raw text — streaming would show the [TASK_COMPLETE] protocol marker.
    assistant.on_text = None
    executor = TaskExecutor(assistant, max_iterations=max_iterations)
    ctx = asyncio.run(executor.execute_task(task))
    for i, resp in enumerate(ctx.responses, 1):
        print(f"--- iteration {i} ---\n{resp}")
    print(
        f"\n[task {'completed' if ctx.completed else 'stopped'} after "
        f"{ctx.iterations} iteration(s), {ctx.duration_s:.1f}s]",
        file=sys.stderr,
    )
    history.add(f"[task] {task}", ctx.final_response)
    return 0 if ctx.completed else 1


def chat_loop(assistant, history: History) -> int:
    print("fei_tpu_torch interactive chat — 'exit' to quit, 'clear' to reset, "
          "'history' to list past prompts.")
    while True:
        try:
            line = input("\nyou> ").strip()
        except (EOFError, KeyboardInterrupt):
            print()
            return 0
        if not line:
            continue
        if line in ("exit", "quit"):
            return 0
        if line == "clear":
            assistant.reset()
            print("[conversation cleared]")
            continue
        if line == "history":
            for i, e in enumerate(history.entries):
                print(f"{i:3d}. {e['prompt'][:80]}")
            continue
        print("fei> ", end="", flush=True)
        try:
            response = asyncio.run(assistant.chat(line))
            emit_final(assistant, response)
            history.add(line, response)
        except KeyboardInterrupt:
            print("\n[interrupted]")


def handle_history_command(args) -> int:
    history = History()
    if args.history_action == "list":
        for i, e in enumerate(history.entries):
            stamp = time.strftime("%Y-%m-%d %H:%M", time.localtime(e["ts"]))
            print(f"{i:3d}. [{stamp}] {e['prompt'][:100]}")
    elif args.history_action == "show":
        idx = args.index
        if 0 <= idx < len(history.entries):
            e = list(history.entries)[idx]
            print(f"prompt: {e['prompt']}\n\nresponse:\n{e['response']}")
        else:
            print(f"no history entry {idx}", file=sys.stderr)
            return 1
    elif args.history_action == "clear":
        history.entries.clear()
        history.save()
        print("history cleared")
    elif args.history_action == "load":
        # replay an entry into a fresh conversation, then continue
        # interactively (parity: reference cli.py:479-515)
        idx = args.index
        if not 0 <= idx < len(history.entries):
            print(f"no history entry {idx}", file=sys.stderr)
            return 1
        entry = list(history.entries)[idx]
        try:
            assistant = build_assistant(args)
        except Exception as exc:  # noqa: BLE001
            print(f"error: {exc}", file=sys.stderr)
            return 2
        assistant.conversation.add_user_message(entry["prompt"])
        assistant.conversation.add_assistant_message(entry["response"])
        print(f"[loaded entry {idx}]\nyou> {entry['prompt']}\n"
              f"fei> {entry['response']}")
        return chat_loop(assistant, history)
    return 0


def handle_mcp_command(args) -> int:
    print(f"error: {MCP_MISSING}", file=sys.stderr)
    return 2


def run_search(query: str, count: int = 5, manager=None) -> list[dict]:
    """Direct web search goes through the MCP brave service, which the port
    does not have yet: raises ``NotPortedError`` naming its module."""
    raise NotPortedError(MCP_MISSING)


def handle_search_command(args) -> int:
    try:
        results = run_search(args.query, count=args.count)
    except Exception as exc:  # noqa: BLE001 — network/MCP errors must be readable
        print(f"search failed: {exc}", file=sys.stderr)
        return 1
    if not results:
        print("no results")
        return 0
    for i, r in enumerate(results, 1):
        print(f"{i}. {r['title']}\n   {r['url']}\n   {r['description']}\n")
    return 0


ASK_PROMPT = """Answer the question using the web search results below.
Cite result numbers like [1] where they support your answer. If the results
are insufficient, say what is missing.

Search results for: {query}
{results}

Question: {query}"""


def handle_ask_command(args) -> int:
    """Search-stuffed one-shot ask (parity: ref fei/ui/cli.py:623-728)."""
    results: list[dict] = []
    if not args.no_search:
        try:
            results = run_search(args.query, count=args.count)
        except Exception as exc:  # noqa: BLE001
            print(f"[search unavailable: {exc}]", file=sys.stderr)
    if results:
        blob = "\n".join(
            f"[{i}] {r['title']} — {r['url']}\n    {r['description']}"
            for i, r in enumerate(results, 1)
        )
        prompt = ASK_PROMPT.format(query=args.query, results=blob)
    else:
        prompt = args.query
    try:
        assistant = build_assistant(args)
    except Exception as exc:  # noqa: BLE001
        print(f"error: {exc}", file=sys.stderr)
        return 2
    response = asyncio.run(assistant.chat(prompt))
    emit_final(assistant, response)
    History().add(f"[ask] {args.query}", response)
    return 0


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="fei", description="fei_tpu_torch — a coding assistant on a local GPU"
    )
    p.add_argument("--message", "-m", help="one-shot message, print reply and exit")
    p.add_argument("--task", "-t", help="continuous task executed until [TASK_COMPLETE]")
    p.add_argument("--provider", default=None,
                   help="torch_local (default, the local GPU), mock, or a remote provider name")
    p.add_argument("--model", default=None, help="model name/config for the provider")
    p.add_argument("--max-iterations", type=int, default=10, help="task mode iteration cap")
    p.add_argument("--max-tool-rounds", type=int, default=8)
    p.add_argument("--max-tokens", type=int, default=4000)
    p.add_argument("--no-stream", action="store_true", help="print whole replies, not token stream")
    p.add_argument("--stats", action="store_true",
                   help="print engine/agent span timings and counters after the turn")
    p.add_argument("--memory-tools", action="store_true", help="register memdir memory tools")
    p.add_argument("--log-level", default=None)
    sub = p.add_subparsers(dest="command")
    hist = sub.add_parser("history", help="inspect saved prompt history")
    hist.add_argument("history_action", choices=["list", "show", "clear", "load"])
    hist.add_argument("index", nargs="?", type=int, default=0)
    mcp = sub.add_parser("mcp", help="MCP service operations")
    mcp.add_argument("mcp_action", choices=["list", "call", "probe"])
    mcp.add_argument("service", nargs="?")
    mcp.add_argument("method", nargs="?")
    mcp.add_argument("--params", help="JSON params for mcp call")
    search = sub.add_parser("search", help="direct web search (brave via MCP)")
    search.add_argument("query")
    search.add_argument("--count", type=int, default=5)
    ask = sub.add_parser(
        "ask", help="one-shot question answered with web-search context"
    )
    ask.add_argument("query")
    ask.add_argument("--count", type=int, default=5)
    ask.add_argument("--no-search", action="store_true",
                     help="skip the search step, ask the model directly")
    serve = sub.add_parser(
        "serve",
        help="OpenAI-compatible /v1/chat/completions endpoint over the "
             "torch_local serving stack (model via the root --model flag: "
             "fei --model NAME serve)",
    )
    serve.add_argument("--host", default=None)
    serve.add_argument("--port", type=int, default=None)
    serve.add_argument("--api-key", default=None)
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    setup_logging(level=args.log_level)
    if args.command == "history":
        return handle_history_command(args)
    if args.command == "mcp":
        return handle_mcp_command(args)
    if args.command == "search":
        return handle_search_command(args)
    if args.command == "ask":
        return handle_ask_command(args)
    if args.command == "serve":
        # thin passthrough: server.py owns the flag defaults
        from fei_tpu_torch.ui.server import main as serve_main

        serve_argv = []
        if args.host:
            serve_argv += ["--host", args.host]
        if args.port is not None:
            serve_argv += ["--port", str(args.port)]
        if args.model:
            serve_argv += ["--model", args.model]
        if args.api_key:
            serve_argv += ["--api-key", args.api_key]
        return serve_main(serve_argv)
    history = History()
    try:
        assistant = build_assistant(args)
    except Exception as exc:  # noqa: BLE001 — startup errors must be readable
        print(f"error: {exc}", file=sys.stderr)
        return 2
    try:
        if args.message:
            return process_single_message(assistant, args.message, history)
        if args.task:
            return process_continuous_task(
                assistant, args.task, args.max_iterations, history
            )
        return chat_loop(assistant, history)
    finally:
        if getattr(args, "stats", False):
            print_stats(assistant)


def print_stats(assistant=None) -> None:
    """Span timings + histograms + counters + token usage to stderr
    (observability the reference lacks entirely — SURVEY §5 'Tracing/
    profiling: none'). Rendering is shared with the TUI's /metrics command
    (obs/render.py) so both UIs show the same table."""
    from fei_tpu_torch.obs.render import snapshot_lines
    from fei_tpu_torch.utils.metrics import METRICS

    print("\n-- stats ----------------------------------------", file=sys.stderr)
    if assistant is not None and getattr(assistant, "last_usage", None):
        u = assistant.last_usage
        print(f"tokens: prompt={u.get('prompt_tokens', 0)} "
              f"completion={u.get('completion_tokens', 0)}", file=sys.stderr)
    for line in snapshot_lines(METRICS.snapshot()):
        print(line, file=sys.stderr)
