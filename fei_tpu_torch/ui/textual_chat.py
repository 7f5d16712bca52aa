"""Full-screen TUI chat (reference: fei/ui/textual_chat.py:231-1070).

Same capability contract as the reference's Textual app — message panels,
slash-command autocomplete, the full ``/mem`` memory-command suite, async
assistant calls with a live streaming panel — built on prompt_toolkit's
full-screen Application + rich rendering (both in the base image; Textual is
not, and a TUI must not drag in new deps per the build constraints).

Key design points:
- The chat log is a list of ChatMessage records rendered through rich
  (Markdown inside Panels) into ANSI text that prompt_toolkit displays; a
  render cache keeps scrolling cheap.
- Assistant calls run as asyncio tasks on prompt_toolkit's own event loop;
  the decoder's on_text stream appends to a live "typing" message and
  invalidates the app, so tokens appear as they decode (the reference renders
  only whole messages — streaming is the north-star addition).
- ``/mem`` commands dispatch to MemoryToolHandlers directly (same layer the
  reference TUI calls, textual_chat.py:557-970), with the Memdir server
  auto-started on first use via the connector.

A copy of ``fei_tpu/ui/textual_chat.py`` that imports only the port.
"""

from __future__ import annotations

import argparse
import asyncio
import io
import json
import shlex
from dataclasses import dataclass, field

from fei_tpu_torch.utils.logging import get_logger, setup_logging

log = get_logger("ui.textual_chat")

MEM_COMMANDS = {
    "help": "show /mem usage",
    "list": "[folder] [status] — list memories",
    "search": "<query> — search memories (memdir query language)",
    "view": "<id> — show one memory with content",
    "save": "<content...> [#tag1,tag2] [subject=...] — save a memory",
    "tag": "<tag> — search by tag",
    "delete": "<id> [--hard] — trash (or purge) a memory",
    "server": "start|stop|status — manage the memdir server",
}


@dataclass
class ChatMessage:
    """One chat panel (reference ChatMessage textual_chat.py:48-92)."""

    role: str  # 'user' | 'assistant' | 'system' | 'memory'
    content: str
    live: bool = False  # still streaming

    _cache: tuple[str, str] | None = field(default=None, repr=False)

    def render_ansi(self, width: int) -> str:
        key = (self.content, width)
        if self._cache and self._cache[0] == key:
            return self._cache[1]
        try:
            from rich.console import Console
            from rich.markdown import Markdown
            from rich.panel import Panel

            styles = {
                "user": ("bold cyan", "you"),
                "assistant": ("bold green", "fei"),
                "memory": ("bold magenta", "mem"),
                "system": ("bold yellow", "sys"),
            }
            style, title = styles.get(self.role, ("white", self.role))
            body = Markdown(self.content) if self.role == "assistant" else self.content
            buf = io.StringIO()
            console = Console(file=buf, force_terminal=True, width=max(20, width))
            console.print(Panel(body, title=title, border_style=style, expand=True))
            out = buf.getvalue()
        except Exception:  # rendering must never kill the UI
            out = f"[{self.role}] {self.content}\n"
        self._cache = (key, out)
        return out


class MemCommandCompleter:
    """Slash-command completion (reference MemoryCommandSuggester :119-198).

    prompt_toolkit Completer duck-type: yields completions for '/mem <sub>'.
    """

    def get_completions(self, document, complete_event):
        from prompt_toolkit.completion import Completion

        text = document.text_before_cursor
        if not text.startswith("/"):
            return
        if " " not in text:
            for cand in ("/mem", "/metrics", "/clear", "/quit", "/help"):
                if cand.startswith(text):
                    yield Completion(cand, start_position=-len(text))
            return
        head, _, rest = text.partition(" ")
        if head != "/mem" or " " in rest.strip():
            return
        for sub in MEM_COMMANDS:
            if sub.startswith(rest):
                yield Completion(sub, start_position=-len(rest))


class FeiChatApp:
    """The TUI application shell.

    Headless-testable: all state and command dispatch live on this object;
    ``run()`` is the only method that needs a terminal.
    """

    def __init__(self, assistant=None, memory_handlers=None, width: int = 100):
        self.assistant = assistant
        self._memory = memory_handlers  # lazy MemoryToolHandlers
        self.messages: list[ChatMessage] = [
            ChatMessage(
                "system",
                "fei_tpu chat — /mem for memory commands, /help for help, "
                "Ctrl-C or /quit to exit.",
            )
        ]
        self.width = width
        self._busy = False
        self._app = None

    # ---------------------------------------------------------------- state

    def add_message(self, role: str, content: str, live: bool = False) -> ChatMessage:
        msg = ChatMessage(role, content, live=live)
        self.messages.append(msg)
        self.invalidate()
        return msg

    def invalidate(self) -> None:
        if self._app is not None:
            self._app.invalidate()

    def render_log(self) -> str:
        return "".join(m.render_ansi(self.width) for m in self.messages)

    @property
    def memory(self):
        if self._memory is None:
            from fei_tpu_torch.tools.memory_tools import MemoryToolHandlers

            self._memory = MemoryToolHandlers()
        return self._memory

    # ------------------------------------------------------------- commands

    async def handle_user_message(self, line: str) -> None:
        """Dispatch one submitted line (reference :535-555)."""
        line = line.strip()
        if not line:
            return
        if line in ("/quit", "/exit"):
            self.exit()
            return
        if line == "/clear":
            if self.assistant is not None:
                self.assistant.reset()
            self.messages = self.messages[:1]
            self.invalidate()
            return
        if line == "/help":
            self.add_message("system", self._help_text())
            return
        if line == "/metrics":
            # live counters/histograms, same table the CLI's --stats prints
            from fei_tpu_torch.obs.render import snapshot_lines
            from fei_tpu_torch.utils.metrics import METRICS

            self.add_message(
                "system", "\n".join(snapshot_lines(METRICS.snapshot()))
            )
            return
        if line == "/mem" or line.startswith("/mem "):
            self.add_message("user", line)
            out = self.handle_memory_command(line[len("/mem"):].strip())
            self.add_message("memory", out)
            return
        self.add_message("user", line)
        await self._process_with_assistant(line)

    def _help_text(self) -> str:
        rows = "\n".join(f"  /mem {k:7s} {v}" for k, v in MEM_COMMANDS.items())
        return (
            "commands:\n  /clear    reset the conversation\n"
            "  /metrics  live engine/agent metrics snapshot\n"
            "  /quit     exit\n" + rows
        )

    def handle_memory_command(self, cmdline: str) -> str:
        """The /mem suite (reference handle_memory_command :557-970).

        Returns display text; never raises (errors render as text).
        """
        try:
            parts = shlex.split(cmdline) if cmdline else []
        except ValueError as exc:
            return f"parse error: {exc}"
        if not parts or parts[0] == "help":
            return self._help_text()
        sub, args = parts[0], parts[1:]
        h = self.memory
        try:
            if sub == "list":
                folder = args[0] if args else ""
                status = args[1] if len(args) > 1 else "new"
                out = h.memory_list(folder=folder, status=status)
                if "error" in out:
                    return f"error: {out['error']}"
                lines = [
                    f"{m.get('id', '?'):34s} {m.get('headers', {}).get('Subject', '')[:50]}"
                    for m in out.get("memories", [])
                ]
                return f"{out.get('count', 0)} memories\n" + "\n".join(lines)
            if sub == "search":
                if not args:
                    return "usage: /mem search <query>"
                out = h.memory_search(" ".join(args))
                if "error" in out:
                    return f"error: {out['error']}"
                hits = out.get("results", out.get("memories", []))
                return json.dumps(hits, indent=2, default=str)[:4000]
            if sub == "view":
                if not args:
                    return "usage: /mem view <id>"
                out = h.memory_view(args[0])
                return json.dumps(out, indent=2, default=str)[:4000]
            if sub == "save":
                if not args:
                    return "usage: /mem save <content...> [#tags] [subject=...]"
                tags, subject, words = None, None, []
                for w in args:
                    if w.startswith("#"):
                        tags = w.lstrip("#")
                    elif w.startswith("subject="):
                        subject = w[len("subject="):]
                    else:
                        words.append(w)
                out = h.memory_create(
                    " ".join(words), subject=subject, tags=tags
                )
                if "error" in out:
                    return f"error: {out['error']}"
                return f"saved: {out.get('created')}"
            if sub == "tag":
                if not args:
                    return "usage: /mem tag <tag>"
                out = h.memory_search_by_tag(args[0])
                if "error" in out:
                    return f"error: {out['error']}"
                hits = out.get("results", out.get("memories", []))
                return json.dumps(hits, indent=2, default=str)[:4000]
            if sub == "delete":
                if not args:
                    return "usage: /mem delete <id> [--hard]"
                out = h.memory_delete(args[0], hard="--hard" in args)
                return json.dumps(out, default=str)
            if sub == "server":
                action = args[0] if args else "status"
                if action == "start":
                    return json.dumps(h.memory_server_start())
                if action == "stop":
                    return json.dumps(h.memory_server_stop())
                return json.dumps(h.memory_server_status(), indent=2, default=str)
        except Exception as exc:  # noqa: BLE001 — UI must survive anything
            return f"error: {exc}"
        return f"unknown /mem subcommand: {sub!r}\n" + self._help_text()

    # ------------------------------------------------------ assistant calls

    async def _process_with_assistant(self, line: str) -> None:
        """Run the assistant with live token streaming (reference :1002-1031)."""
        if self.assistant is None:
            self.add_message("system", "no assistant configured")
            return
        if self._busy:
            self.add_message("system", "still working on the previous message…")
            return
        self._busy = True
        live = self.add_message("assistant", "", live=True)
        loop = asyncio.get_running_loop()

        def on_text(delta: str) -> None:
            # called from the decode thread: hop to the UI loop
            def apply():
                live.content += delta
                live._cache = None
                self.invalidate()

            loop.call_soon_threadsafe(apply)

        prev = self.assistant.on_text
        self.assistant.on_text = on_text
        try:
            response = await self.assistant.chat(line)
            # let queued call_soon_threadsafe deltas land before deciding
            # whether streaming already showed this response
            await asyncio.sleep(0)
            if response and response.strip() and not live.content.strip():
                live.content = response
        except Exception as exc:  # noqa: BLE001
            live.content = f"error: {exc}"
        finally:
            self.assistant.on_text = prev
            live.live = False
            live._cache = None
            self._busy = False
            self.invalidate()

    # ------------------------------------------------------------------ UI

    def _build_app(self):
        from prompt_toolkit.application import Application
        from prompt_toolkit.formatted_text import ANSI
        from prompt_toolkit.key_binding import KeyBindings
        from prompt_toolkit.layout import (
            HSplit,
            Layout,
            Window,
        )
        from prompt_toolkit.layout.controls import FormattedTextControl
        from prompt_toolkit.widgets import TextArea

        kb = KeyBindings()

        @kb.add("c-c")
        @kb.add("c-q")
        def _(event):
            event.app.exit()

        log_control = FormattedTextControl(
            lambda: ANSI(self.render_log()), focusable=False
        )
        log_window = Window(
            log_control, wrap_lines=False, always_hide_cursor=True,
            allow_scroll_beyond_bottom=False,
        )

        input_area = TextArea(
            height=2, prompt="you> ", multiline=False,
            completer=MemCommandCompleter(),
        )

        def accept(buff):
            text = buff.text
            buff.text = ""
            asyncio.get_event_loop().create_task(self.handle_user_message(text))
            return False  # keep the buffer

        input_area.accept_handler = accept

        status = Window(
            FormattedTextControl(
                lambda: " fei_tpu — Ctrl-C quit | /mem memory | /help"
                + ("  [working…]" if self._busy else "")
            ),
            height=1, style="reverse",
        )

        root = HSplit([log_window, status, input_area])
        self._app = Application(
            layout=Layout(root, focused_element=input_area),
            key_bindings=kb,
            full_screen=True,
            mouse_support=True,
        )
        return self._app

    def exit(self) -> None:
        if self._app is not None:
            self._app.exit()

    def run(self) -> None:
        self._build_app().run()


def build_assistant(args):
    """Same assistant wiring as the CLI, minus stdout streaming (the TUI
    installs its own on_text per message)."""
    from fei_tpu_torch.agent import Assistant
    from fei_tpu_torch.tools import ToolRegistry, create_code_tools
    from fei_tpu_torch.tools.memory_tools import create_memory_tools

    registry = ToolRegistry()
    create_code_tools(registry)
    try:
        create_memory_tools(registry)
    except Exception as exc:  # noqa: BLE001
        log.warning("memory tools unavailable: %s", exc)
    return Assistant(
        provider=args.provider,
        model=args.model,
        tool_registry=registry,
        max_tokens=args.max_tokens,
    )


def parse_args(argv):
    p = argparse.ArgumentParser(prog="fei --textual", description="fei_tpu TUI chat")
    p.add_argument("--provider", default=None)
    p.add_argument("--model", default=None)
    p.add_argument("--max-tokens", type=int, default=4000)
    p.add_argument("--log-level", default=None)
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv or [])
    setup_logging(level=args.log_level)
    try:
        assistant = build_assistant(args)
    except Exception as exc:  # noqa: BLE001
        print(f"error: {exc}")
        return 2
    FeiChatApp(assistant=assistant).run()
    return 0
