"""fei_tpu_torch against fei_tpu: the scenarios of tests/test_textual_chat.py run on the port's copy, then the
cross-package checks at the end of this file.

TUI smoke tests (reference test_textual.py:1-68): construct the app,
drive message/command dispatch headlessly, verify graceful degradation when
the memdir server is unavailable."""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import asyncio

import pytest

from fei_tpu_torch.ui.textual_chat import (
    ChatMessage,
    FeiChatApp,
    MemCommandCompleter,
    MEM_COMMANDS,
)


class FakeHandlers:
    """Stands in for MemoryToolHandlers without a server."""

    def memory_list(self, folder="", status="new", with_content=False):
        return {"memories": [{"id": "m1", "headers": {"Subject": "hello"}}], "count": 1}

    def memory_search(self, query, folder=None, with_content=False, limit=None):
        return {"results": [{"id": "m1", "q": query}]}

    def memory_search_by_tag(self, tag, limit=None):
        return {"results": [{"id": "m1", "tag": tag}]}

    def memory_view(self, memory_id, folder=None):
        return {"id": memory_id, "content": "body"}

    def memory_create(self, content, subject=None, tags=None, folder="", flags=""):
        self.last = dict(content=content, subject=subject, tags=tags)
        return {"created": "new-id"}

    def memory_delete(self, memory_id, hard=False):
        return {"deleted": True, "memory_id": memory_id, "hard": hard}

    def memory_server_status(self):
        return {"running": False}

    def memory_server_start(self):
        return {"running": True}

    def memory_server_stop(self):
        return {"stopped": True}


class EchoAssistant:
    on_text = None

    def __init__(self):
        self.resets = 0

    async def chat(self, message, system_prompt=None):
        if self.on_text:
            self.on_text("echo: ")
            self.on_text(message)
        return f"echo: {message}"

    def reset(self):
        self.resets += 1


@pytest.fixture()
def app():
    return FeiChatApp(assistant=EchoAssistant(), memory_handlers=FakeHandlers())


class TestChatMessage:
    def test_render_ansi_caches(self):
        m = ChatMessage("assistant", "**hi**")
        first = m.render_ansi(60)
        assert "hi" in first
        assert m.render_ansi(60) is first  # cache hit

    def test_render_never_raises(self):
        m = ChatMessage("weird-role", "x" * 10)
        assert "x" in m.render_ansi(5)


class TestMemCommands:
    def test_help(self, app):
        out = app.handle_memory_command("help")
        for sub in MEM_COMMANDS:
            assert sub in out

    def test_list(self, app):
        out = app.handle_memory_command("list")
        assert "1 memories" in out and "m1" in out

    def test_search_and_tag(self, app):
        assert "m1" in app.handle_memory_command("search urgent stuff")
        assert "m1" in app.handle_memory_command("tag python")

    def test_save_parses_tags_and_subject(self, app):
        out = app.handle_memory_command("save remember this #a,b subject=Note")
        assert "new-id" in out
        assert app.memory.last == dict(
            content="remember this", subject="Note", tags="a,b"
        )

    def test_view_delete_server(self, app):
        assert "body" in app.handle_memory_command("view m1")
        assert "deleted" in app.handle_memory_command("delete m1 --hard")
        assert "running" in app.handle_memory_command("server status")

    def test_unknown_subcommand(self, app):
        assert "unknown /mem subcommand" in app.handle_memory_command("frobnicate")

    def test_graceful_when_server_down(self):
        """Real handlers with an unreachable server must render an error,
        not raise (reference test_textual.py:34-47)."""
        from fei_tpu_torch.tools.memdir_connector import MemdirConnector
        from fei_tpu_torch.tools.memory_tools import MemoryToolHandlers

        conn = MemdirConnector(
            server_url="http://127.0.0.1:1", api_key="x", auto_start=False
        )
        app = FeiChatApp(memory_handlers=MemoryToolHandlers(conn))
        out = app.handle_memory_command("list")
        assert "error" in out.lower()


class TestDispatch:
    def test_user_message_streams(self, app):
        asyncio.run(app.handle_user_message("hello tui"))
        roles = [m.role for m in app.messages]
        assert roles[-2:] == ["user", "assistant"]
        assert app.messages[-1].content == "echo: hello tui"
        assert not app.messages[-1].live

    def test_clear_resets_assistant(self, app):
        asyncio.run(app.handle_user_message("hi"))
        asyncio.run(app.handle_user_message("/clear"))
        assert len(app.messages) == 1
        assert app.assistant.resets == 1

    def test_mem_dispatch(self, app):
        asyncio.run(app.handle_user_message("/mem list"))
        assert app.messages[-1].role == "memory"

    def test_metrics_command(self, app):
        from fei_tpu_torch.utils.metrics import METRICS

        METRICS.incr("tool.calls")
        asyncio.run(app.handle_user_message("/metrics"))
        msg = app.messages[-1]
        assert msg.role == "system"
        assert "tool.calls" in msg.content
        assert "/metrics" in app._help_text()

    def test_completer(self):
        from prompt_toolkit.document import Document

        comp = MemCommandCompleter()
        got = [
            c.text for c in comp.get_completions(Document("/mem se"), None)
        ]
        assert "search" in got and "server" in got
        got = [c.text for c in comp.get_completions(Document("/m"), None)]
        assert "/mem" in got
        got = [c.text for c in comp.get_completions(Document("/me"), None)]
        assert "/metrics" in got and "/mem" in got

    def test_build_app_layout(self, app):
        built = app._build_app()
        assert built is not None and app._app is built


# ----------------------------------------------------- across the packages

@pytest.mark.parametrize("line", [
    "/help", "/mem help", "/mem list", "/mem search urgent stuff", "/mem tag python",
    "/mem save remember this #a,b subject=Note", "/mem view m1",
    "/mem delete m1 --hard", "/mem server status", "/mem frobnicate", "hello tui",
])
def test_dispatch_equals_the_reference(line):
    """The same submitted line gives the reference app's messages, and
    they render to the same ANSI panels."""
    from fei_tpu.ui.textual_chat import FeiChatApp as RefApp

    ours = FeiChatApp(assistant=EchoAssistant(), memory_handlers=FakeHandlers())
    theirs = RefApp(assistant=EchoAssistant(), memory_handlers=FakeHandlers())
    for app in (ours, theirs):
        asyncio.run(app.handle_user_message(line))
    assert ([(m.role, m.content, m.live) for m in ours.messages]
            == [(m.role, m.content, m.live) for m in theirs.messages])
    assert ours.render_log() == theirs.render_log()


def test_tui_registry_equals_the_reference():
    """``--textual``'s assistant holds the reference's code and memory tools."""
    import argparse

    from fei_tpu.ui.textual_chat import build_assistant as ref_build
    from fei_tpu_torch.ui.textual_chat import build_assistant

    args = argparse.Namespace(provider="mock", model=None, max_tokens=64)
    ours, theirs = build_assistant(args), ref_build(args)
    assert ours.tool_manager.get_tools() == theirs.tool_manager.get_tools()
    assert len(ours.tool_manager.get_tools()) == 23
