"""PTY wrapper with prompt auto-confirmation.

Capability parity with the upstream fei project's Node wrapper script (a
node-pty script that runs a CLI under a pseudo-terminal and auto-answers its
interactive confirmation prompts) — rebuilt on the stdlib ``pty`` module so
it needs no Node runtime and wraps any command.

Use as a library::

    from fei_tpu_torch.tools.pty_wrapper import PtyWrapper
    w = PtyWrapper(["some-cli", "--flag"],
                   responses={r"\\[y/N\\]": "y\\n", r"❯ Yes": "\\r"})
    exit_code = w.run()

or from the command line::

    python -m fei_tpu_torch.tools.pty_wrapper --respond '\\[y/N\\]=y' -- some-cli --flag

A copy of ``fei_tpu/tools/pty_wrapper.py`` that imports only the port.
"""

from __future__ import annotations

import argparse
import os
import pty
import re
import select
import sys
import time

from fei_tpu_torch.utils.logging import get_logger

log = get_logger("tools.pty_wrapper")

# Defaults mirror the upstream wrapper script's auto-confirm behavior (it
# answers highlighted "❯ Yes" menus and y/N prompts affirmatively).
DEFAULT_RESPONSES = {
    r"❯\s*Yes": "\r",
    r"\[y/N\]|\[Y/n\]|\(y/n\)": "y\n",
    r"Press Enter to continue": "\n",
}


class PtyWrapper:
    def __init__(
        self,
        command: list[str],
        responses: dict[str, str] | None = None,
        echo: bool = True,
        timeout: float | None = None,
        response_cooldown: float = 0.5,
    ):
        if not command:
            raise ValueError("command must be non-empty")
        self.command = command
        self.responses = {
            re.compile(pat): reply
            for pat, reply in (responses or DEFAULT_RESPONSES).items()
        }
        self.echo = echo
        self.timeout = timeout
        self.response_cooldown = response_cooldown
        self.transcript: list[str] = []
        self.timed_out = False  # set when the timeout killed the child

    def run(self) -> int:
        """Run the command under a pty until it exits. Returns the exit code."""
        pid, master = pty.fork()
        if pid == 0:  # child
            try:
                os.execvp(self.command[0], self.command)
            except OSError as exc:
                os.write(2, f"exec failed: {exc}\n".encode())
                os._exit(127)

        start = time.monotonic()
        window = ""  # rolling tail of output the patterns match against
        last_response: tuple[str, float] | None = None
        reaped_status: int | None = None  # exit status if WNOHANG reaps first
        try:
            while True:
                if self.timeout and time.monotonic() - start > self.timeout:
                    log.warning("pty wrapper timeout; killing %s", self.command[0])
                    self.timed_out = True
                    os.kill(pid, 9)
                    break
                ready, _, _ = select.select([master], [], [], 0.25)
                if not ready:
                    done_pid, status = os.waitpid(pid, os.WNOHANG)
                    if done_pid != 0:
                        reaped_status = status  # don't lose the exit code
                        break
                    continue
                try:
                    chunk = os.read(master, 4096)
                except OSError:  # child closed the pty
                    break
                if not chunk:
                    break
                text = chunk.decode("utf-8", errors="replace")
                self.transcript.append(text)
                if self.echo:
                    sys.stdout.write(text)
                    sys.stdout.flush()
                window = (window + text)[-2048:]
                for rx, reply in self.responses.items():
                    if rx.search(window):
                        now = time.monotonic()
                        # don't machine-gun the same prompt: one reply per
                        # pattern per cooldown window
                        if (
                            last_response
                            and last_response[0] == rx.pattern
                            and now - last_response[1] < self.response_cooldown
                        ):
                            continue
                        log.info("auto-responding to %r", rx.pattern)
                        os.write(master, reply.encode())
                        last_response = (rx.pattern, now)
                        window = ""
                        break
        finally:
            os.close(master)
        if reaped_status is None:
            try:
                _, reaped_status = os.waitpid(pid, 0)
            except ChildProcessError:
                return 0
        if os.WIFEXITED(reaped_status):
            return os.WEXITSTATUS(reaped_status)
        return 128 + os.WTERMSIG(reaped_status)

    @property
    def output(self) -> str:
        return "".join(self.transcript)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m fei_tpu_torch.tools.pty_wrapper",
        description="run a command under a pty, auto-answering prompts",
    )
    p.add_argument(
        "--respond", action="append", default=[],
        metavar="REGEX=REPLY",
        help="add a pattern->reply rule (repeatable); replaces the defaults",
    )
    p.add_argument("--timeout", type=float, default=None)
    p.add_argument("--quiet", action="store_true", help="don't echo output")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="-- command and args to wrap")
    args = p.parse_args(argv)
    cmd = [c for c in args.command if c != "--"]
    if not cmd:
        p.error("no command given (use: ... -- cmd args)")
    responses = None
    if args.respond:
        responses = {}
        for rule in args.respond:
            pat, _, reply = rule.partition("=")
            responses[pat] = reply.encode().decode("unicode_escape")
    w = PtyWrapper(cmd, responses=responses, echo=not args.quiet,
                   timeout=args.timeout)
    return w.run()


if __name__ == "__main__":
    raise SystemExit(main())
