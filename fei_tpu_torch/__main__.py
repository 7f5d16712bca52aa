"""``python -m fei_tpu_torch`` — the agent CLI over the PyTorch engine
(counterpart of fei_tpu/__main__.py).

- ``python -m fei_tpu_torch --message "..."`` runs one agent turn (the
  assistant, the ``torch_local`` provider on the local GPU, tool calls
  under the grammar, the code tools), ``--task "..."`` the continuous task
  mode, and no argument the interactive chat (ui/cli.py).
- ``python -m fei_tpu_torch serve [--host H] [--port P] [--model NAME]
  [--api-key KEY]`` starts the OpenAI-compatible server (ui/server.py).
- ``--textual`` starts the full-screen chat (ui/textual_chat.py) with the
  code and memory tools.
"""

from __future__ import annotations

import sys


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["serve"]:
        from fei_tpu_torch.ui.server import main as serve_main

        return serve_main(argv[1:])
    if "--textual" in argv:
        argv.remove("--textual")
        from fei_tpu_torch.ui.textual_chat import main as textual_main

        return textual_main(argv)
    from fei_tpu_torch.ui.cli import main as cli_main

    return cli_main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
