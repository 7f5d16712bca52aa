"""``python -m fei_tpu_torch serve [--host --port --model --api-key]``.

Starts the OpenAI-compatible server over the PyTorch engine on the GPU
(``[torch_local]`` config section / FEI_TPU_TORCH_LOCAL_* env). The
``--message`` agent loop, the CLI and the TUI are not ported yet
(roadmap module C6).
"""

from __future__ import annotations

import sys


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] != "serve":
        print(
            "usage: python -m fei_tpu_torch serve [--host H] [--port P] "
            "[--model NAME] [--api-key KEY]\n"
            "(the --message agent loop is not ported yet)",
            file=sys.stderr,
        )
        return 2
    from fei_tpu_torch.ui.server import main as serve_main

    return serve_main(argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
