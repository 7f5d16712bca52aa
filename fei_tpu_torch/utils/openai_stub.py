"""Loopback OpenAI-compatible ``/chat/completions`` stub server.

One implementation shared by the client-path benchmark (bench.py remote
suite) and the RemoteProvider tests, so the canned protocol cannot drift
between what the bench measures and what the tests pin. Also handy for
driving the agent stack against a fake remote endpoint in demos.

A copy of ``fei_tpu/utils/openai_stub.py`` that imports only the port.
"""

from __future__ import annotations

import http.server
import json
import threading
from typing import Callable


def serve_openai_stub(
    responder: Callable[[dict], tuple[dict, dict]] | None = None,
    content: str = "stub response",
    completion_tokens: int = 8,
):
    """Start a daemon-threaded loopback stub. Returns (server, base_url).

    ``responder(payload) -> (message_dict, usage_dict)`` customizes the
    reply per request; the default returns ``content`` with the given
    usage. The last request body is kept at ``server.last_payload``.
    Callers should ``server.shutdown()`` when done.
    """

    def default_responder(payload: dict) -> tuple[dict, dict]:
        return (
            {"role": "assistant", "content": content},
            {"prompt_tokens": 64, "completion_tokens": completion_tokens,
             "total_tokens": 64 + completion_tokens},
        )

    respond = responder or default_responder

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            payload = json.loads(raw) if raw else {}
            self.server.last_payload = payload  # type: ignore[attr-defined]
            message, usage = respond(payload)
            body = json.dumps({
                "choices": [{"message": message, "finish_reason": "stop"}],
                "usage": usage,
            }).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # silence request spam
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    server.last_payload = {}  # type: ignore[attr-defined]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}/v1"
