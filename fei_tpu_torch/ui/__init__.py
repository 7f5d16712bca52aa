"""User-facing surfaces of the port: the agent CLI (``cli.py``) and the
OpenAI-compatible server (``server.py``). The Textual TUI is a later
slice."""
