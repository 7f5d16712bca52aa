"""User-facing surfaces of the port: the OpenAI-compatible server. The CLI
and the TUI are roadmap module C6."""
