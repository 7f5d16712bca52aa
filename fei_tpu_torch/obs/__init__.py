"""Observability of the port. Only ``render.py`` (the CLI's metrics table)
is ported so far; the metrics themselves live in ``utils/metrics.py``."""
