"""Device ms a tick in the engine's decode steps (chat traffic)."""
from bench.core.engine_spans import decode_ms as read  # noqa: F401
