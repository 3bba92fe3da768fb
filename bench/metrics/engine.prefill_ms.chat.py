"""Device ms a tick in the engine's prefill chunks (chat traffic)."""
from bench.core.engine_spans import prefill_ms as read  # noqa: F401
