"""The traced window over the engine steps in it (offline traffic)."""
from bench.core.readers import tick_ms as read  # noqa: F401
