"""Host ms a tick in the engine's scheduling: admission, the prefill's
input fill and the bookkeeping after each step (chat traffic)."""
from bench.core.engine_spans import sched_ms as read  # noqa: F401
