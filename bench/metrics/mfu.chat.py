"""Model FLOPs of the prompt and generated tokens of the traced engine
steps over the traced window, as a share of the bf16 peak (chat)."""
from bench.core.readers import serve_mfu as read  # noqa: F401
