"""Model FLOPs of the traced training steps over the traced window, as a
share of the bf16 peak."""
from bench.core.readers import train_mfu as read  # noqa: F401
