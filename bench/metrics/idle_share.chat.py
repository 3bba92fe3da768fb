"""The share of the traced window with nothing on the device (chat)."""
from bench.core.readers import idle_share as read  # noqa: F401
