"""The share of the traced window with nothing on the device (offline)."""
from bench.core.readers import idle_share as read  # noqa: F401
