"""The share of the traced training window with nothing on the device."""
from bench.core.readers import idle_share as read  # noqa: F401
