"""The fused router's and the counting sort's share of their roofline."""
from bench.core.readers import routing_roofline as read  # noqa: F401
