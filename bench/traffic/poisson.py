"""Poisson arrivals: the gaps between due times are the quantiles of the
exponential of mean ``1 / rate`` at ``n`` evenly spaced points, so every
seed gets the same gaps (``bench/core/traffic.py`` puts them in order)."""
import numpy as np


def gaps(mix, rate: float, n: int) -> np.ndarray:
    """``n`` gaps in seconds."""
    u = (np.arange(n) + 0.5) / n
    return -np.log1p(-u) / rate
