"""Running a cell in-process at the reduced size, with the check for a
card skipped (``reduced``) and the check for loaded JAX modules left to
the driver's own processes (a test worker may have loaded them)."""
from bench.core import harness


def run(cell, monkeypatch, seed=3_000_000_021, seconds=1.0, trace=False,
        root=None):
    monkeypatch.setattr(harness, "BANNED", ())
    kw = {} if root is None else {"root": root}
    code, result = harness.run_cell(cell, seed, seconds, trace, reduced=True,
                                    **kw)
    assert code == 0
    return result
