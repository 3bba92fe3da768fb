"""Static analysis of the port: repo, kernel and collective lint.

The port of ``repro.analysis``.  Three passes, one command
(``python -m repro_torch.launch.analyze``):

* :mod:`repro_torch.analysis.repo_lint` (``"repo"``) — AST rules over
  ``src/repro_torch``: the options registries against the config
  dataclasses both ways, every ``extern "C"`` function of
  ``kernels/csrc/*.cu`` bound in ``_build.SIGNATURES``, called from a
  wrapper in ``kernels/ops.py`` and twinned by a plain version in
  ``kernels/ref.py``, and no ``torch.distributed`` collective outside
  ``sharding/comm.py``.
* :mod:`repro_torch.analysis.kernel_lint` (``"kernel"``) — what the card's
  toolchain reports of each kernel function (``ptxas -v``: registers,
  spills, static shared memory) and what each launch asks for (threads
  and dynamic shared memory), against sm_90's limits; and, on the source
  text, no float atomic accumulation (its order would depend on block
  scheduling, and resume relies on bit-identical steps).
* :mod:`repro_torch.analysis.trace_lint` (``"trace"``) — records what each
  rank of a gloo mesh actually issues while the entrypoint grid runs
  (both routers, every dispatch backend, ragged and padded wire, the
  train step with and without the sentinel, the serve), and checks that
  every rank issues the same sequence, on axes of the mesh, with int32
  integer operands, and only from ``sharding/comm.py``.

Each pass returns a flat list of :class:`Finding`; a pass never raises
on bad code, so the seeded-bad fixtures of the tests can assert exact rule
hits.  This package imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

__all__ = ["Finding", "format_findings"]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer finding: which pass, which rule, where, and why."""

    pass_name: str                 # "repo" | "kernel" | "trace"
    rule: str                      # stable rule id (kebab-case)
    message: str
    file: Optional[str] = None     # provenance when recoverable
    line: Optional[int] = None

    def format(self) -> str:
        loc = ""
        if self.file:
            loc = f" ({self.file}:{self.line})" if self.line else f" ({self.file})"
        return f"[{self.pass_name}] {self.rule}: {self.message}{loc}"


def format_findings(findings: Sequence[Finding]) -> str:
    """Render a finding list as the per-line report the CLI prints."""
    if not findings:
        return "no findings"
    lines: List[str] = [f.format() for f in findings]
    lines.append(f"{len(findings)} finding(s)")
    return "\n".join(lines)
