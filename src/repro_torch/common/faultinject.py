"""Deterministic fault injection for the hop pipeline.

The port of ``repro.common.faultinject``.  A seeded, config-driven
:class:`FaultPlan` (``MoEConfig.fault_plan``) that the pipeline executor
consults when it builds a hop and injects faults from deterministically,
so that the fault matrix runs the same fault on every rank and the tests
can compute the exact ``fault_events`` / ``wire_faults`` / ``drop_frac``
they expect from the selectors below.

**Determinism.**  Every injection site is chosen on the host from
``random.Random`` seeded with ``repr((seed, kind, level) + shape)``: a
string, which Python hashes with SHA-512, so a plan is a pure function of
its spec and the static shapes it meets, the same in every process.  (The
JAX package seeds with the tuple itself, which Python 3.11 and later
refuse; its tests install this derivation in its place.)  Sites are Python
ints, and no injector reads the host, so a faulted step can be captured in
a CUDA graph.

**Plan spec.**  ``kind[@seed][:hop]`` where ``kind`` is one of

* ``counts``  — overwrite seeded entries of the exchanged ``(P, nl)`` count
  grid with a negative value; the sanitizer quarantines the source.
* ``nanrows`` — NaN rows of the received slab (or of the local or padded
  dispatch buffer); with the wire checked, the first rows of one seeded
  source's region of the received wire slab.
* ``dropseg`` — zero one seeded source rank's row of the count grid: a
  valid grid, an exact ``1/P`` drop on the hop.
* ``skew``    — every assignment of the hop to one seeded group.
* ``bitflip`` — XOR one bit a lane of one seeded source's region of the
  received wire slab (bit 0 on data rows, bit 8 on parity rows).
* ``inflate`` — add 1 to one seeded entry of the count grid.
* ``dupseg``  — replay source ``v = (w + 1) % P``'s grid row and wire
  region as victim ``w``'s.

``@seed`` defaults to 0, ``:hop`` to ``-1`` (every hop); ``"none"``,
``"off"`` and ``""`` parse to None (no injection).
"""
from __future__ import annotations

import dataclasses
import random
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

FAULT_KINDS = ("counts", "nanrows", "dropseg", "skew", "bitflip", "inflate",
               "dupseg")

# injected magnitudes (static, so that tests can assert exact accounting)
COUNT_POISON = -7          # negative count written by the "counts" kind
N_COUNT_FAULTS = 2         # grid entries poisoned per (device, hop)
N_NAN_ROWS = 3             # slab rows NaN'd per (device, hop)


@dataclass(frozen=True)
class FaultPlan:
    """One parsed fault plan."""
    kind: str
    seed: int = 0
    hop: int = -1            # -1 = every hop

    def targets(self, level: int) -> bool:
        return self.hop in (-1, level)

    @property
    def wants_echo(self) -> bool:
        """The kinds that rewrite the count grid: the believed counts can
        part from what the peers sent, so the reverse hop echoes them."""
        return self.kind in ("counts", "dropseg", "inflate", "dupseg")


def parse_fault_plan(spec: Optional[str]) -> Optional[FaultPlan]:
    """Parse ``kind[@seed][:hop]`` into a :class:`FaultPlan` (or None);
    raises ``ValueError`` on a malformed spec."""
    if spec is None:
        return None
    s = spec.strip()
    if s in ("", "none", "off"):
        return None
    hop = -1
    if ":" in s:
        s, hop_s = s.rsplit(":", 1)
        try:
            hop = int(hop_s)
        except ValueError:
            raise ValueError(f"fault plan {spec!r}: hop {hop_s!r} is not an "
                             f"integer") from None
        if hop < -1:
            raise ValueError(f"fault plan {spec!r}: hop must be >= -1")
    seed = 0
    if "@" in s:
        s, seed_s = s.rsplit("@", 1)
        try:
            seed = int(seed_s)
        except ValueError:
            raise ValueError(f"fault plan {spec!r}: seed {seed_s!r} is not "
                             f"an integer") from None
    if s not in FAULT_KINDS:
        raise ValueError(f"fault plan {spec!r}: unknown kind {s!r}; expected "
                         f"one of {FAULT_KINDS}")
    return FaultPlan(s, seed, hop)


def _rng(fp: FaultPlan, level: int, *shape_tag: int) -> random.Random:
    return random.Random(repr((fp.seed, fp.kind, level) + shape_tag))


# =============================================================================
# Site selection (host ints; shared with the tests' expectations)
# =============================================================================

def count_fault_sites(fp: FaultPlan, level: int, P: int, nl: int
                      ) -> List[Tuple[int, int]]:
    """The (src, group) grid entries the ``counts`` kind poisons."""
    r = _rng(fp, level, P, nl)
    n = min(N_COUNT_FAULTS, P * nl)
    flat = r.sample(range(P * nl), n)
    return [(i // nl, i % nl) for i in sorted(flat)]


def expected_count_events(fp: FaultPlan, level: int, P: int, nl: int) -> int:
    """Sanitizer events one rank reports on this hop (the poisoned
    sites)."""
    return len(count_fault_sites(fp, level, P, nl))


def dropseg_victim(fp: FaultPlan, level: int, P: int) -> int:
    """The source rank whose segments the ``dropseg`` kind suppresses."""
    return _rng(fp, level, P).randrange(P)


def nan_row_sites(fp: FaultPlan, level: int, rows: int) -> List[int]:
    r = _rng(fp, level, rows)
    return sorted(r.sample(range(rows), min(N_NAN_ROWS, rows)))


def expected_nan_rows() -> int:
    return N_NAN_ROWS


def skew_target(fp: FaultPlan, level: int, num_groups: int) -> int:
    return _rng(fp, level, num_groups).randrange(num_groups)


def wire_victim(fp: FaultPlan, level: int, P: int) -> int:
    """The source rank whose received wire region the wire-slab kinds
    (``bitflip``, wire-mode ``nanrows``, ``dupseg``) corrupt."""
    return _rng(fp, level, P).randrange(P)


def inflate_site(fp: FaultPlan, level: int, P: int, nl: int
                 ) -> Tuple[int, int]:
    """The (src, group) count-grid entry the ``inflate`` kind bumps by 1."""
    i = _rng(fp, level, P, nl).randrange(P * nl)
    return (i // nl, i % nl)


def wire_fault_victim(fp: FaultPlan, level: int, P: int, nl: int) -> int:
    """The source rank the checksum layer must flag for ``fp.kind`` on
    this hop."""
    if fp.kind == "inflate":
        return inflate_site(fp, level, P, nl)[0]
    return wire_victim(fp, level, P)


# =============================================================================
# Injectors (out of place; no host reads)
# =============================================================================

def corrupt_len_grid(fp: FaultPlan, level: int, len_grid: torch.Tensor
                     ) -> torch.Tensor:
    """``counts``: poison seeded entries of the exchanged (P, nl) grid."""
    P, nl = len_grid.shape
    out = len_grid.clone()
    for p, g in count_fault_sites(fp, level, P, nl):
        out[p, g] = COUNT_POISON
    return out


def drop_segment(fp: FaultPlan, level: int, len_grid: torch.Tensor
                 ) -> torch.Tensor:
    """``dropseg``: zero the victim source's whole row of the count grid."""
    out = len_grid.clone()
    out[dropseg_victim(fp, level, len_grid.shape[0])] = 0
    return out


def nan_rows(fp: FaultPlan, level: int, rows: torch.Tensor,
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``nanrows``: NaN rows of a (R, ...) float slab.

    With ``valid`` (a boolean (R,) occupancy mask) the first
    :data:`N_NAN_ROWS` occupied rows are hit (a cumsum: padding would be
    gathered away by the combine and never reach the output); without it,
    seeded static rows."""
    if valid is None:
        idx = torch.tensor(nan_row_sites(fp, level, rows.shape[0]),
                           dtype=torch.long, device=rows.device)
        return rows.index_fill(0, idx, float("nan"))
    v = valid.to(torch.int32)
    hit = (torch.cumsum(v, 0) <= N_NAN_ROWS) & (v > 0)
    hit = hit.reshape(hit.shape + (1,) * (rows.dim() - 1))
    return torch.where(hit, torch.full_like(rows, float("nan")), rows)


def inflate_grid(fp: FaultPlan, level: int, len_grid: torch.Tensor
                 ) -> torch.Tensor:
    """``inflate``: bump one seeded entry of the believed (P, nl) grid (a
    still valid grid: only the parity word's length term sees it)."""
    p, g = inflate_site(fp, level, *len_grid.shape)
    out = len_grid.clone()
    out[p, g] += 1
    return out


def dup_grid(fp: FaultPlan, level: int, len_grid: torch.Tensor
             ) -> torch.Tensor:
    """``dupseg``: overwrite victim row ``w`` with row ``v = (w+1) % P``."""
    P = len_grid.shape[0]
    w = wire_victim(fp, level, P)
    out = len_grid.clone()
    out[w] = len_grid[(w + 1) % P]
    return out


def _int_view(wire: torch.Tensor) -> torch.Tensor:
    """A float wire slab's same-width integer view (no gradient)."""
    it = {4: torch.int32, 2: torch.int16}[wire.element_size()]
    return wire.detach().view(it)


def flip_wire(fp: FaultPlan, level: int, wire: torch.Tensor,
              starts: torch.Tensor, data_counts: torch.Tensor,
              nl: int) -> torch.Tensor:
    """``bitflip``: XOR lanes of the victim's received wire region, bit 0
    on its data rows and bit 8 on its parity rows (a uniform flip of bit 0
    would move an L=1 segment's fold and its stored word by the same ±1).
    The flipped rows carry no gradient; the others pass through."""
    v = wire_victim(fp, level, starts.shape[0])
    iw = _int_view(wire)
    r = torch.arange(wire.shape[0], dtype=torch.int32, device=wire.device)
    s, c = starts[v], data_counts[v]
    in_data = (r >= s) & (r < s + c)
    in_par = (r >= s + c) & (r < s + c + nl)
    mask = torch.where(in_data, 1, torch.where(in_par, 256, 0)).to(iw.dtype)
    flipped = (iw ^ mask[:, None]).view(wire.dtype)
    return torch.where((in_data | in_par)[:, None], flipped, wire)


def nan_wire(fp: FaultPlan, level: int, wire: torch.Tensor,
             starts: torch.Tensor, wire_counts: torch.Tensor
             ) -> torch.Tensor:
    """Wire-mode ``nanrows``: NaN the first rows of the victim's region
    (row 0 of a region is a live data row or the first parity row, so the
    checksum must see it)."""
    v = wire_victim(fp, level, starts.shape[0])
    r = torch.arange(wire.shape[0], dtype=torch.int32, device=wire.device)
    n = torch.clamp(wire_counts[v], max=N_NAN_ROWS)
    hit = (r >= starts[v]) & (r < starts[v] + n)
    return torch.where(hit[:, None], torch.full_like(wire, float("nan")),
                       wire)


def copy_wire_region(fp: FaultPlan, level: int, wire: torch.Tensor,
                     starts: torch.Tensor, wire_counts: torch.Tensor
                     ) -> torch.Tensor:
    """``dupseg``: replay ``v = (w+1) % P``'s wire region into victim
    ``w``'s (paired with :func:`dup_grid`: equal believed extents; the
    copied parity row carries ``v``'s source tag)."""
    P = starts.shape[0]
    w = wire_victim(fp, level, P)
    v = (w + 1) % P
    r = torch.arange(wire.shape[0], dtype=torch.int32, device=wire.device)
    off = r - starts[w]
    in_w = (off >= 0) & (off < wire_counts[w])
    src = torch.where(in_w, starts[v] + off, r)
    # jnp.take's fill mode: a row read past the slab is NaN
    past = src >= wire.shape[0]
    out = wire.index_select(0, src.clamp(max=wire.shape[0] - 1).long())
    return torch.where(past[:, None], torch.full_like(out, float("nan")),
                       out)


def apply_skew(fp: FaultPlan, level: int, dec, num_groups: int,
               loss_groups: int):
    """``skew``: the hop's route decision collapsed onto one seeded group,
    both the dispatch targets (``group_ids``) and the router argmax
    (``top1``, so the watchdog sees the storm); gates and probs are left
    as they are."""
    g = skew_target(fp, level, num_groups)
    return dataclasses.replace(
        dec, group_ids=torch.full_like(dec.group_ids, g),
        top1=torch.full_like(dec.top1, g % max(loss_groups, 1)))
