"""Collective lint: the counterpart of ``repro.analysis.jaxpr_lint``.

Torch has no jaxpr to walk, so this pass records what each rank actually
issues.  It runs the port's entrypoint grid at reduced size on a ``(data
4, model 2)`` mesh of 8 gloo ranks on the CPU (one :class:`RankPool`, one
spawn for the whole grid):

* a training step of the paper's MLM encoder under both routers
  (``smile-3.7b``, ``switch-3.7b``) and every ``dispatch_backend``, the
  dropless one on the ragged and on the padded wire;
* the train step with the sentinel on, and once forced to skip: rank 0
  alone sees a non-finite loss, so that a verdict that were not psum'd
  would send the ranks down different paths;
* the serve (``qwen3-moe-30b-a3b``: a prefill and decode steps).

While a case runs, ``sharding.comm`` records every collective it issues
(:class:`repro_torch.sharding.comm.TraceLog`: op, axes, dtype, shape,
file and line of the caller), and the ``torch.distributed`` collectives
are wrapped to record a call that bypasses ``comm``.  Rules:

* ``rank-divergent-collectives`` — every rank issues the same sequence of
  ops, axes and dtypes (the counterpart of ``cond-collective-mismatch``:
  ranks that issue different collectives hang or mix their data, the
  hazard of the backward's collectives and of the sentinel's gated
  update, whose skip and apply must be the same on every rank).
* ``unknown-axis-name`` — a collective over an axis the mesh lacks.
* ``collective-int-dtype`` — an integer operand that is not int32 (the
  wire contract; a silent int64 doubles the count bytes).
* ``collective-outside-comm`` — a collective not issued from
  ``sharding/comm.py``.

:func:`check_traces` is mesh-free; the seeded-bad fixtures of the tests
drive :func:`run_cases` with their own functions.
"""
from __future__ import annotations

import functools
import os
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis import Finding
from repro_torch.sharding import comm

MESH = ((4, 2), ("data", "model"))
WORLD = 8
GRID_MOE = (4, 2)
INT_OK = {"int32"}
INT_DTYPES = {"int8", "int16", "int32", "int64", "uint8", "uint16",
              "uint32", "uint64"}
# torch.distributed functions that move bytes between ranks
DIST_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
                    "reduce_scatter", "reduce_scatter_tensor",
                    "all_to_all", "all_to_all_single", "broadcast",
                    "barrier", "send", "recv", "isend", "irecv",
                    "batch_isend_irecv", "reduce", "gather", "scatter")
COMM_FILE = os.path.abspath(comm.__file__)
# (backend, ragged wire) of each dispatch case
BACKENDS = (("sort", None), ("dense", None), ("dropless", True),
            ("dropless", False))
CaseFn = Callable[[object], None]


def _moe_case(router: str, backend: str, ragged) -> CaseFn:
    opts = {"dispatch_backend": backend}
    if ragged is not None:
        opts["ragged_a2a"] = ragged
    return functools.partial(_train_case, arch=f"{router}-3.7b",
                             moe_options=opts)


def _train_case(mesh, *, arch="smile-3.7b", moe_options=None,
                sentinel=False, poison_rank=None) -> None:
    from repro_torch.launch.train import train
    from repro_torch.train import step as ST
    verdict = ST.SEN.step_verdict
    if poison_rank is not None:
        def poisoned(loss, grads, sent, axes):
            if mesh.rank == poison_rank:
                loss = torch.full_like(loss, float("nan"))
            return verdict(loss, grads, sent, axes)
        ST.SEN.step_verdict = poisoned
    try:
        train(arch, reduced=True, steps=1, batch=8, seq=16, mesh=mesh,
              moe_options=moe_options, moe_grid=GRID_MOE,
              sentinel=sentinel, log_every=1)
    finally:
        ST.SEN.step_verdict = verdict


def _serve_case(mesh) -> None:
    from repro_torch.launch.serve import serve
    serve("qwen3-moe-30b-a3b", reduced=True, batch=8, prompt_len=8,
          new_tokens=2, moe_grid=GRID_MOE, mesh=mesh)


def grid_cases() -> Dict[str, CaseFn]:
    """The entrypoint grid: name -> ``fn(mesh)``, run on every rank."""
    cases: Dict[str, CaseFn] = {}
    for router in ("smile", "switch"):
        for backend, ragged in BACKENDS:
            wire = "" if ragged is None else ("-ragged" if ragged
                                              else "-padded")
            cases[f"train-{router}-{backend}{wire}"] = _moe_case(
                router, backend, ragged)
    cases["train-smile-sentinel"] = functools.partial(_train_case,
                                                      sentinel=True)
    cases["train-smile-sentinel-skip"] = functools.partial(
        _train_case, sentinel=True, poison_rank=0)
    cases["serve-qwen3-moe"] = _serve_case
    return cases


# ----------------------------------------------------------- the recording
def _axes_of(group) -> Tuple[str, ...]:
    """The mesh axes of a process group (the world's when None)."""
    mesh = comm.bound_mesh()
    if group is None:
        return tuple(mesh.axes)
    for axes, g in mesh.groups.items():
        if g.pg is group:
            return axes
    return ("?",)


def _first_tensor(args, kwargs) -> Optional[torch.Tensor]:
    for a in list(args) + list(kwargs.values()):
        if torch.is_tensor(a):
            return a
        if isinstance(a, (list, tuple)) and a and torch.is_tensor(a[0]):
            return a[0]
    return None


def wrap_dist(log: comm.TraceLog) -> Callable[[], None]:
    """Wrap the ``torch.distributed`` collectives so that a call from
    outside ``sharding/comm.py`` is recorded into ``log`` (as
    ``dist.<name>``); returns the function that undoes it."""
    import sys
    dist = torch.distributed
    saved = {}

    def wrapper(name, fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            frame = sys._getframe(1)
            if os.path.abspath(frame.f_code.co_filename) != COMM_FILE:
                x = _first_tensor(args, kwargs)
                shape = () if x is None else tuple(x.shape)
                log.calls.append(comm.TraceCall(
                    f"dist.{name}", _axes_of(kwargs.get("group")),
                    "" if x is None else str(x.dtype).replace("torch.", ""),
                    shape, f"{os.path.abspath(frame.f_code.co_filename)}:"
                    f"{frame.f_lineno}", shape))
            return fn(*args, **kwargs)
        return call

    for name in DIST_COLLECTIVES:
        fn = getattr(dist, name, None)
        if fn is not None:
            saved[name] = fn
            setattr(dist, name, wrapper(name, fn))

    def undo():
        for name, fn in saved.items():
            setattr(dist, name, fn)
    return undo


def trace_case(fn: CaseFn, mesh) -> Tuple[List[comm.TraceCall],
                                          Optional[str]]:
    """Run ``fn(mesh)`` recording its collectives: ``(calls, error)``,
    the error the traceback's last line where it raised."""
    log = comm.TraceLog()
    undo = wrap_dist(log)
    err = None
    try:
        with comm.tracing(log):
            fn(mesh)
    except Exception:
        err = traceback.format_exc().strip().splitlines()[-1]
    finally:
        undo()
    return log.calls, err


def _rank_task(rank, names: Sequence[str], extra: Optional[dict] = None):
    """On each rank: the mesh (made once a rank), then each case."""
    from repro_torch.launch.mesh import make_mesh
    mesh = rank.state.get("trace_mesh")
    if mesh is None:
        mesh = make_mesh(*MESH, device=rank.device)
        rank.state["trace_mesh"] = mesh
    comm.bind(mesh)
    cases = dict(grid_cases(), **(extra or {}))
    return {n: trace_case(cases[n], mesh) for n in names}


# ---------------------------------------------------------------- the rules
def _sig(c: comm.TraceCall) -> Tuple:
    return (c.op, c.axes, c.dtype)


def check_traces(case: str, traces: Sequence[Sequence[comm.TraceCall]],
                 mesh_axes: Sequence[str]) -> List[Finding]:
    """The four rules over one case's per-rank traces (rank order)."""
    findings: List[Finding] = []
    ref = [_sig(c) for c in traces[0]]
    for r, calls in enumerate(traces[1:], start=1):
        sig = [_sig(c) for c in calls]
        if sig == ref:
            continue
        i = next((j for j, (a, b) in enumerate(zip(ref, sig)) if a != b),
                 min(len(ref), len(sig)))
        mine = calls[i] if i < len(calls) else None
        theirs = traces[0][i] if i < len(traces[0]) else None
        where = (mine or theirs).caller.rsplit(":", 1)
        findings.append(Finding(
            "trace", "rank-divergent-collectives",
            f"{case}: rank {r} issues {len(sig)} collectives and rank 0 "
            f"{len(ref)}; they part at #{i}: rank 0 "
            f"{_sig(theirs) if theirs else 'nothing'}, rank {r} "
            f"{_sig(mine) if mine else 'nothing'}", where[0],
            int(where[1]) if len(where) > 1 and where[1].isdigit() else None))
        break
    seen = set()
    for calls in traces:
        for c in calls:
            file, _, line = c.caller.rpartition(":")
            lineno = int(line) if line.isdigit() else None
            unknown = [a for a in c.axes if a not in mesh_axes]
            key = (c.op, c.axes, c.dtype, c.caller)
            if key in seen:
                continue
            seen.add(key)
            if unknown:
                findings.append(Finding(
                    "trace", "unknown-axis-name",
                    f"{case}: {c.op} over {c.axes}: {unknown} not among "
                    f"the mesh's axes {tuple(mesh_axes)}", file, lineno))
            if c.dtype in INT_DTYPES and c.dtype not in INT_OK:
                findings.append(Finding(
                    "trace", "collective-int-dtype",
                    f"{case}: {c.op} over {c.axes} moves {c.dtype} "
                    f"{list(c.shape)}: integer operands cross the wire as "
                    f"int32", file, lineno))
            if c.op.startswith("dist."):
                findings.append(Finding(
                    "trace", "collective-outside-comm",
                    f"{case}: torch.distributed.{c.op[5:]} over {c.axes} "
                    f"called outside sharding/comm.py", file, lineno))
    return findings


def run_cases(pool, names: Sequence[str], extra: Optional[dict] = None,
              log=None) -> List[Finding]:
    """Run the cases ``names`` (of the grid, or ``extra``: name ->
    ``fn(mesh)``, a module-level function) on ``pool`` and check them.  A
    case that raises on a rank is a finding of its own
    (``trace-case-failed``)."""
    got = pool.run(_rank_task, list(names), extra)
    findings: List[Finding] = []
    for n in names:
        traces = [r[n][0] for r in got]
        errors = {r: res[n][1] for r, res in enumerate(got) if res[n][1]}
        findings += check_traces(n, traces, MESH[1])
        if errors and not any(f.rule == "unknown-axis-name"
                              and f.message.startswith(f"{n}:")
                              for f in findings):
            r = min(errors)
            findings.append(Finding("trace", "trace-case-failed",
                                    f"{n}: rank {r}: {errors[r]}"))
        if log:
            log(f"  trace: {n}: {len(traces[0])} collectives a rank")
    return findings


def run(log=None) -> List[Finding]:
    """The whole grid on 8 new gloo ranks of the CPU, one thread each."""
    from repro_torch.launch.mesh import RankPool
    with RankPool(WORLD, backend="gloo", devices=["cpu"] * WORLD,
                  threads=1, timeout_s=300) as pool:
        return run_cases(pool, list(grid_cases()), log=log)
