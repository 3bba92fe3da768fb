"""Kernel lint: the Hopper counterpart of ``repro.analysis.pallas_lint``.

The TPU lint traces each Pallas kernel and reads Mosaic's BlockSpecs; a
CUDA kernel's budget is what the card's toolchain reports and what each
launch asks for, so this pass reads those:

* ``ptxas -v`` (``_build.NVCC_FLAGS`` passes it; ``_build.build_log``
  keeps nvcc's output per source): each kernel function's registers a
  thread, spill stores and loads, stack frame and static shared memory
  (:func:`parse_ptxas`);
* the launches (:class:`Launch`): registers a thread, threads a block and
  shared memory a block (static plus the dynamic bytes the launcher asks
  for), as the profiler's CUDA activity records them for each launch at
  the path's shapes (:func:`launches_from_trace`, fed by
  ``chip_smoke.py``'s timed kernel calls).

Rules:

* ``smem-budget`` (the VMEM budget's counterpart) — a launch's static
  plus dynamic shared memory above sm_90's per-block opt-in limit
  (227 KiB), or a function's static shared memory above the 48 KiB a
  block has without opting in.
* ``register-limit`` — registers a thread times threads a block above the
  65,536 registers of an SM: such a launch fails.
* ``register-spill`` — spill stores or loads above 0 bytes: local-memory
  round trips, the nearest thing to the VMEM overflow the TPU lint
  guards against.
* ``float-atomic`` (the grid-race rule's counterpart) — on the
  ``.cu``/``.cuh`` source text, so it runs anywhere: an ``atomicAdd``
  (``_block``, ``_system``) on ``float``, ``double``, ``__half`` or
  ``__nv_bfloat16``, or a PTX ``red``/``atom`` on a float type.  Such an
  accumulation's order depends on block scheduling, so its bits change
  between runs; resume and the checkpoint tests rely on bit-identical
  steps.  Integer atomics (the router's arrival ticket, the sort's
  histogram) are exact and are not flagged.

TMA's tile alignment (the TPU tile-alignment rule's nearest counterpart)
is not carried over: the descriptors are built inside the C launchers
(``sm90.cuh`` ``make_map``) from the shapes, and ``cuTensorMapEncodeTiled``
refuses a misaligned box or stride at every launch, which the wrappers
raise on; ROADMAP records why.

Without ``nvcc`` (the CPU) the ptxas rules cannot run: :func:`run` says
``kernel: ptxas rules not run (no nvcc)`` and runs the source rule alone.
It never reports a rule it did not run.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.analysis import Finding

SM90_SMEM_OPTIN = 227 * 1024       # shared memory a block may opt in to
SM90_SMEM_STATIC = 48 * 1024       # static shared memory a block may have
SM90_REGS_PER_SM = 65536           # registers of an SM (and of a block)

CSRC = Path(__file__).resolve().parents[1] / "kernels" / "csrc"


@dataclasses.dataclass(frozen=True)
class PtxasEntry:
    """What ``ptxas -v`` reports of one kernel function."""
    source: str                    # csrc/<source>.cu
    function: str                  # mangled name
    registers: int
    spill_stores: int
    spill_loads: int
    stack: int
    static_smem: int


@dataclasses.dataclass(frozen=True)
class Launch:
    """One launch configuration of a kernel, as the card ran it."""
    kernel: str                    # demangled name, no return type
    registers: int                 # a thread
    threads: int                   # a block
    smem: int                      # a block: static plus dynamic bytes
    grid: Tuple[int, ...] = ()


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def parse_ptxas(log: str, source: str = "") -> List[PtxasEntry]:
    """Every kernel function ``ptxas -v`` reports in ``log``, in order."""
    out: List[PtxasEntry] = []
    cur: Optional[dict] = None
    props_for: Optional[str] = None

    def close():
        if cur is not None and "registers" in cur:
            out.append(PtxasEntry(source, cur["function"], cur["registers"],
                                  cur.get("spill_stores", 0),
                                  cur.get("spill_loads", 0),
                                  cur.get("stack", 0),
                                  cur.get("static_smem", 0)))

    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            close()
            cur = {"function": m.group(1)}
            continue
        m = _PROPS.search(line)
        if m:
            props_for = m.group(1)
            continue
        m = _FRAME.search(line)
        if m and cur is not None and props_for == cur["function"]:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
            continue
        m = _USED.search(line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
            s = _SMEM.search(line)
            cur["static_smem"] = int(s.group(1)) if s else 0
    close()
    return out


def demangle(names: Sequence[str]) -> Dict[str, str]:
    """``{mangled: demangled}`` through ``c++filt`` where it is installed
    (each name as it is where it is not)."""
    names = list(dict.fromkeys(names))
    tool = shutil.which("c++filt")
    if not tool or not names:
        return {n: n for n in names}
    res = subprocess.run([tool], input="\n".join(names), text=True,
                         capture_output=True)
    got = res.stdout.splitlines()
    if res.returncode != 0 or len(got) != len(names):
        return {n: n for n in names}
    return dict(zip(names, got))


def _plain_name(name: str) -> str:
    """A kernel's name as the profiler and ``c++filt`` both give it: no
    leading return type."""
    return name[5:] if name.startswith("void ") else name


def launches_from_trace(trace: dict) -> List[Launch]:
    """The kernel launches of a profiler's Chrome trace (its ``kernel``
    events' ``registers per thread``, ``block`` and ``shared memory``,
    which CUPTI reports as the static plus the dynamic bytes)."""
    out = []
    for e in trace.get("traceEvents", []):
        a = e.get("args", {})
        if e.get("cat") != "kernel" or "registers per thread" not in a:
            continue
        block = a.get("block", [1, 1, 1])
        threads = 1
        for n in block:
            threads *= int(n)
        out.append(Launch(_plain_name(e.get("name", "")),
                          int(a["registers per thread"]), threads,
                          int(a.get("shared memory", 0)),
                          tuple(int(n) for n in a.get("grid", ()))))
    return out


def launches_from_profile(prof) -> List[Launch]:
    """:func:`launches_from_trace` of a finished ``torch.profiler``
    profile (its Chrome trace, written to a temporary file and read)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return launches_from_trace(json.load(f))
    finally:
        os.remove(path)


def check_ptxas(entries: Iterable[PtxasEntry],
                names: Optional[Dict[str, str]] = None) -> List[Finding]:
    """``register-spill`` and the static part of ``smem-budget``."""
    entries = list(entries)
    names = names or demangle([e.function for e in entries])
    findings = []
    for e in entries:
        where = str(CSRC / f"{e.source}.cu") if e.source else None
        fn = names.get(e.function, e.function)
        if e.spill_stores or e.spill_loads:
            findings.append(Finding(
                "kernel", "register-spill",
                f"{fn}: {e.spill_stores} bytes spill stores, "
                f"{e.spill_loads} bytes spill loads ({e.registers} "
                f"registers, {e.stack} bytes stack frame): local-memory "
                f"round trips", where))
        if e.static_smem > SM90_SMEM_STATIC:
            findings.append(Finding(
                "kernel", "smem-budget",
                f"{fn}: {e.static_smem} bytes of static shared memory, "
                f"above the {SM90_SMEM_STATIC} a block has without opting "
                f"in", where))
    return findings


def match_launches(entries: Sequence[PtxasEntry], launches: Iterable[Launch],
                   names: Optional[Dict[str, str]] = None
                   ) -> Dict[str, List[Launch]]:
    """``{mangled function: its distinct launches}`` for the functions of
    ``entries`` (a launch of any other kernel, PyTorch's own, is left
    out)."""
    names = names or demangle([e.function for e in entries])
    by_name = {_plain_name(names.get(e.function, e.function)): e.function
               for e in entries}
    out: Dict[str, List[Launch]] = {}
    for l in launches:
        fn = by_name.get(l.kernel)
        if fn is not None and l not in out.setdefault(fn, []):
            out[fn].append(l)
    return out


def check_launches(launches: Iterable[Launch]) -> List[Finding]:
    """``smem-budget`` and ``register-limit`` of each launch."""
    findings = []
    for l in launches:
        if l.smem > SM90_SMEM_OPTIN:
            findings.append(Finding(
                "kernel", "smem-budget",
                f"{l.kernel} (grid {list(l.grid)}, {l.threads} threads): "
                f"{l.smem} bytes of shared memory a block, above sm_90's "
                f"opt-in limit of {SM90_SMEM_OPTIN}"))
        if l.registers * l.threads > SM90_REGS_PER_SM:
            findings.append(Finding(
                "kernel", "register-limit",
                f"{l.kernel}: {l.registers} registers x {l.threads} "
                f"threads = {l.registers * l.threads}, above the "
                f"{SM90_REGS_PER_SM} registers of an SM: the launch "
                f"fails"))
    return findings


# --------------------------------------------------------- float atomics
FLOAT_TYPES = ("float", "double", "__half", "half", "__nv_bfloat16",
               "nv_bfloat16", "bf16", "__half2", "__nv_bfloat162", "float2",
               "float4")
_ATOMIC = re.compile(r"\batomicAdd(?:_block|_system)?\s*\(")
_PTX_FLOAT_ATOMIC = re.compile(
    r"\b(?:red|atom)(?:\.\w+)*\.(?:f16x2|bf16x2|f16|bf16|f32|f64)\b")
_FLOAT_LITERAL = re.compile(r"^[-+]?(\d+\.\d*|\.\d+|\d+(\.\d*)?[eE][-+]?\d+)"
                            r"[fF]?$|^[-+]?\d+[fF]$")


def _strip_comments(src: str) -> str:
    """``src`` with comments blanked (newlines kept, so lines still
    count)."""
    def blank(m):
        return re.sub(r"[^\n]", " ", m.group(0))
    return re.sub(r"//[^\n]*|/\*.*?\*/", blank, src, flags=re.S)


def _call_args(src: str, open_at: int) -> List[str]:
    """The top-level arguments of the call whose ``(`` is at
    ``open_at``."""
    depth, args, start = 0, [], open_at + 1
    for i in range(open_at, len(src)):
        c = src[i]
        if c in "([{":
            depth += 1
        elif c in ")]}":
            depth -= 1
            if depth == 0:
                args.append(src[start:i].strip())
                return args
        elif c == "," and depth == 1:
            args.append(src[start:i].strip())
            start = i + 1
    return args


def _base_name(expr: str) -> Optional[str]:
    """The variable an operand names: ``&h[key]`` -> ``h``, ``out + i`` ->
    ``out``, ``(float*)p`` -> ``p``."""
    expr = re.sub(r"^\s*\([^()]*\)\s*", "", expr.strip())
    m = re.match(r"[&*\s(]*([A-Za-z_]\w*)", expr)
    return m.group(1) if m else None


def _declared_float(src: str, name: str) -> bool:
    types = "|".join(re.escape(t) for t in FLOAT_TYPES)
    return re.search(rf"\b(?:{types})\b(?:\s+const)?[\s*&]*(?:const\s+)?"
                     rf"(?:__restrict__\s+)?\b{re.escape(name)}\b", src) is not None


def _cast_float(expr: str) -> bool:
    types = "|".join(re.escape(t) for t in FLOAT_TYPES)
    return re.match(rf"\s*\(\s*(?:const\s+)?(?:{types})\s*\*", expr) is not None


def float_atomics(src: str) -> List[Tuple[int, str]]:
    """``(line, what)`` of each float atomic accumulation in a CUDA
    source's text."""
    code = _strip_comments(src)
    out = []
    for m in _ATOMIC.finditer(code):
        args = _call_args(code, m.end() - 1)
        if len(args) < 2:
            continue
        ptr, val = args[0], args[1]
        p, v = _base_name(ptr), _base_name(val)
        flt = (_cast_float(ptr) or _FLOAT_LITERAL.match(val) is not None
               or (p is not None and _declared_float(code, p))
               or (v is not None and not val.strip()[0].isdigit()
                   and _declared_float(code, v)))
        if flt:
            out.append((code.count("\n", 0, m.start()) + 1,
                        f"{m.group(0).rstrip('( ')}({ptr}, {val})"))
    for m in _PTX_FLOAT_ATOMIC.finditer(code):
        out.append((code.count("\n", 0, m.start()) + 1, m.group(0)))
    return sorted(out)


def check_float_atomics(paths: Iterable[str]) -> List[Finding]:
    findings = []
    for path in paths:
        try:
            with open(path) as f:
                src = f.read()
        except OSError:
            continue
        for line, what in float_atomics(src):
            findings.append(Finding(
                "kernel", "float-atomic",
                f"{what}: a float atomic accumulation, whose order (and so "
                f"its bits) depends on block scheduling; accumulate in a "
                f"fixed order (a count and an exclusive scan, or one "
                f"owner a slot)", path, line))
    return findings


def cuda_sources(csrc: Path = CSRC) -> List[str]:
    return [str(p) for p in sorted(csrc.glob("*.cu")) + sorted(
        csrc.glob("*.cuh"))]


def ptxas_logs() -> Optional[Dict[str, str]]:
    """nvcc's ``-Xptxas -v`` output per source: what ``_build`` kept of
    this process's build, the rest compiled again into a temporary
    directory (all in parallel); None where there is no ``nvcc``."""
    from repro_torch.kernels import _build
    try:
        nvcc = _build._nvcc()
    except RuntimeError:
        return None
    logs = dict(_build.build_log)
    todo = [n for n in _build.SIGNATURES if n not in logs]
    with tempfile.TemporaryDirectory() as tmp:
        procs = {n: subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", os.path.join(tmp, f"{n}.so"),
             str(_build.CSRC / f"{n}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for n in todo}
        for n, p in procs.items():
            logs[n] = p.communicate()[0]
    return logs


def ptxas_entries(logs: Dict[str, str]) -> List[PtxasEntry]:
    return [e for n in sorted(logs) for e in parse_ptxas(logs[n], n)]


def run(log=None, logs: Optional[Dict[str, str]] = None) -> List[Finding]:
    """The kernel rules: ``float-atomic`` on the sources always; the
    ptxas rules over ``logs`` (default :func:`ptxas_logs`) where nvcc's
    output exists.  The launch rules need the card's launch records
    (:func:`match_launches`, :func:`check_launches`), which
    ``chip_smoke.py`` phase 23 gathers."""
    log = log or (lambda _msg: None)
    findings = check_float_atomics(cuda_sources())
    log(f"  kernel: float-atomic over {len(cuda_sources())} sources, "
        f"{len(findings)} finding(s)")
    if logs is None:
        logs = ptxas_logs()
    if logs is None:
        log("kernel: ptxas rules not run (no nvcc)")
        return findings
    entries = ptxas_entries(logs)
    got = check_ptxas(entries)
    log(f"  kernel: ptxas rules over {len(entries)} kernel functions of "
        f"{len(logs)} sources, {len(got)} finding(s)")
    log("kernel: launch rules (smem-budget at launch, register-limit) not "
        "run (no launch records: chip_smoke.py phase 23 runs them)")
    return findings + got
