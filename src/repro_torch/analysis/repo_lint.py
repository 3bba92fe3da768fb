"""AST-level repo invariants of the port: no tracing, no card, no JAX.

The port of ``repro.analysis.repo_lint``.  Three rules, each over the
source tree of ``src/repro_torch``:

* ``unregistered-config-knob`` / ``registry-orphan`` — every runtime
  field of ``MoEConfig``, ``TrainConfig`` and ``ServeConfig`` is
  registered in ``MOE_OPTIONS``, ``TRAIN_OPTIONS`` and ``SERVE_OPTIONS``
  (``common/config.py``; the registries the launchers derive their flags
  and the dry run its ``--opt`` tokens from), and every registry entry
  names a real field.  Structural fields are whitelisted, the same lists
  as the JAX package's; ``resume`` is a launcher action.
* ``kernel-missing-signature`` / ``kernel-missing-wrapper`` /
  ``kernel-missing-ref`` — every ``extern "C"`` function of
  ``kernels/csrc/*.cu`` is bound in ``_build.SIGNATURES`` (ctypes passes
  what it lists), is called from a wrapper in ``kernels/ops.py`` (the
  layer that takes the plain version on the CPU and counts launches) and
  that wrapper has a plain twin ``<wrapper>_ref`` in ``kernels/ref.py``
  (what the kernel is held against).  The helper exports of
  :data:`KERNEL_HELPERS` launch no kernel of a path and are exempt.
* ``rogue-collective`` — no call to a ``torch.distributed`` collective
  outside ``sharding/comm.py``, the one module that issues them (the
  static twin of :mod:`repro_torch.analysis.trace_lint`'s provenance
  rule, which sees only the code the entrypoint grid reaches).  Making
  and destroying process groups is not a collective.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis import Finding

# MoEConfig fields that are architecture structure, not runtime knobs:
# changing them changes the model, so they are launched via configs/, not
# via the options registry (the JAX package's list).
MOE_STRUCTURAL = frozenset({
    "num_experts", "top_k", "top_g", "renorm_gates", "d_ff_expert",
    "num_shared_experts", "capacity_factor", "router", "lb_alpha",
    "lb_beta", "router_z_coef", "every_n_layers", "first_dense_layers",
    "grid",
})

# TrainConfig fields that are training-run structure (batch, optimizer,
# schedule), not launcher-registry knobs.
TRAIN_STRUCTURAL = frozenset({
    "global_batch_size", "micro_batch_size", "seq_len", "steps",
    "optimizer", "lr", "warmup_steps", "weight_decay", "grad_clip", "eps",
    "b1", "b2", "schedule", "mlm_mask_prob", "seed", "log_every",
})

# ServeConfig fields that describe the workload (request geometry,
# sampling), not engine knobs; the engine knobs live in SERVE_OPTIONS.
SERVE_STRUCTURAL = frozenset({
    "batch_size", "prompt_len", "max_new_tokens", "cache_len", "temperature",
})

# Registry entries that are launcher actions, not config fields.
LAUNCHER_ONLY = frozenset({"resume"})

# extern "C" exports that are no kernel of a path, with the reason
KERNEL_HELPERS = {
    "launch_floor": "an empty kernel: the least a launch through ctypes "
                    "costs, measured by chip_smoke.py, on no path",
    "ssd_chunk_grouped_smem": "a host-side query of the grouped SSD "
                              "route's dynamic shared memory; it launches "
                              "nothing",
}

# torch.distributed functions that move bytes between ranks (exact names,
# and the prefixes of their variants: all_gather_into_tensor, ...)
COLLECTIVE_CALLS = frozenset({
    "all_reduce", "broadcast", "barrier", "send", "recv", "isend", "irecv",
    "batch_isend_irecv", "reduce", "gather", "scatter",
})
COLLECTIVE_PREFIXES = ("all_gather", "reduce_scatter", "all_to_all",
                       "all_reduce_", "broadcast_")

EXTERN_C = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(')


def _parse(path: str) -> Optional[ast.Module]:
    try:
        with open(path, "r") as f:
            return ast.parse(f.read(), filename=path)
    except (OSError, SyntaxError):
        return None


def _dataclass_fields(tree: ast.Module, cls_name: str) -> Set[str]:
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == cls_name:
            return {st.target.id for st in node.body
                    if isinstance(st, ast.AnnAssign)
                    and isinstance(st.target, ast.Name)}
    return set()


def _registry_fields(tree: ast.Module, registry_name: str) -> Set[str]:
    """First-arg strings of ``MoEOption(...)`` calls in a registry tuple."""
    for node in ast.walk(tree):
        if (isinstance(node, ast.AnnAssign)
                and isinstance(node.target, ast.Name)
                and node.target.id == registry_name):
            out = set()
            for call in ast.walk(node):
                if (isinstance(call, ast.Call) and call.args
                        and isinstance(call.args[0], ast.Constant)
                        and isinstance(call.args[0].value, str)):
                    out.add(call.args[0].value)
            return out
    return set()


def check_config_registry(config_path: str) -> List[Finding]:
    """Two-way check: config fields <-> options-registry entries."""
    tree = _parse(config_path)
    if tree is None:
        return [Finding("repo", "parse-error",
                        f"cannot parse {config_path}", config_path)]
    findings: List[Finding] = []
    for cls, registry, structural, prefix in (
            ("MoEConfig", "MOE_OPTIONS", MOE_STRUCTURAL, "MOE"),
            ("TrainConfig", "TRAIN_OPTIONS", TRAIN_STRUCTURAL, "TRAIN"),
            ("ServeConfig", "SERVE_OPTIONS", SERVE_STRUCTURAL, "SERVE")):
        fields = _dataclass_fields(tree, cls)
        registered = _registry_fields(tree, registry)
        if not fields or not registered:
            findings.append(Finding(
                "repo", "parse-error",
                f"could not locate {cls} fields or {registry} entries in "
                f"{config_path}", config_path))
            continue
        for f in sorted(fields - registered - structural):
            findings.append(Finding(
                "repo", "unregistered-config-knob",
                f"{cls}.{f} is neither registered in {registry} nor in the "
                f"structural whitelist: an unregistered knob is "
                f"unreachable from the launchers (register it, or add it "
                f"to {prefix}_STRUCTURAL in repro_torch.analysis.repo_lint "
                f"if it is model structure)", config_path))
        for f in sorted(registered - fields - LAUNCHER_ONLY):
            findings.append(Finding(
                "repo", "registry-orphan",
                f"{registry} registers {f!r} but {cls} has no such field",
                config_path))
    return findings


def _extern_c(path: str) -> List[Tuple[str, int]]:
    """``(function, line)`` of each ``extern "C"`` definition in a
    source."""
    try:
        with open(path) as f:
            src = f.read()
    except OSError:
        return []
    return [(m.group(1), src.count("\n", 0, m.start()) + 1)
            for m in EXTERN_C.finditer(src)]


def _signatures(build_path: str) -> Dict[str, Set[str]]:
    """``_build.SIGNATURES`` read from the source: source name -> the C
    functions it binds."""
    tree = _parse(build_path)
    out: Dict[str, Set[str]] = {}
    if tree is None:
        return out
    for node in ast.walk(tree):
        target = (node.target if isinstance(node, ast.AnnAssign) else
                  node.targets[0] if isinstance(node, ast.Assign) else None)
        if (isinstance(target, ast.Name) and target.id == "SIGNATURES"
                and isinstance(node.value, ast.Dict)):
            for k, v in zip(node.value.keys, node.value.values):
                if isinstance(k, ast.Constant) and isinstance(v, ast.Dict):
                    out[k.value] = {fk.value for fk in v.keys
                                    if isinstance(fk, ast.Constant)}
    return out


def _callers(tree: ast.Module) -> Tuple[Dict[str, Set[str]],
                                        Dict[str, Set[str]]]:
    """For each top-level function and class of ``ops.py`` (an autograd
    ``Function`` is called through ``Cls.apply``): the ``lib.<fn>`` C
    functions it calls, and the module functions and classes it calls."""
    c_calls: Dict[str, Set[str]] = {}
    py_calls: Dict[str, Set[str]] = {}
    for node in tree.body:
        if not isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            continue
        cs, ps = set(), set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                f = sub.func
                if isinstance(f, ast.Attribute) and isinstance(
                        f.value, ast.Name):
                    (cs if f.value.id == "lib" else ps).add(
                        f.attr if f.value.id == "lib" else f.value.id)
                elif isinstance(f, ast.Name):
                    ps.add(f.id)
        c_calls[node.name], py_calls[node.name] = cs, ps
    return c_calls, py_calls


def _public_wrappers(fn: str, c_calls, py_calls) -> Set[str]:
    """The public functions of ``ops.py`` through which C function ``fn``
    is reached (a private helper's public callers, transitively)."""
    todo = [name for name, cs in c_calls.items() if fn in cs]
    seen, out = set(todo), set()
    while todo:
        name = todo.pop()
        if not name.startswith("_"):
            out.add(name)
            continue
        for caller, ps in py_calls.items():
            if name in ps and caller not in seen:
                seen.add(caller)
                todo.append(caller)
    return out


def check_kernel_twins(kernels_dir: str) -> List[Finding]:
    """Every ``extern "C"`` function of ``csrc/*.cu`` is in
    ``_build.SIGNATURES``, reached from a public wrapper of ``ops.py``,
    and that wrapper has a ``<wrapper>_ref`` in ``ref.py``."""
    csrc = os.path.join(kernels_dir, "csrc")
    ops_path = os.path.join(kernels_dir, "ops.py")
    ref_path = os.path.join(kernels_dir, "ref.py")
    ops_tree, ref_tree = _parse(ops_path), _parse(ref_path)
    if ops_tree is None or ref_tree is None:
        return [Finding("repo", "parse-error",
                        f"cannot parse {ops_path} or {ref_path}", kernels_dir)]
    sigs = _signatures(os.path.join(kernels_dir, "_build.py"))
    c_calls, py_calls = _callers(ops_tree)
    ref_defs = {n.name for n in ref_tree.body
                if isinstance(n, ast.FunctionDef)}
    findings: List[Finding] = []
    try:
        sources = sorted(f for f in os.listdir(csrc) if f.endswith(".cu"))
    except OSError:
        return [Finding("repo", "parse-error", f"missing {csrc}", csrc)]
    for fname in sources:
        path = os.path.join(csrc, fname)
        stem = fname[:-3]
        for fn, line in _extern_c(path):
            if fn not in sigs.get(stem, set()):
                findings.append(Finding(
                    "repo", "kernel-missing-signature",
                    f"{fn} is not bound in _build.SIGNATURES[{stem!r}]: "
                    f"ctypes would pass its arguments unchecked", path, line))
            if fn in KERNEL_HELPERS:
                continue
            wrappers = _public_wrappers(fn, c_calls, py_calls)
            if not wrappers:
                findings.append(Finding(
                    "repo", "kernel-missing-wrapper",
                    f"{fn} is called from no wrapper in kernels/ops.py: "
                    f"every kernel goes through the ops layer (the plain "
                    f"version on the CPU, the launch count)", path, line))
                continue
            for w in sorted(wrappers):
                if f"{w}_ref" not in ref_defs:
                    findings.append(Finding(
                        "repo", "kernel-missing-ref",
                        f"{fn}'s wrapper ops.{w} has no {w}_ref twin in "
                        f"kernels/ref.py: every kernel is held against a "
                        f"plain version", path, line))
    return findings


def _dist_names(tree: ast.Module) -> Tuple[Set[str], Set[str], Dict[str, str]]:
    """How a file names ``torch.distributed``: module aliases (``dist``),
    ``torch`` aliases (``torch.distributed.X``), and functions imported
    from it by name (local name -> function)."""
    mods, torches, funcs = set(), set(), {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed" and a.asname:
                    mods.add(a.asname)
                elif a.name in ("torch", "torch.distributed"):
                    torches.add(a.asname or "torch")
        elif isinstance(node, ast.ImportFrom):
            if node.module == "torch":
                for a in node.names:
                    if a.name == "distributed":
                        mods.add(a.asname or a.name)
            elif node.module == "torch.distributed":
                for a in node.names:
                    funcs[a.asname or a.name] = a.name
    return mods, torches, funcs


def is_collective(name: str) -> bool:
    return name in COLLECTIVE_CALLS or name.startswith(COLLECTIVE_PREFIXES)


def _called_collective(func: ast.AST, mods, torches, funcs) -> Optional[str]:
    if isinstance(func, ast.Name):
        real = funcs.get(func.id)
        return real if real is not None and is_collective(real) else None
    if not isinstance(func, ast.Attribute) or not is_collective(func.attr):
        return None
    v = func.value
    if isinstance(v, ast.Name) and v.id in mods:
        return func.attr
    if (isinstance(v, ast.Attribute) and v.attr == "distributed"
            and isinstance(v.value, ast.Name) and v.value.id in torches):
        return func.attr
    return None


def check_collective_callsites(paths: Iterable[str],
                               allow_suffix: str = "sharding/comm.py"
                               ) -> List[Finding]:
    """No call to a ``torch.distributed`` collective outside
    ``sharding/comm.py``."""
    findings: List[Finding] = []
    for path in paths:
        if path.replace(os.sep, "/").endswith(allow_suffix):
            continue
        tree = _parse(path)
        if tree is None:
            continue
        names = _dist_names(tree)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            op = _called_collective(node.func, *names)
            if op is not None:
                findings.append(Finding(
                    "repo", "rogue-collective",
                    f"direct torch.distributed.{op} call outside "
                    f"sharding/comm.py: route it through the comm helpers "
                    f"(the identity on empty axes, the wire log, the "
                    f"gradient, the trace lint's provenance)", path,
                    node.lineno))
    return findings


def py_files(root: str) -> List[str]:
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        out += [os.path.join(dirpath, fn) for fn in sorted(filenames)
                if fn.endswith(".py")]
    return out


def run(src_root: Optional[str] = None, log=None) -> List[Finding]:
    """All repo rules over the live source tree (``src/repro_torch`` by
    default)."""
    if src_root is None:
        src_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = py_files(src_root)
    findings = check_config_registry(
        os.path.join(src_root, "common", "config.py"))
    findings += check_kernel_twins(os.path.join(src_root, "kernels"))
    findings += check_collective_callsites(files)
    if log:
        log(f"  repo: {len(files)} files scanned, {len(findings)} "
            f"finding(s)")
    return findings
