"""The port's analyzers (``repro_torch.analysis``) on the CPU.

* Repo lint: the port's tree has no finding; each seeded-bad fixture (a
  copy of the files a rule reads, edited in a temporary directory) hits
  its rule exactly once and no other.  The registry rule is held to the
  JAX package's (``repro.analysis.repo_lint``, which imports no JAX):
  both find nothing in their own configs, and on one seeded config text
  both name the same rule and field.
* Kernel lint: the ptxas parser on real ``ptxas info`` lines of the card's
  build (``_build.build_log``, NVIDIA H100 80GB HBM3, CUDA 12.8), the
  launch records of a profiler trace, the launch rules on seeded
  records, and ``float-atomic`` on seeded sources and on the real
  ``csrc/``, where it finds none.  Without nvcc the pass says that its
  ptxas rules were not run.
* Trace lint: the entrypoint grid on one pool of 8 gloo ranks gives no
  finding, and seeded functions on the same ranks hit
  ``rank-divergent-collectives``, ``collective-int-dtype``,
  ``unknown-axis-name`` and ``collective-outside-comm``, each alone.
* The CLI's repo and kernel passes exit 0 on this tree.
"""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import Finding, format_findings
from repro_torch.analysis import kernel_lint as K
from repro_torch.analysis import repo_lint as R
from repro_torch.analysis import trace_lint as TL
from repro_torch.launch.mesh import RankPool
from repro_torch.sharding import comm

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
PORT = SRC / "repro_torch"


def rules(findings):
    return [f.rule for f in findings]


# =============================================================================
# Repo lint
# =============================================================================

def test_port_tree_has_no_repo_finding():
    assert R.run() == []


def _fixture(tmp_path) -> Path:
    """A copy of what the repo rules read: common/config.py and
    kernels/{_build,ops,ref}.py with csrc/."""
    root = tmp_path / "repro_torch"
    (root / "common").mkdir(parents=True)
    shutil.copy(PORT / "common" / "config.py", root / "common")
    shutil.copytree(PORT / "kernels", root / "kernels",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    return root


def _edit(path: Path, old: str, new: str) -> None:
    src = path.read_text()
    assert old in src
    path.write_text(src.replace(old, new, 1))


EXTRA_C = '\nextern "C" int extra_kernel(int n, void* stream) { return 0; }\n'
EXTRA_SIG = '    "dispatch_gather": {"dispatch_gather": [P, P, P, I, I, L, P],\n' \
            '                        "extra_kernel": [I, P]},'
EXTRA_OPS = ("\n\ndef extra(n):\n    lib = _build.load('dispatch_gather')\n"
             "    return lib.extra_kernel(n, _stream())\n")
EXTRA_REF = "\n\ndef extra_ref(n):\n    return n\n"


def _seed_unregistered(root):
    _edit(root / "common" / "config.py",
          "    num_experts: int = 0", "    bogus_knob: int = 0\n"
          "    num_experts: int = 0")


def _seed_orphan(root):
    _edit(root / "common" / "config.py", "MOE_OPTIONS: Tuple[MoEOption, ...] = (",
          "MOE_OPTIONS: Tuple[MoEOption, ...] = (\n"
          "    MoEOption(\"ghost_field\", \"bool\"),")


def _seed_extra_kernel(root, sig=True, ops=True, ref=True):
    k = root / "kernels"
    with open(k / "csrc" / "dispatch_gather.cu", "a") as f:
        f.write(EXTRA_C)
    if sig:
        _edit(k / "_build.py", '    "dispatch_gather": {"dispatch_gather": '
              '[P, P, P, I, I, L, P]},', EXTRA_SIG)
    if ops:
        with open(k / "ops.py", "a") as f:
            f.write(EXTRA_OPS)
    if ref:
        with open(k / "ref.py", "a") as f:
            f.write(EXTRA_REF)


def _seed_rogue(root):
    (root / "rogue.py").write_text(
        "import torch.distributed as dist\n\n\ndef f(x):\n"
        "    dist.all_reduce(x)\n    dist.new_group([0])\n")


SEEDS = {
    "unregistered-config-knob": _seed_unregistered,
    "registry-orphan": _seed_orphan,
    "kernel-missing-signature": lambda r: _seed_extra_kernel(r, sig=False),
    "kernel-missing-wrapper": lambda r: _seed_extra_kernel(r, ops=False),
    "kernel-missing-ref": lambda r: _seed_extra_kernel(r, ref=False),
    "rogue-collective": _seed_rogue,
}


def test_fixture_unseeded_is_clean(tmp_path):
    assert R.run(str(_fixture(tmp_path))) == []


@pytest.mark.parametrize("rule", sorted(SEEDS))
def test_seeded_fixture_hits_its_rule_once(rule, tmp_path):
    root = _fixture(tmp_path)
    SEEDS[rule](root)
    got = R.run(str(root))
    assert rules(got) == [rule], format_findings(got)
    assert got[0].file and os.path.exists(got[0].file)


def test_collective_aliases_are_recognized(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import torch\nfrom torch import distributed as d2\n"
                 "from torch.distributed import all_to_all_single as a2a\n"
                 "def f(x):\n    torch.distributed.barrier()\n"
                 "    d2.reduce_scatter_tensor(x, x)\n    a2a(x, x)\n"
                 "    torch.distributed.destroy_process_group()\n")
    got = R.check_collective_callsites([str(p)])
    assert rules(got) == ["rogue-collective"] * 3
    assert [f.line for f in got] == [5, 6, 7]


def test_registry_rule_held_to_jax(tmp_path):
    from repro.analysis import repo_lint as JR
    jax_cfg = SRC / "repro" / "common" / "config.py"
    port_cfg = PORT / "common" / "config.py"
    assert JR.check_config_registry(str(jax_cfg)) == []
    assert R.check_config_registry(str(port_cfg)) == []
    assert JR.MOE_STRUCTURAL == R.MOE_STRUCTURAL
    assert JR.TRAIN_STRUCTURAL == R.TRAIN_STRUCTURAL
    assert JR.SERVE_STRUCTURAL == R.SERVE_STRUCTURAL
    for src in (jax_cfg, port_cfg):
        seeded = tmp_path / f"{src.parent.parent.name}_config.py"
        seeded.write_text(src.read_text().replace(
            "    num_experts: int = 0", "    bogus_knob: int = 0\n"
            "    num_experts: int = 0", 1))
        jf = JR.check_config_registry(str(seeded))
        pf = R.check_config_registry(str(seeded))
        assert [f.rule for f in jf] == [f.rule for f in pf] == [
            "unregistered-config-knob"]
        assert "MoEConfig.bogus_knob" in jf[0].message
        assert "MoEConfig.bogus_knob" in pf[0].message


def test_finding_format_is_the_jax_packages():
    from repro.analysis import Finding as JF
    from repro.analysis import format_findings as jfmt
    fs = [Finding("repo", "r", "m", "f.py", 3), Finding("trace", "t", "n")]
    js = [JF("repo", "r", "m", "f.py", 3), JF("trace", "t", "n")]
    assert format_findings(fs) == jfmt(js)
    assert format_findings([]) == jfmt([]) == "no findings"


# =============================================================================
# Kernel lint
# =============================================================================

# ptxas -v lines of the card's build (flash_attn.cu, group_sort.cu)
PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__e2cf8434_13_flash_attn_cu_ddac23b615flash_attn_wideILi7EEEvPK13__nv_bfloat16S3_S3_PS1_iiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__e2cf8434_13_flash_attn_cu_ddac23b615flash_attn_wideILi7EEEvPK13__nv_bfloat16S3_S3_PS1_iiiif
    24 bytes stack frame, 28 bytes spill stores, 40 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 24 bytes cumulative stack size
ptxas info    : Compile time = 285.729 ms
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__e2cf8434_13_flash_attn_cu_ddac23b615flash_attn_sm90ILi192EEEv14CUtensorMap_stS1_S1_S1_iiif' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__e2cf8434_13_flash_attn_cu_ddac23b615flash_attn_sm90ILi192EEEv14CUtensorMap_stS1_S1_S1_iiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 158 registers, used 16 barriers
ptxas info    : Compile time = 413.895 ms
ptxas info    : Compiling entry function '_ZN17group_sort_phases11scan_kernelEPixiiS0_' for 'sm_90a'
ptxas info    : Function properties for _ZN17group_sort_phases11scan_kernelEPixiiS0_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 41 registers, used 1 barriers, 144 bytes smem
ptxas info    : Compile time = 86.648 ms
"""

# kernel events of a profiler trace on the card (their args as CUPTI
# reports them; "shared memory" is static plus dynamic)
TRACE = {"traceEvents": [
    {"ph": "X", "cat": "kernel", "name": "(anonymous namespace)::rwkv6_scan_kernel(float const*, float const*, float const*, float const*, float const*, float const*, float*, float*, int, int)",
     "args": {"registers per thread": 96, "shared memory": 90112,
              "grid": [256, 1, 1], "block": [128, 1, 1]}},
    {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::flash_attn_sm90<192>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, int, int, int, float)",
     "args": {"registers per thread": 158, "shared memory": 164936,
              "grid": [32, 32, 2], "block": [288, 1, 1]}},
    {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "args": {}},
]}


def test_ptxas_parser_on_card_lines():
    es = K.parse_ptxas(PTXAS, "flash_attn")
    assert [(e.registers, e.spill_stores, e.spill_loads, e.stack,
             e.static_smem) for e in es] == [(64, 28, 40, 24, 0),
                                            (158, 0, 0, 0, 0),
                                            (41, 0, 0, 0, 144)]
    assert es[0].function.endswith("PS1_iiiif") and es[0].source == \
        "flash_attn"
    got = K.check_ptxas(es)
    assert rules(got) == ["register-spill"]
    assert "28 bytes spill stores, 40 bytes spill loads" in got[0].message
    assert got[0].file.endswith("flash_attn.cu")


def test_launch_records_and_rules():
    ls = K.launches_from_trace(TRACE)
    assert [(l.registers, l.threads, l.smem, l.grid) for l in ls] == [
        (96, 128, 90112, (256, 1, 1)), (158, 288, 164936, (32, 32, 2))]
    assert K.check_launches(ls) == []
    # a launch is paired with its ptxas function by the demangled name
    es = K.parse_ptxas(PTXAS, "flash_attn")
    matched = K.match_launches(es, ls)
    if shutil.which("c++filt"):
        assert list(matched) == [es[1].function]
    bad = [K.Launch("k_smem", 32, 128, K.SM90_SMEM_OPTIN + 16),
           K.Launch("k_regs", 255, 512, 0),
           K.Launch("k_ok", 255, 256, K.SM90_SMEM_OPTIN)]
    assert rules(K.check_launches(bad)) == ["smem-budget", "register-limit"]


def test_static_smem_above_48k_is_a_finding():
    e = K.PtxasEntry("x", "_Z1fv", 32, 0, 0, 0, 48 * 1024 + 4)
    assert rules(K.check_ptxas([e], {"_Z1fv": "f()"})) == ["smem-budget"]


FLOAT_ATOMIC_SRC = """\
__global__ void k(float* out, int* counts, const float* x, double* acc) {
  extern __shared__ int32_t h[];
  atomicAdd(&h[threadIdx.x], 1);          // integer: exact
  atomicAdd(counts + 3, 1u);              // integer: exact
  atomicAdd(&out[threadIdx.x], x[0]);     // float: flagged
  atomicAdd_block(acc, 0.5);              // double: flagged
  asm volatile("red.global.add.f32 [%0], %1;" :: "l"(out), "f"(1.0f));
  // atomicAdd(&out[0], 1.0f) in a comment is not code
}
"""


def test_float_atomic_on_seeded_source(tmp_path):
    got = K.float_atomics(FLOAT_ATOMIC_SRC)
    assert [line for line, _ in got] == [5, 6, 7]
    p = tmp_path / "k.cu"
    p.write_text(FLOAT_ATOMIC_SRC)
    f = K.check_float_atomics([str(p)])
    assert rules(f) == ["float-atomic"] * 3 and f[0].line == 5


def test_real_sources_have_no_float_atomic():
    srcs = K.cuda_sources()
    assert len(srcs) == 12
    assert K.check_float_atomics(srcs) == []
    # the integer atomics the rule lets through are there
    text = "".join(Path(s).read_text() for s in srcs)
    assert len(re.findall(r"\batomicAdd\(", text)) == 2


def test_kernel_pass_without_nvcc_says_so(monkeypatch):
    from repro_torch.kernels import _build

    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    said = []
    assert K.run(log=said.append) == []
    assert "kernel: ptxas rules not run (no nvcc)" in said


# =============================================================================
# Trace lint
# =============================================================================

def _seed_divergent(mesh):
    """A psum on rank 0 only (the wire stubbed there, so that the other
    ranks do not wait for it)."""
    if mesh.rank == 0:
        real = torch.distributed.all_reduce
        torch.distributed.all_reduce = lambda *a, **k: None
        try:
            comm.psum(torch.ones(2), "data")
        finally:
            torch.distributed.all_reduce = real


def _seed_int64(mesh):
    comm.psum(torch.ones(4, dtype=torch.int64), "data")


def _seed_unknown_axis(mesh):
    comm.psum(torch.ones(2), "expert")


def _seed_outside_comm(mesh):
    torch.distributed.all_reduce(torch.ones(2),
                                 group=mesh.group(("data",)).pg)


TRACE_SEEDS = {"rank-divergent-collectives": _seed_divergent,
               "collective-int-dtype": _seed_int64,
               "unknown-axis-name": _seed_unknown_axis,
               "collective-outside-comm": _seed_outside_comm}


@pytest.fixture(scope="module")
def trace_run(tmp_path_factory):
    """The grid and the seeded cases, on one pool of 8 gloo ranks."""
    rdzv = tmp_path_factory.mktemp("rdzv") / "store"
    names = list(TL.grid_cases())
    with RankPool(TL.WORLD, backend="gloo", devices=["cpu"] * TL.WORLD,
                  threads=1, timeout_s=300,
                  init_method=f"file://{rdzv}") as pool:
        grid = TL.run_cases(pool, names)
        seeded = {rule: TL.run_cases(pool, [rule], {rule: fn})
                  for rule, fn in TRACE_SEEDS.items()}
    return grid, seeded


def test_entrypoint_grid_has_no_trace_finding(trace_run):
    grid, _ = trace_run
    assert grid == [], format_findings(grid)


@pytest.mark.parametrize("rule", sorted(TRACE_SEEDS))
def test_seeded_case_hits_its_trace_rule(rule, trace_run):
    got = trace_run[1][rule]
    assert rules(got) == [rule], format_findings(got)
    assert got[0].file and got[0].file.endswith("test_torch_analysis.py")


def test_trace_rules_on_hand_made_traces():
    def call(op, axes, dtype="float32", caller="m.py:1"):
        return comm.TraceCall(op, axes, dtype, (2,), caller, (2,))
    same = [call("psum", ("data",)), call("all_to_all", ("model",))]
    assert TL.check_traces("c", [same, list(same)], ("data", "model")) == []
    other = [call("psum", ("data",)), call("all_to_all", ("data",))]
    got = TL.check_traces("c", [same, other], ("data", "model"))
    assert rules(got) == ["rank-divergent-collectives"]
    assert "#1" in got[0].message


# =============================================================================
# The CLI
# =============================================================================

def test_cli_repo_and_kernel_passes_exit_zero():
    for p in ("repo", "kernel"):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.analyze", "--pass", p,
             "-q"], capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=str(SRC)))
        assert out.returncode == 0, out.stdout + out.stderr
        assert out.stdout.strip().endswith("no findings")
        if p == "kernel" and not shutil.which("nvcc") and not os.path.exists(
                "/usr/local/cuda/bin/nvcc"):
            assert "kernel: ptxas rules not run (no nvcc)" in out.stdout
