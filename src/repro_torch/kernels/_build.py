"""Build the CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` (with the shared ``csrc/*.cuh`` headers it
includes) has a plain C interface (every function returns its
``cudaError_t`` as an int) and is compiled by ``nvcc`` for ``sm_90a`` into
its own shared library under ``kernels/build/`` (listed in ``.gitignore``).
All sources are compiled in parallel, one ``nvcc`` process each.  A
library's file name carries a hash of its source and flags, so an edited
source is rebuilt and an unchanged one is reused.

Nothing here runs at import: :func:`load` is called by the wrappers in
:mod:`repro_torch.kernels.ops` when they are handed a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

# name -> C functions it exports, with their ctypes argument types
P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES: Dict[str, Dict[str, list]] = {
    "dispatch_gather": {"dispatch_gather": [P, P, P, I, I, L, P]},
    "combine_gather": {"combine_gather": [P, P, P, P, I, I, I, I, P]},
    "grouped_ffn": {"grouped_ffn": [P, P, P, P, P, P, I, I, I, I, I, P]},
    "grouped_ffn_ragged": {"grouped_ffn_ragged": [P, P, P, P, P, P, P, I, I,
                                                  I, I, I, I, P]},
    "group_sort": {"group_sort_one": [P, L, I, I, I, P, P, P],
                   "group_sort_three": [P, L, I, I, L, P, P, P, P],
                   "launch_floor": [P]},
    "router_fused": {"router_fused": [P, I, P, I, I, I, I, P, P, P, P, P, I,
                                      P, P, P, P]},
    "flash_attn": {"flash_attention": [P, P, P, P, I, I, I, I, I, F, P]},
    "rwkv6_scan": {"rwkv6_scan": [P, P, P, P, P, P, P, P, I, I, I, I, P]},
    "ssd_chunk": {"ssd_chunk": [P, P, P, P, P, P, P, P, I, I, I, I, I, P],
                  "ssd_chunk_grouped": [P, P, P, P, P, P, P, P, I, I, I, I,
                                        I, I, P],
                  "ssd_chunk_grouped_smem": [I, I, I, I]},
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}       # nvcc output per source (ptxas -v)


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(os.path.join(os.environ[var], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (looked on PATH, in $CUDA_HOME and "
                       "/usr/local/cuda): the CUDA kernels of repro_torch "
                       "are built from source at first use")


def _lib_path(name: str) -> Path:
    # the shared headers are part of every source's hash
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:16]}.so"


def build(names: Optional[List[str]] = None) -> Dict[str, Path]:
    """Compile every missing library, one nvcc per source, all in parallel.
    Returns name -> library path.  Raises with nvcc's output on failure."""
    names = list(SIGNATURES) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        build_log[n] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {n}.cu:\n{out}")
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    if name not in _libs:
        path = build([name])[name]
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]


def load_all() -> Dict[str, ctypes.CDLL]:
    """Build all sources at once (in parallel), then load each."""
    build()
    return {n: load(n) for n in SIGNATURES}
