"""The C interface of every CUDA kernel against the ctypes argument types
that :mod:`repro_torch.kernels._build` gives it.

ctypes passes each argument as ``_build.SIGNATURES`` says; a pointer
declared there as an ``int`` is cut to 32 bits without a word, and the
kernel then faults (or worse, writes elsewhere) on the card.  This check
reads each ``extern "C"`` declaration in ``csrc/*.cu`` and needs no
``nvcc``, so it runs wherever the tests do.
"""
import ctypes
import re

import pytest

from repro_torch.kernels import _build

# C parameter type -> the ctypes type that carries it
C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
           "float": ctypes.c_float}
EXTERN_C = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


def _declared(name: str):
    """``{function: [ctypes type per parameter]}`` of ``csrc/<name>.cu``."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    out = {}
    for fn, params in EXTERN_C.findall(src):
        types = []
        for p in params.split(","):
            p = " ".join(p.split())
            if "*" in p:
                types.append(ctypes.c_void_p)
                continue
            ctype = re.sub(r"^const\s+", "", p).rsplit(" ", 1)[0]
            assert ctype in C_TYPES, f"{name}.cu {fn}: parameter {p!r}"
            types.append(C_TYPES[ctype])
        out[fn] = types
    return out


def test_every_source_has_a_signature():
    sources = {p.stem for p in _build.CSRC.glob("*.cu")}
    assert sources == set(_build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signature_matches_extern_c(name):
    declared = _declared(name)
    assert set(declared) == set(_build.SIGNATURES[name])
    for fn, argtypes in _build.SIGNATURES[name].items():
        got = [t.__name__ for t in argtypes]
        want = [t.__name__ for t in declared[fn]]
        assert got == want, f"{name}.cu {fn}: ctypes {got}, C {want}"
