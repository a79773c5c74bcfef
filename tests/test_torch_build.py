"""The kernel library's C interface against its ctypes mirror in
ops/_build.py, read from the csrc/*.cu sources on the CPU: a stale
argtypes list passes every CPU test and misreads its arguments only on the
card."""

import ctypes
import re
import types

import pytest

from raytracinggrff_tpu_torch.ops import _build

# return type and parameters of every extern "C" function
ENTRY = re.compile(r'extern "C" (int|const char\*) (\w+)\(([^)]*)\)')


def _c_entries():
    """{name: (return type, [parameter types])} of every extern "C"
    function in csrc/*.cu."""
    entries = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for ret, name, params in ENTRY.findall(src.read_text()):
            entries[name] = (ret, [" ".join(p.split()[:-1]).replace(" *", "*")
                                   for p in params.split(",") if p.strip()])
    return entries


ENTRIES = _c_entries()


def _ctype(c_type):
    """The ctypes type that passes a parameter or return of C type
    `c_type`: pointers to void as c_void_p, a params struct by value as
    its mirror, by pointer as a POINTER to it."""
    if c_type in ("void*", "const void*"):
        return ctypes.c_void_p
    if c_type == "int":
        return ctypes.c_int
    if c_type == "const char*":
        return ctypes.c_char_p
    struct = getattr(_build, "_" + c_type.removeprefix("const ").rstrip("*"))
    return ctypes.POINTER(struct) if c_type.endswith("*") else struct


class _Recorder:
    """A stand-in for ctypes.CDLL that records the attributes load_library
    sets on each entry."""

    def __init__(self, path):
        self.entries = {}

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return self.entries.setdefault(name, types.SimpleNamespace())


@pytest.fixture
def declared(monkeypatch):
    monkeypatch.setattr(_build.ctypes, "CDLL", _Recorder)
    return _build.load_library("librgrff_kernels.so").entries


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_load_library_declares_each_c_entry_as_its_source(declared, entry):
    """load_library gives the entry one argtype a parameter of the source,
    each the ctypes type of the parameter's C type, and its return type."""
    ret, params = ENTRIES[entry]
    assert entry in declared
    assert declared[entry].argtypes == [_ctype(p) for p in params]
    assert declared[entry].restype is _ctype(ret)


def test_load_library_declares_no_entry_the_sources_lack(declared):
    """The entries load_library declares are exactly the extern "C"
    functions of the sources: it declares none that they lack."""
    assert set(declared) == set(ENTRIES)


def _struct_fields(src, struct):
    """[(field, C type)] of `struct` in the source text `src`, in order."""
    body = re.search(rf"struct {struct} \{{[^\n]*\n(.*?)\n\}};", src,
                     re.S).group(1)
    fields = []
    for ctype, names in re.findall(r"^\s*(\w+) ([^;]+);", body, re.M):
        fields += [(name.strip(), ctype) for name in names.split(",")]
    return fields


def _mirror_fields(mirror):
    base = {ctypes.c_int: "int", ctypes.c_float: "float"}
    return [(name, base[ct]) for name, ct in mirror._fields_]


def test_trace_params_mirror_the_cuda_struct():
    """ops/_build._TraceParams lists the fields of struct TraceParams in
    csrc/trace_segment.cu in its order and C types."""
    src = (_build.CSRC / "trace_segment.cu").read_text()
    assert _struct_fields(src, "TraceParams") == _mirror_fields(
        _build._TraceParams)


def test_pack_params_mirror_the_cuda_struct():
    """ops/_build._PackParams lists the fields of struct PackParams, the
    parameters of rgrff_pack_trace_inputs in csrc/trace_segment.cu, in its
    order and C types."""
    src = (_build.CSRC / "trace_segment.cu").read_text()
    assert _struct_fields(src, "PackParams") == _mirror_fields(
        _build._PackParams)
