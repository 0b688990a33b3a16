"""Build and load the port's native host library (native/src/gie_host.cpp).

The C++ source is a copy of the JAX package's (its comments aside;
tests/test_torch_native.py holds the two equal): DBSCAN with AABB
extraction for the external-observer channel, the multi-ring cloud ->
range-ring conversion, the 1-NN ground-truth checker and a voxel-block
mirror store, behind a plain C interface loaded with ctypes.

It is compiled at first use (never at import) with g++ and the JAX
package's flags into gie_mapping_tpu_torch/build/, under a name that hashes
the source and the flags, so an edited source rebuilds and an unchanged one
loads the cached library.  The library is written under a private name and
renamed into place, so concurrent first uses never load a half-written
file.  A failed build raises with g++'s output: the port has no numpy
fallback, because the fallbacks round differently (cloud_to_rings would
bin by numpy's arctan2 in float64).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "native" / "src" / "gie_host.cpp"
BUILD_DIR = _PKG / "build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_F = ctypes.POINTER(ctypes.c_float)
_I32 = ctypes.POINTER(ctypes.c_int32)
_I16 = ctypes.POINTER(ctypes.c_int16)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_I8 = ctypes.POINTER(ctypes.c_int8)
_H = ctypes.c_void_p
_int, _float = ctypes.c_int, ctypes.c_float
# name: (restype, argtypes) of the nine entry points
SIGNATURES = {
    "gie_gt_check": (_int, (_F, _int, _F, _int, _F, _F)),
    "gie_dbscan_aabb": (_int, (_F, _int, _float, _int, _int, _F, _int, _I32)),
    "gie_cloud_to_rings": (None, (_F, _I32, _int, _int, _int, _float, _float,
                                  _F)),
    "gie_mirror_new": (_H, ()),
    "gie_mirror_free": (None, (_H,)),
    "gie_mirror_size": (_int, (_H,)),
    "gie_mirror_ingest": (None, (_H, _I32, _U8, _I8, _I32, _I16, _int)),
    "gie_mirror_extract_cloud": (_int, (_H, ctypes.c_int8, _float, _F, _int)),
    "gie_mirror_extract_edt": (_int, (_H, ctypes.c_int32, _float, _F, _F,
                                      _int)),
}


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libgie_host_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless the cached one exists; returns its path.
    Raises RuntimeError with the compiler's output when g++ fails."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", tmp]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=240)
        except (OSError, subprocess.TimeoutExpired) as exc:
            raise RuntimeError(f"g++ could not build {SOURCE.name}: {exc}") from exc
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE.name} ({res.returncode}):\n"
                               + (res.stdout + res.stderr)[-4000:])
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


@functools.lru_cache(maxsize=1)
def get_lib() -> ctypes.CDLL:
    """The loaded native library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, (res, args) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = list(args)
    return lib


def ptr(arr, ctype=ctypes.c_float):
    """A ctypes pointer to a C-contiguous numpy array (kept alive by the
    caller)."""
    assert arr.flags["C_CONTIGUOUS"]
    return arr.ctypes.data_as(ctypes.POINTER(ctype))
