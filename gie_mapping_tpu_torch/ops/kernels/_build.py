"""Build and load the port's hand-written CUDA kernels.

The sources in gie_mapping_tpu_torch/csrc/ compile with nvcc into ONE shared
library with a plain C interface, loaded with ctypes.  The build happens at
first use (never at import: this module is imported on machines without a
GPU or a CUDA toolkit) into gie_mapping_tpu_torch/build/, under a name that
hashes the sources and flags, so an edited source rebuilds and an unchanged
one loads the cached library.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("phase1.cu", "envelope.cu", "carve.cu")
HEADERS = ("common.cuh",)
# --fmad=false: no multiply-add contraction anywhere; the carve's exactness
# depends on every rounding step (see csrc/carve.cu).  -Xptxas=-v prints
# registers and spills per kernel into the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
SIGNATURES = {
    "gie_phase1_packed": (_P, _P, _I, _I, _I, _I, _I, _P),
    "gie_envelope_packed": (_P, _P, _P, _I, _L, _I, _I, _P),
    "gie_envelope_mid": (_P, _P, _P, _P, _I, _I, _L, _I, _P),
    "gie_carve": (_P, _P, _P, _P, _P) + (_I,) * 6 + (_F,) * 4 + (_I, _I)
                 + (_F,) * 6 + (_I, _I, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the port's CUDA kernels cannot be built")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libgie_kernels_{source_hash()}.so"


def build() -> tuple[Path, float]:
    """Compile the library if the cached one is missing.  Returns (path,
    seconds spent compiling; 0.0 when cached).  The log (ptxas register
    and spill report included) lands beside the library."""
    so = library_path()
    if so.exists():
        return so, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # compile to a private name, then rename: a concurrent build never loads
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
           *[str(CSRC / s) for s in SOURCES]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    log = so.with_suffix(".log")
    log.write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}); log: {log}\n"
                           + res.stderr[-4000:])
    os.replace(tmp, so)
    return so, time.perf_counter() - t0


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    return lib


def check(name: str, rc: int) -> None:
    """Raise if a kernel launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def stream_of(t) -> int:
    """The current CUDA stream of a tensor's device, as a raw handle."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
