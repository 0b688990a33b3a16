"""Build and load the port's hand-written CUDA kernels.

The sources in gie_mapping_tpu_torch/csrc/ compile with nvcc, one process per
source, all started together, and link into ONE shared library with a plain
C interface, loaded with ctypes.  The build happens at
first use (never at import: this module is imported on machines without a
GPU or a CUDA toolkit) into gie_mapping_tpu_torch/build/, under a name that
hashes the sources and flags, so an edited source rebuilds and an unchanged
one loads the cached library.
"""
from __future__ import annotations

import contextlib
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
SOURCES = ("phase1.cu", "envelope.cu", "carve.cu", "shift.cu", "blockrows.cu")
HEADERS = ("common.cuh",)
# --fmad=false: no multiply-add contraction anywhere; the carve's exactness
# depends on every rounding step (see csrc/carve.cu).  -Xptxas=-v prints
# registers and spills per kernel into the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_B = ctypes.c_char_p  # a packed argument buffer (bytes)
SIGNATURES = {
    "gie_phase1_packed": (_P, _P, _I, _I, _I, _I, _I, _I, _P),
    "gie_phase1_ctas_per_sm": (),
    "gie_envelope_packed": (_P, _P, _P, _I, _L, _I, _I, _P),
    "gie_envelope_mid": (_P, _P, _P, _P, _I, _I, _L, _I, _P),
    "gie_panorama": (_B, _I),
    "gie_carve": (_B, _I),
    "gie_shift_canvas": (_P, _P, _P) + (_I,) * 9 + (_P,),
    "gie_gather_block_rows": (_P, _P, _P) + (_I,) * 5 + (_P,),
    "gie_scatter_block_rows": (_P, _P, _P, _P) + (_I,) * 5 + (_P,),
    "gie_gather_archive_rows": (_P, _P, _P, _I, _I, _P),
    "gie_scatter_archive_rows": (_P, _P, _P, _P, _I, _I, _P),
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
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    log = so.with_suffix(".log")
    lines = []
    try:
        # one nvcc per source, all at once; then one link.  The library is
        # linked to a private name and renamed: a concurrent build never
        # loads a half-written library
        procs = []
        for src in SOURCES:
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o",
                   str(work / (src + ".o")), str(CSRC / src)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for cmd, p in procs:
            out, _ = p.communicate()
            lines += [" ".join(cmd), out]
            if p.returncode != 0:
                failed.append((cmd[-1], p.returncode, out))
        if not failed:
            tmp = work / "lib.so"
            cmd = [nvcc, "-shared", "-o", str(tmp),
                   *[str(work / (s + ".o")) for s in SOURCES]]
            res = subprocess.run(cmd, capture_output=True, text=True)
            lines += [" ".join(cmd), res.stdout + res.stderr]
            if res.returncode != 0:
                failed.append(("link", res.returncode, res.stderr))
        log.write_text("\n".join(lines))
        if failed:
            name, rc, out = failed[0]
            raise RuntimeError(f"nvcc failed on {name} ({rc}); log: {log}\n"
                               + out[-4000:])
        os.replace(tmp, so)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return so, time.perf_counter() - t0


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    from ...runtime import profiler

    with profiler.span("kernels.library"):
        so, _ = build()
        lib = ctypes.CDLL(str(so))
        for name, args in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def fn(name: str):
    """One entry point of the loaded library (looked up once)."""
    return getattr(library(), name)


def check(name: str, rc: int) -> None:
    """Raise if a kernel launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


_CURRENT = contextlib.nullcontext()


def on_device_of(t):
    """A context in which t's CUDA device is the current device.  A raw
    launch goes to the current device whatever the stream it is given, so
    every launch on a tensor of another device (a mesh shard, a mapper on
    "cuda:1") runs inside this; on the current device it is a no-op."""
    import torch

    idx = t.get_device()
    return _CURRENT if idx == torch.cuda.current_device() else \
        torch.cuda.device(idx)


def stream_of(t) -> int:
    """The current CUDA stream of a tensor's device, as a raw handle (no
    Stream object is built: this runs on every launch)."""
    return _raw_stream()(t.get_device())


@functools.lru_cache(maxsize=1)
def _raw_stream():
    """device index -> the current stream's raw handle.  PyTorch's CUDA
    builds export the one-call form that its own compiled kernels use;
    the public form builds a Stream object first."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return raw or (lambda i: torch.cuda.current_stream(i).cuda_stream)
