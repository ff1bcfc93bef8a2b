"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a``; the objects are linked into one ``libmapple_kernels.so``
with a plain C interface, loaded with ``ctypes``. The build runs at first
use, from the sources in the package only, into
``<repo>/build/kernels/<hash of the sources and flags>/``, so an edited
source rebuilds and an unchanged one loads the library already there.

Only a launch on a CUDA tensor needs the library: importing this module
builds nothing, and machines without ``nvcc`` import it all the same.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("matmul.cu", "stencil.cu", "segment_reduce.cu", "flash_attention.cu",
           "flash_attention_bf16.cu", "mamba_scan.cu", "causal_conv.cu", "wkv6.cu",
           "errors.cu")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "libmapple_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
CFLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> argument types of each C entry point (all return an int error).
_VP, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
SIGNATURES = {
    "mapple_matmul_f32": (_VP, _VP, _VP, _I, _I, _I, _I, _VP),
    "mapple_matmul_bf16": (_VP, _VP, _VP, _I, _I, _I, _I, _VP),
    "mapple_stencil_f32": (_VP, _VP, _I, _I, _I, _I, _I, _I, _VP),
    "mapple_segment_rowmax_f32": (_VP, _VP, _I64, _I64, _I, _VP),
    "mapple_segment_rowmax_f64": (_VP, _VP, _I64, _I64, _I, _VP),
    # q, k, v, o, strides (12 x int64 on the host), B, S, H, Kv, d, scale,
    # window, causal, stream
    "mapple_flash_attention_f32": (_VP,) * 5 + (_I,) * 5 + (_F, _I, _I, _VP),
    "mapple_flash_attention_bf16": (_VP,) * 5 + (_I,) * 5 + (_F, _I, _I, _VP),
    # xs, dt, Bs, Cs, A, y, state, B, T, di, n, stream
    "mapple_mamba_scan_f32": (_VP,) * 7 + (_I,) * 4 + (_VP,),
    # xs, dt, Bs, Cs, A, dt_bias, D, z, y, state, row strides (5 x int64 on
    # the host), B, T, di, n, dtype (0 fp32, 1 bf16), stream
    "mapple_mamba_scan_gated": (_VP,) * 11 + (_I,) * 5 + (_VP,),
    # x, k, tail, y, tail out, x's row stride, B, T, di, W, dtype, stream
    "mapple_causal_conv_silu": (_VP,) * 5 + (_I64,) + (_I,) * 5 + (_VP,),
    # r, k, v, w, u, y, state, strides (12 x int64 on the host), B, T, H, N,
    # stream
    "mapple_wkv6_f32": (_VP,) * 8 + (_I,) * 4 + (_VP,),
    # state or head size, then out: registers per thread, resident warps per SM
    "mapple_mamba_scan_occupancy": (_I, _VP, _VP),
    "mapple_wkv6_occupancy": (_I, _VP, _VP),
}


@dataclasses.dataclass(frozen=True)
class Library:
    """The loaded kernels plus what their build reported."""

    lib: ctypes.CDLL
    path: Path
    seconds: float          # wall time of this process's build; 0.0 if cached
    log: str                # nvcc's output (register and spill counts)


_LOCK = threading.Lock()
_LOADED: Library | None = None


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "the CUDA kernels need nvcc to build: none under $CUDA_HOME/bin, "
            "/usr/local/cuda/bin or on PATH"
        )
    return found


def source_digest() -> str:
    h = hashlib.sha256()
    for flag in ARCH_FLAGS + CFLAGS:
        h.update(flag.encode() + b"\0")
    for name in SOURCES:
        h.update(name.encode() + b"\0")
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, out_dir: Path) -> str:
    """nvcc once per source, all in parallel, then one link."""
    procs = []
    for name in SOURCES:
        obj = out_dir / (Path(name).stem + ".o")
        cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for name, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {name}\n{out}")
        if proc.returncode:
            failed.append(name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out_dir / LIB_NAME),
         *(str(obj) for _, obj, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode:
        raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
    return "\n".join(log)


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.mapple_error_string.argtypes = (ctypes.c_int,)
    lib.mapple_error_string.restype = ctypes.c_char_p
    return lib


def load() -> Library:
    """Build the kernels if this source tree has not been built, then load."""
    global _LOADED
    with _LOCK:
        if _LOADED is not None:
            return _LOADED
        target = BUILD_ROOT / source_digest()
        lib_path = target / LIB_NAME
        seconds = 0.0
        if not lib_path.exists():
            t0 = time.perf_counter()
            BUILD_ROOT.mkdir(parents=True, exist_ok=True)
            tmp = Path(tempfile.mkdtemp(prefix="partial-", dir=BUILD_ROOT))
            try:
                (tmp / "build.log").write_text(_compile(nvcc_path(), tmp))
                try:
                    tmp.rename(target)     # atomic: readers see all or nothing
                except OSError:
                    if not lib_path.exists():   # not a concurrent winner
                        raise
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            seconds = time.perf_counter() - t0
        log_path = target / "build.log"
        log = log_path.read_text() if log_path.exists() else ""
        _LOADED = Library(_bind(lib_path), lib_path, seconds, log)
        return _LOADED


def check(lib: Library, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err:
        name = lib.lib.mapple_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {name} (cudaError {err})")
