"""Build and load the hand-written CUDA kernels of ``csrc/``.

One ``nvcc`` call compiles every ``csrc/*.cu`` for ``sm_90a`` into a shared
library with a plain C interface, which is loaded with ``ctypes`` (no
PyTorch headers, so the build takes seconds, not minutes). The library is
named by a hash of the sources and the flags and written to ``build/``
beside ``csrc/`` (git-ignored), so a changed source rebuilds and an
unchanged one is reused within a checkout. Nothing is built on import: the
first wrapper call that meets a CUDA tensor builds.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"

# -fmad=false: no multiply-add is contracted behind the source's back, so
# every expression rounds as written and matches the plain PyTorch version
# (which materialises each elementwise op); the crop kernel's explicit
# fmaf() is unaffected by the flag.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# C entry point → argtypes; every one returns a cudaError_t as int
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    # frames, sx, sy, fidx, out, N, B, H, W, C, out_h, out_w, dtype, stream
    "mdcv_roi_crop": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # logits, xv, yv, probs, pts, M, HW, dtype, stream
    "mdcv_softargmax": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # boxes, scores, keys, out_boxes, out_scores, out_idx, out_keep,
    # B, N, k, conf, overlap, stream
    "mdcv_nms_topk": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _P),
}

DTYPE_CODES = {"float32": 0, "bfloat16": 1}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


@dataclasses.dataclass
class BuildInfo:
    """What the last build did: library path, whether nvcc ran, its
    seconds and its output (``-Xptxas -v``: registers, spills)."""

    path: Path | None = None
    built: bool = False
    seconds: float = 0.0
    log: str = ""


build_info = BuildInfo()


def build() -> Path:
    """Compile ``csrc/*.cu`` into ``build/libmdcv_kernels-<hash>.so``
    unless that file exists; returns its path."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = BUILD / f"libmdcv_kernels-{h.hexdigest()[:16]}.so"
    build_info.path = out
    if out.exists():
        build_info.built = False
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cu = [str(s) for s in srcs if s.suffix == ".cu"]
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), *cu]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_info.seconds = time.perf_counter() - t0
    build_info.log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{build_info.log}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    build_info.built = True
    return out


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    dll = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(dll, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    dll.mdcv_error_string.argtypes = [ctypes.c_int]
    dll.mdcv_error_string.restype = ctypes.c_char_p
    return dll


def check(code: int, what: str) -> None:
    if code != 0:
        msg = lib().mdcv_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def dtype_code(dtype) -> int:
    name = str(dtype).removeprefix("torch.")
    if name not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
    return DTYPE_CODES[name]


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
