"""Build and load the hand-written CUDA kernels of ``csrc/``.

One ``nvcc`` per ``csrc/*.cu``, all started together, compiles for
``sm_90a``, and one more links the objects into a shared library with a
plain C interface, which is loaded with ``ctypes`` (no
PyTorch headers, so the build takes seconds, not minutes). The library is
named by a hash of the sources and the flags and written to ``build/``
beside ``csrc/`` (git-ignored), so a changed source rebuilds and an
unchanged one is reused within a checkout. Nothing is built on import: the
first wrapper call that meets a CUDA tensor builds.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error.
"""

from __future__ import annotations

import contextlib
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
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
SIGNATURES = {
    # frames, boxes, box strides (2), box dtype, fidx, fidx stride, fidx
    # dtype, out, N, B, H, W, C, out_h, out_w, dtype, stream
    "mdcv_roi_crop": (_P, _P, _L, _L, _I, _P, _L, _I, _P, _I, _I, _I, _I, _I,
                      _I, _I, _I, _P),
    # logits, xs, ys, probs, pts, M, h, w, dtype, stream
    "mdcv_softargmax": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # boxes, scores, out_boxes, out_scores, out_idx, out_keep,
    # B, N, k, conf, overlap, stream
    "mdcv_nms_topk": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _P),
    # hq, w2, w2_scale, w2_b, w1x1, w1x1_scale, w1x1_b, w3, w3_scale,
    # w3_b, sx, out, B, H, W, slope, dtype, stream
    "mdcv_entry_block": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _F, _I, _P),
    # x, w1, s1, b1, w3, s3, b3, sx1, sx3, sx_out, ybf, yq, tq,
    # B, S, C, n_blocks, slope, dtype, stream
    "mdcv_res_stage": (_P,) * 13 + (_I, _I, _I, _I, _F, _I, _P),
    # probs, g_probs (or null), g_pts, xs, ys, dz, M, h, w, dtype, stream
    "mdcv_softargmax_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # x, w_nk, scale, bias, sx_inv, out, C, H, W, Cin, N, dilation, dtype,
    # stream
    "mdcv_tail_conv": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # frames, fidx, r0, l0, sx, out, n, B, H, WF, rows, M, win_w, ch, stream
    "mdcv_window_resample": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _I, _P),
    # a, b, scale (or null), out, M, N, K, sam, sak, sbk, sbn, A's and B's
    # staging modes, out dtype, stream
    "mdcv_int8_contract": (_P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _L, _I, _I,
                           _I, _P),
    # src, out, idx0, idx1, idx2, params (host int64[20]), in dtype,
    # out dtype, op, c, partial sums (reduce mode), stream
    "mdcv_strided_map": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P, _P),
}

# each kernel checks the code it is given and refuses the others
DTYPE_CODES = {"float32": 0, "bfloat16": 1, "int8": 2, "int32": 3}
_CODE_OF = {getattr(torch, k): v for k, v in DTYPE_CODES.items()}


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
    nvcc, compile_flags = _nvcc(), [f for f in NVCC_FLAGS if f != "-shared"]
    t0 = time.perf_counter()
    # one nvcc per source, all started together, then one link
    objs, procs = [], []
    for s in (s for s in srcs if s.suffix == ".cu"):
        obj = BUILD / f"{s.stem}.{os.getpid()}.o"
        cmd = [nvcc, *compile_flags, "-I", str(CSRC), "-c", "-o", str(obj), str(s)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
        objs.append(str(obj))
    link = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *objs]
    steps = [(cmd, p.communicate()[0], p.returncode) for cmd, p in procs]
    if all(rc == 0 for _, _, rc in steps):
        proc = subprocess.run(link, capture_output=True, text=True)
        steps.append((link, proc.stdout + proc.stderr, proc.returncode))
    for obj in objs:
        Path(obj).unlink(missing_ok=True)
    build_info.seconds = time.perf_counter() - t0
    build_info.log = "".join(log for _, log, _ in steps)
    for cmd, log, rc in steps:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{log}")
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
    code = _CODE_OF.get(dtype)
    if code is None:
        raise TypeError(f"kernels take {', '.join(DTYPE_CODES)}, got {dtype}")
    return code


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def on_device(device):
    """``torch.cuda.device(device)``, or nothing when ``device`` is already
    the current one (entering the context costs microseconds a call)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
