"""``strided_map``: one strided gather with an elementwise op or a
per-program sum — counterpart of the JAX repository's copy, DMA, quantize,
compare and block-sum probes (``tools/probe_mosaic*.py``,
``probe_crop_kernel.py`` P20, ``probe_crop_dma.py``, ``reprobe.py``).

``src`` is a strided view (rank ≤ 4; its shape is the output's, dim 0 the
"program"); element ``(i0, …)`` is read at the view's own offset plus
``Σ idx[i0]·t`` over up to three ``index`` pairs ``(idx (P,) int, t)`` —
the per-program base of a DMA window. The op is one of

- ``copy``: the element (any dtype; the bytes are moved);
- ``scale``: ``dtype(f32(x)·c)``;
- ``quantize``: ``int8(clip(rint(f32(x)·c), −127, 127))``, NaN → 0;
- ``compare``: ``x > 0 → 1/0`` in ``out_dtype``;
- ``sum``: ``out[i0] = Σ f32(x)`` over program i0's block.

:func:`strided_map` launches ``csrc/strided_map.cu`` for CUDA tensors and
takes :func:`strided_map_plain` for CPU ones. Copies and maps agree bit for
bit; sums are taken in each version's own order, within
:data:`SUM_RTOL` of the exact sum of |x| for int8 input. A base that puts
an element outside ``src``'s storage is refused: the plain version raises
IndexError, the kernel traps (the launch fails, and the error surfaces at
the next synchronisation).
"""

from __future__ import annotations

import ctypes
import math

import torch

from mit_driverless_cv_traininginfra_tpu_torch.ops import _lib

OPS = {"copy": 0, "scale": 1, "quantize": 2, "compare": 3, "sum": 4}
CHUNK = 65536      # elements per reduce block (csrc/strided_map.cu kChunk)
# Rests on int8 input, which every block-sum probe sums: the kernel's
# 65 536-value partials are integers below 2²⁴, exact in f32, and only its
# final 256-wide tree over the partials rounds (≤ 8·2⁻²⁴·Σ|x| ≈
# 4.8e-7·Σ|x|); torch's sum of int8 likewise rounds only near the top of its
# tree. Read on the H100: max |d| 32 on Q18's Σ|x| of 3.0e8 (PERF.md §6).
# Not derived for bf16 or f32 input, whose every addition may round.
SUM_RTOL = 1e-6


def _default_out_dtype(src, op: str):
    return {"quantize": torch.int8, "sum": torch.float32}.get(op, src.dtype)


def _gather(src, index):
    """The values :func:`strided_map` reads: ``src`` itself, or with index
    pairs its offsets plus each program's base, gathered from the storage."""
    if not index:
        return src
    storage = src.as_strided((src.untyped_storage().nbytes() // src.element_size(),),
                             (1,), 0)
    offs = torch.full(src.shape, src.storage_offset(), dtype=torch.int64,
                      device=src.device)
    for d, (n, s) in enumerate(zip(src.shape, src.stride())):
        shape = [1] * src.dim()
        shape[d] = n
        offs = offs + torch.arange(n, device=src.device).reshape(shape) * s
    for idx, t in index:
        offs = offs + (idx.long() * t).reshape((-1,) + (1,) * (src.dim() - 1))
    lo, hi = torch.stack(torch.aminmax(offs)).tolist() if offs.numel() else (0, -1)
    if lo < 0 or hi >= storage.numel():
        raise IndexError(f"strided_map reads offsets {lo}..{hi} of a storage of "
                         f"{storage.numel()} elements")
    return storage[offs]


def strided_map_plain(src, op: str = "copy", c: float = 1.0, index=(),
                      out=None, out_dtype=None):
    """Plain version of :func:`strided_map` in torch ops."""
    out_dtype = out_dtype or _default_out_dtype(src, op)
    x = _gather(src, index)
    if op == "copy":
        y = x.clone(memory_format=torch.contiguous_format)
    elif op == "scale":
        y = (x.float() * c).to(out_dtype)
    elif op == "quantize":
        q = torch.clamp(torch.round(x.float() * c), -127, 127)
        y = torch.where(torch.isnan(q), torch.zeros_like(q), q).to(out_dtype)
    elif op == "compare":
        y = (x > 0).to(out_dtype)
    elif op == "sum":
        y = x.reshape(x.shape[0], -1).float().sum(1)
    else:
        raise ValueError(f"op must be one of {list(OPS)}, got {op!r}")
    if out is None:
        return y
    out.copy_(y)
    return out


def _rank4(shape, strides):
    """Dim 0 (the programs) kept first, inner dims padded to three."""
    pad = 4 - len(shape)
    return ([shape[0]] + [1] * pad + list(shape[1:]),
            [strides[0]] + [0] * pad + list(strides[1:]))


def _dense_inner(dims, strides) -> bool:
    expect = 1
    for d in (3, 2, 1):
        if dims[d] != 1 and strides[d] != expect:
            return False
        expect *= dims[d]
    return True


def strided_map(src, op: str = "copy", c: float = 1.0, index=(), out=None,
                out_dtype=None):
    """See the module docstring. ``out``: an optional output view of the
    output's shape (any strides), written and returned. CUDA kernel for
    CUDA tensors, :func:`strided_map_plain` for CPU ones."""
    if not src.is_cuda:
        return strided_map_plain(src, op, c, index, out, out_dtype)
    if op not in OPS:
        raise ValueError(f"op must be one of {list(OPS)}, got {op!r}")
    if not 1 <= src.dim() <= 4 or len(index) > 3:
        raise ValueError(f"rank 1..4 and ≤ 3 index arrays, got {src.dim()}, {len(index)}")
    out_dtype = out_dtype or _default_out_dtype(src, op)
    P = src.shape[0]
    out_shape = (P,) if op == "sum" else tuple(src.shape)
    if out is None:
        out = torch.empty(out_shape, dtype=out_dtype, device=src.device)
    if tuple(out.shape) != out_shape or out.dtype != out_dtype or out.device != src.device:
        raise ValueError(f"out must be {out_shape} {out_dtype} on {src.device}, got "
                         f"{tuple(out.shape)} {out.dtype} on {out.device}")
    idx = [(i.to(torch.int32).contiguous(), int(t)) for i, t in index]
    if any(i.shape != (P,) or i.device != src.device for i, _ in idx):
        raise ValueError(f"each index array must be ({P},) on {src.device}")
    dims, strides = _rank4(list(src.shape), list(src.stride()))
    ostr = (_rank4(list(out.shape), list(out.stride()))[1] if op != "sum"
            else [0, 0, 0, 0])
    ts = [t for _, t in idx] + [0] * (3 - len(idx))
    n_block = math.prod(dims[1:])
    chunks = (n_block + CHUNK - 1) // CHUNK
    extent = src.untyped_storage().nbytes() // src.element_size()
    params = (ctypes.c_longlong * 19)(*dims, *strides, *ostr, *ts, chunks,
                                      int(_dense_inner(dims, strides)),
                                      -src.storage_offset(),
                                      extent - src.storage_offset())
    partial = (torch.empty(P * chunks, dtype=torch.float32, device=src.device)
               if op == "sum" else None)
    ptrs = [i.data_ptr() for i, _ in idx] + [None] * (3 - len(idx))
    with torch.cuda.device(src.device):
        rc = _lib.lib().mdcv_strided_map(
            src.data_ptr(), out.data_ptr(), *ptrs, ctypes.addressof(params),
            _lib.dtype_code(src.dtype), _lib.dtype_code(out_dtype), OPS[op],
            float(c), None if partial is None else partial.data_ptr(),
            _lib.stream_ptr(src.device))
    _lib.check(rc, f"strided_map {op}")
    strided_map.launches += 1
    return out


strided_map.launches = 0
