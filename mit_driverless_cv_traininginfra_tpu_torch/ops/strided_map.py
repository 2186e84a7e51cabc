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
takes :func:`strided_map_plain` for CPU ones. A map runs on one of three
kernels, which :func:`pick_path` names once per call from the strides:
``rows`` (the inner dim contiguous in input and output: 16 bytes a
thread), ``transpose`` (the input's unit dim is not the output's: tiles
through shared memory) or ``generic`` (one element a thread). Copies and
maps agree bit for bit; sums are taken in each version's own order, within
:data:`SUM_RTOL` of the exact sum of |x| for int8 input. A base that puts
an element outside ``src``'s storage is refused: the plain version raises
IndexError, the kernel traps (the launch fails, and the error surfaces at
the next synchronisation).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from mit_driverless_cv_traininginfra_tpu_torch.ops import _lib

OPS = {"copy": 0, "scale": 1, "quantize": 2, "compare": 3, "sum": 4}
PATHS = {"rows": 0, "transpose": 1, "generic": 2, "sum": 3}
# below this many elements a transposed copy is cheaper one element a
# thread than through shared-memory tiles (H100, device ms, each pair from
# one call, PERF.md §6: T1a's 26 624 int32 0.00215 tiled against 0.00171
# one element a thread; T1c's 212 992 bf16 0.00238 tiled against 0.00316)
TILED_MIN = 1 << 16
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


def pick_path(op: str, shape, strides, out_strides, indexed: bool):
    """The kernel a call runs and the rank-4 (dims, input strides, output
    strides) it is given. Sums keep the view's dims (dim 0 the programs).
    A map drops size-1 dims, orders the rest by output stride (dim 0 stays
    first where index arrays give it a base), merges neighbours contiguous
    in both input and output, and takes

    - ``rows`` where the inner dim has unit stride in both;
    - ``transpose`` where the output's inner dim has unit stride and
      another dim has it in the input (no index arrays, from
      :data:`TILED_MIN` to 2³¹ elements): that dim is put second to last;
    - ``generic`` otherwise."""
    if op == "sum":
        dims, s = _rank4(list(shape), list(strides))
        return "sum", dims, s, [0, 0, 0, 0]
    triples = list(zip(shape, strides, out_strides))
    lead = [triples.pop(0)] if indexed else []
    triples = sorted((t for t in triples if t[0] != 1), key=lambda t: -t[2])
    merged = []
    for d, s, o in triples:
        if merged and merged[-1][1] == s * d and merged[-1][2] == o * d:
            merged[-1] = (merged[-1][0] * d, s, o)
        else:
            merged.append((d, s, o))
    if not merged:
        merged = [(1, 1, 1)]
    path = "generic"
    if merged[-1][1] == 1 and merged[-1][2] == 1:
        path = "rows"
    elif (merged[-1][2] == 1 and not indexed
          and TILED_MIN <= math.prod(t[0] for t in merged) < 2 ** 31):
        units = [i for i, t in enumerate(merged[:-1]) if t[1] == 1]
        if units:
            path = "transpose"
            unit = merged.pop(units[-1])
            merged.insert(len(merged) - 1, unit)
    full = lead + [(1, 0, 0)] * (4 - len(lead) - len(merged)) + merged
    return path, [t[0] for t in full], [t[1] for t in full], [t[2] for t in full]


def path_of(src, op: str = "copy", out=None, index=()) -> str:
    """The kernel :func:`strided_map` runs for these arguments."""
    out_strides = out.stride() if out is not None else tuple(
        math.prod(src.shape[d + 1:]) for d in range(src.dim()))
    return pick_path(op, tuple(src.shape), src.stride(), out_strides, bool(index))[0]


@functools.lru_cache(maxsize=4096)
def _params(op: str, shape, strides, out_strides, ts, lo: int, hi: int):
    """The kernel's int64 parameter block for one shape of call, built once
    (kept alive by the cache) and passed by address."""
    path, dims, s, o = pick_path(op, shape, strides, out_strides, bool(ts))
    n_block = math.prod(dims[1:])
    block = (ctypes.c_longlong * 20)(
        *dims, *s, *o, *ts, *[0] * (3 - len(ts)), (n_block + CHUNK - 1) // CHUNK,
        int(_dense_inner(dims, s)), lo, hi, PATHS[path])
    return block, ctypes.addressof(block)


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
    lo = hi = 0
    if index:
        idx = [(i.to(torch.int32).contiguous(), int(t)) for i, t in index]
        if any(i.shape != (P,) or i.device != src.device for i, _ in idx):
            raise ValueError(f"each index array must be ({P},) on {src.device}")
        ptrs = [i.data_ptr() for i, _ in idx] + [None] * (3 - len(idx))
        ts = tuple(t for _, t in idx)
    else:
        ptrs, ts = [None, None, None], ()
    if index or op == "sum":  # the kernels check these programs' spans
        lo = -src.storage_offset()
        hi = src.untyped_storage().nbytes() // src.element_size() + lo
    _, params = _params(op, tuple(src.shape), src.stride(),
                        None if op == "sum" else out.stride(), ts, lo, hi)
    partial = (torch.empty(P * ((math.prod(src.shape[1:]) + CHUNK - 1) // CHUNK),
                           dtype=torch.float32, device=src.device)
               if op == "sum" else None)
    with _lib.on_device(src.device):
        rc = _lib.lib().mdcv_strided_map(
            src.data_ptr(), out.data_ptr(), *ptrs, params,
            _lib.dtype_code(src.dtype), _lib.dtype_code(out_dtype), OPS[op],
            float(c), None if partial is None else partial.data_ptr(),
            _lib.stream_ptr(src.device))
    _lib.check(rc, f"strided_map {op}")
    strided_map.launches += 1
    return out


strided_map.launches = 0
