"""``int8_contract``: a strided int8 contraction into int32, with an
optional ``·scale[n]`` → bf16 epilogue — counterpart of the JAX
repository's int8 ``dot_general`` probes (``tools/probe_mosaic*.py`` P1,
P5, P7, P10, P11, P13, P13b, P13c, P16 and ``tools/reprobe.py``'s rank-3
contractions).

``out[m, n] = Σ_k a[m, k] · b[k, n]`` for ``a`` (M, K) and ``b`` (K, N)
int8 views with any strides (a transposed or flattened view of the probe's
array: one flat m covers the contractions over dim 0 and over the minor
dim). :func:`int8_contract` launches ``csrc/int8_contract.cu`` (the int8
tensor cores, ``mma.sync.m16n8k32``) for CUDA tensors and takes
:func:`int8_contract_plain` for CPU ones. The sums are exact, so both agree
bit for bit. :func:`staging_modes` decides once per call how the kernel
copies each operand into shared memory.
"""

from __future__ import annotations

import torch

from mit_driverless_cv_traininginfra_tpu_torch.ops import _lib


def int8_contract_plain(a, b, scale=None):
    """Plain version: an int64 matmul on the CPU, a float64 one on the card
    (torch has no CUDA integer matmul; |Σ| ≤ K·127² ≪ 2⁵³, so float64 is
    exact), then int32; with ``scale``, ``f32(acc)·scale`` → bf16."""
    if a.is_cuda:
        acc = (a.double() @ b.double()).to(torch.int32)
    else:
        acc = (a.long() @ b.long()).to(torch.int32)
    if scale is None:
        return acc
    return (acc.float() * scale.float().reshape(-1)).to(torch.bfloat16)


# how the kernel stages an operand's rows (m of A, n of B) into its
# K-contiguous shared tiles (csrc/int8_contract.cu Mode)
ROW16, ROW4, TRANS4, GATHER = 0, 1, 2, 3
MAX_K = 1024  # B's column tile, every K chunk, in shared memory


def staging_mode(addr: int, row_stride: int, k_stride: int) -> int:
    """The widest copy an operand's view allows: rows with unit k stride by
    16 or 4 bytes where the base and the row stride are that aligned, rows
    with unit row stride (A column-major, B N-major) as 4-byte words of 4
    rows transposed in registers where the base and the k stride are
    4-aligned, else byte by byte."""
    if k_stride == 1 and row_stride % 16 == 0 and addr % 16 == 0:
        return ROW16
    if k_stride == 1 and row_stride % 4 == 0 and addr % 4 == 0:
        return ROW4
    if row_stride == 1 and k_stride % 4 == 0 and addr % 4 == 0:
        return TRANS4
    return GATHER


def staging_modes(a, b) -> tuple[int, int]:
    """(A's mode, B's mode): A's rows are its m, B's its n."""
    (sam, sak), (sbk, sbn) = a.stride(), b.stride()
    return (staging_mode(a.data_ptr(), sam, sak), staging_mode(b.data_ptr(), sbn, sbk))


def int8_contract(a, b, scale=None):
    """a (M, K), b (K, N) int8 (any strides) → (M, N) int32, or with
    ``scale`` (N,) f32 the bf16 ``f32(acc)·scale``. CUDA kernel for CUDA
    tensors, :func:`int8_contract_plain` for CPU ones."""
    if not a.is_cuda:
        return int8_contract_plain(a, b, scale)
    M, K = a.shape
    K2, N = b.shape
    if K != K2 or a.dtype != torch.int8 or b.dtype != torch.int8 or not 1 <= K <= MAX_K:
        raise ValueError(f"int8 (M, K)·(K, N) with 1 ≤ K ≤ {MAX_K} expected, got "
                         f"{tuple(a.shape)} {a.dtype} · {tuple(b.shape)} {b.dtype}")
    if b.device != a.device or (scale is not None and scale.device != a.device):
        raise ValueError("a, b and scale must share a device")
    if scale is None:
        out = torch.empty((M, N), dtype=torch.int32, device=a.device)
        sc, code = None, _lib.dtype_code(torch.int32)
    else:
        sc = scale.float().reshape(-1).contiguous()
        if sc.shape != (N,):
            raise ValueError(f"scale must hold N={N} values, got {tuple(scale.shape)}")
        out = torch.empty((M, N), dtype=torch.bfloat16, device=a.device)
        code = _lib.dtype_code(torch.bfloat16)
    (sam, sak), (sbk, sbn) = a.stride(), b.stride()
    pa, pb = a.data_ptr(), b.data_ptr()
    with _lib.on_device(a.device):
        rc = _lib.lib().mdcv_int8_contract(
            pa, pb, None if sc is None else sc.data_ptr(), out.data_ptr(), M, N, K,
            sam, sak, sbk, sbn, staging_mode(pa, sam, sak), staging_mode(pb, sbn, sbk),
            code, _lib.stream_ptr(a.device))
    _lib.check(rc, "int8_contract")
    int8_contract.launches += 1
    return out


int8_contract.launches = 0
