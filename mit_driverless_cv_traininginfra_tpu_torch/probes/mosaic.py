"""The Mosaic probes (counterparts of the JAX repository's
``tools/probe_mosaic.py`` … ``probe_mosaic7.py`` and of ``tools/reprobe.py``'s
two ``pl.pallas_call`` sites), each on ``int8_contract`` or ``strided_map``.

Each builder draws the probe's arrays with numpy in the probe's order
(``default_rng(0)``; ``integers(-127, 127)`` gives [−127, 126]). Draws the
probe spends on B=128 XLA timings the port does not run are skipped with
``bit_generator.advance`` (one 64-bit step per ``random()`` double). The
B=128 inputs of the stream probes (Q5, Q8, Q16–Q18) are made on the device
from a seeded torch generator in the probe's layout and value range: their
probes check no values, and numpy would take gigabytes for them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mit_driverless_cv_traininginfra_tpu_torch.probes.base import (
    Probe,
    bf16_from,
    contract_work,
    copy_work,
    device_int8,
    device_uniform_bf16,
    indexed_copy,
    int8_draw,
    map_work,
    nbytes,
    sum_work,
)

B_STREAM = 128          # the stream probes' grid
B_SMALL = 2             # their batch in the CPU tests


def _f32(rng, shape, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)


def _copy(x_of):
    return lambda inp, ops: ops.strided_map(x_of(inp))


def _clone_lib(x_of):
    return lambda inp: (lambda: x_of(inp).clone(memory_format=torch.contiguous_format))


def _contract(out_shape, scale=None):
    def run(inp, ops):
        out = ops.int8_contract(inp["a"], inp["b"],
                                None if scale is None else inp[scale])
        return out.reshape(out_shape)
    return run


def _int_mm_lib(inp):
    """``torch._int_mm`` on the same contraction: A row-major, B column-major
    (its fast layout), made beforehand."""
    a = inp["a"].contiguous()
    b = inp["b"].t().contiguous().t()
    return lambda: torch._int_mm(a, b)


def _sum_lib(inp):
    x = inp["x"]
    return lambda: torch.sum(x.reshape(x.shape[0], -1), 1, dtype=torch.float32)


def _x(inp):
    return inp["x"]


def _drawn(arrays, view):
    """A builder: the probe file's draws (``arrays(device)``), then the
    probe's view of them."""
    def build(device, small=False):
        return view(arrays(device))
    return build


# ---------------------------------------------------------------------------
# tools/probe_mosaic.py
# ---------------------------------------------------------------------------


def mosaic1_arrays(device="cpu"):
    """x (17, 208, 64), w (64, 128) int8; y (64, 128) f32; a (256, 32),
    b (32, 64) int8; s (1, 128) f32."""
    rng = np.random.default_rng(0)
    x = int8_draw(rng, (17, 208, 64), device)
    w = int8_draw(rng, (64, 128), device)
    y = _f32(rng, (64, 128), device)
    a = int8_draw(rng, (256, 32), device)
    b = int8_draw(rng, (32, 64), device)
    s = _f32(rng, (1, 128), device)
    return {"x8": x, "w": w, "y": y, "a5": a, "b5": b, "s": s}


_m1 = functools.partial(_drawn, mosaic1_arrays)


def _m1_contract(d):
    return {**d, "a": d["x8"].reshape(17 * 208, 64), "b": d["w"]}


MOSAIC1 = [
    Probe("P1", "tools/probe_mosaic.py:48", "int8_contract", _m1(_m1_contract),
          _contract((17, 208, 128)), contract_work, library=_int_mm_lib),
    Probe("P2a", "tools/probe_mosaic.py:61", "strided_map",
          _m1(lambda d: {"x": d["x8"][0:15:2]}), _copy(_x), copy_work,
          library=_clone_lib(_x)),
    Probe("P2b", "tools/probe_mosaic.py:72", "strided_map",
          _m1(lambda d: {"x": d["x8"][:, 0:207:2]}), _copy(_x), copy_work,
          library=_clone_lib(_x)),
    Probe("P3", "tools/probe_mosaic.py:83", "strided_map",
          _m1(lambda d: {"x": d["x8"].reshape(17, 104, 128)}), _copy(_x),
          copy_work, library=_clone_lib(_x)),
    Probe("P4", "tools/probe_mosaic.py:103", "strided_map",
          _m1(lambda d: {"x": d["y"]}),
          lambda inp, ops: ops.strided_map(inp["x"], "scale", 2.0), map_work(1),
          library=lambda inp: (lambda: torch.mul(inp["x"], 2.0))),
    Probe("P5", "tools/probe_mosaic.py:118", "int8_contract",
          _m1(lambda d: {"a": d["a5"], "b": d["b5"]}), _contract((256, 64)),
          contract_work, library=_int_mm_lib),
    Probe("P6", "tools/probe_mosaic.py:129", "strided_map",
          _m1(lambda d: {"x": d["x8"][:, :, 32:64]}), _copy(_x), copy_work,
          library=_clone_lib(_x)),
    Probe("P7", "tools/probe_mosaic.py:145", "int8_contract", _m1(_m1_contract),
          _contract((17, 208, 128), scale="s"), contract_work),
]

# ---------------------------------------------------------------------------
# tools/probe_mosaic2.py
# ---------------------------------------------------------------------------


def mosaic2_arrays(device="cpu"):
    """x32 (128, 208) int32; xb (64, 208), x3 (16, 64, 208) bf16; F (48,
    208), W (48, 128) int8."""
    rng = np.random.default_rng(0)
    x32 = torch.from_numpy(rng.integers(-2 ** 20, 2 ** 20, (128, 208))
                           .astype(np.int32)).to(device)
    xb = bf16_from(rng.standard_normal((64, 208)), device)
    x3 = bf16_from(rng.standard_normal((16, 64, 208)), device)
    F = int8_draw(rng, (48, 208), device)
    W = int8_draw(rng, (48, 128), device)
    return {"x32": x32, "xb": xb, "x3": x3, "F": F, "W": W}


_m2 = functools.partial(_drawn, mosaic2_arrays)


def _p10_view(d):
    return {"a": d["W"].t(), "b": d["F"]}          # Wᵀ·F → (128, 208)


def _p11_run(inp, ops):
    """P11: F stacked through scratch (a copy), then Wᵀ·F."""
    f = ops.strided_map(inp["b"])
    return ops.int8_contract(inp["a"], f)


def _p11_work(inp, out):
    b, ops_, kind = contract_work(inp, out)
    return b + 2 * nbytes(inp["b"]), ops_, kind


def _planes(device, small, seed):
    """Q5's (B, 12, 208, 208) int8 channel planes of quantized [0, 1)
    frames: values in [0, 127]."""
    B = B_SMALL if small else B_STREAM
    return {"x": device_int8((B, 12, 208, 208), seed, device, 0, 128)}


MOSAIC2 = [
    Probe("T1a", "tools/probe_mosaic2.py:64", "strided_map",
          _m2(lambda d: {"x": d["x32"].t()}), _copy(_x), copy_work,
          library=_clone_lib(_x)),
    Probe("T1b", "tools/probe_mosaic2.py:76", "strided_map",
          _m2(lambda d: {"x": d["xb"].t()}), _copy(_x), copy_work,
          library=_clone_lib(_x)),
    Probe("T1c", "tools/probe_mosaic2.py:89", "strided_map",
          _m2(lambda d: {"x": d["x3"].permute(0, 2, 1)}), _copy(_x), copy_work,
          library=_clone_lib(_x)),
    Probe("P10", "tools/probe_mosaic2.py:105", "int8_contract", _m2(_p10_view),
          _contract((128, 208)), contract_work, library=_int_mm_lib),
    Probe("P11", "tools/probe_mosaic2.py:120", "int8_contract", _m2(_p10_view),
          _p11_run, _p11_work),
    Probe("Q5", "tools/probe_mosaic2.py:185", "strided_map",
          lambda device, small=False: _planes(device, small, 5),
          lambda inp, ops: ops.strided_map(inp["x"], "sum"), sum_work,
          rule="sum", library=_sum_lib, last_block=True),
]

# ---------------------------------------------------------------------------
# tools/probe_mosaic3.py, probe_mosaic4.py, probe_mosaic5.py
# ---------------------------------------------------------------------------


def mosaic3_arrays(device="cpu"):
    """x (416, 1248), S (48, 32, 208), W (48, 128), y (64, 32, 208) int8."""
    rng = np.random.default_rng(0)
    x = int8_draw(rng, (416, 1248), device)
    S = int8_draw(rng, (48, 32, 208), device)
    W = int8_draw(rng, (48, 128), device)
    y = int8_draw(rng, (64, 32, 208), device)
    return {"x8": x, "S": S, "W": W, "y": y}


_m3 = functools.partial(_drawn, mosaic3_arrays)


def _flat_frames(device, small, seed):
    """Q8's born-flat frames (B, 416, 1248) bf16 in [0, 1)."""
    B = B_SMALL if small else B_STREAM
    return {"x": device_uniform_bf16((B, 416, 1248), seed, device)}


def _quantize127(inp, ops):
    return ops.strided_map(inp["x"], "quantize", 127.0)


def mosaic4_arrays(device="cpu"):
    """S (48, 16, 208), W (48, 128), plane (208, 208) int8."""
    rng = np.random.default_rng(0)
    S = int8_draw(rng, (48, 16, 208), device)
    W = int8_draw(rng, (48, 128), device)
    plane = int8_draw(rng, (208, 208), device)
    return {"S": S, "W": W, "plane": plane}


_m4 = functools.partial(_drawn, mosaic4_arrays)


def p13c_stack_view(plane):
    """P13c's stack of 48 slices ``plane[k%4 : k%4+16]`` as one strided
    view (12, 4, 16, 208) of the plane: k = 4a + b, stride 0 along a."""
    return plane.as_strided((12, 4, 16, 208), (0, 208, 208, 1))


def _p13c_run(inp, ops):
    st = ops.strided_map(p13c_stack_view(inp["plane"])).reshape(48, 16 * 208)
    return ops.int8_contract(st.t(), inp["b"]).reshape(16, 208, 128)


def _p13c_work(inp, out):
    M, K, N = 16 * 208, 48, 128
    return (nbytes(inp["plane"], inp["b"], out) + 2 * K * M,
            2 * M * N * K, "int8")


MOSAIC345 = [
    Probe("P12", "tools/probe_mosaic3.py:68", "strided_map",
          _m3(lambda d: {"x": d["x8"].reshape(208, 2, 1248)[:, 1, :]}),
          _copy(_x), copy_work, library=_clone_lib(_x)),
    Probe("P13", "tools/probe_mosaic3.py:84", "int8_contract",
          _m3(lambda d: {"a": d["W"].t(), "b": d["S"].reshape(48, 32 * 208)}),
          _contract((128, 32, 208)), contract_work, library=_int_mm_lib),
    Probe("T14", "tools/probe_mosaic3.py:98", "strided_map",
          _m3(lambda d: {"x": d["y"].permute(1, 2, 0)}), _copy(_x), copy_work,
          library=_clone_lib(_x)),
    Probe("T15", "tools/probe_mosaic3.py:109", "strided_map",
          _m3(lambda d: {"x": d["x8"].t()}), _copy(_x), copy_work,
          library=_clone_lib(_x)),
    Probe("Q8@mosaic3", "tools/probe_mosaic3.py:172", "strided_map",
          lambda device, small=False: _flat_frames(device, small, 8),
          _quantize127, map_work(4), last_block=True),
    Probe("P13b", "tools/probe_mosaic4.py:70", "int8_contract",
          _m4(lambda d: {"a": d["S"].reshape(48, 16 * 208).t(), "b": d["W"]}),
          _contract((16, 208, 128)), contract_work, library=_int_mm_lib),
    Probe("P13c", "tools/probe_mosaic4.py:86", "int8_contract",
          _m4(lambda d: {"plane": d["plane"], "b": d["W"]}), _p13c_run,
          _p13c_work),
    Probe("Q8@mosaic5", "tools/probe_mosaic5.py:70", "strided_map",
          lambda device, small=False: _flat_frames(device, small, 9),
          _quantize127, map_work(4)),
]

# ---------------------------------------------------------------------------
# tools/probe_mosaic6.py, probe_mosaic7.py
# ---------------------------------------------------------------------------


def mosaic6_arrays(device="cpu"):
    """x12 (32, 208, 12), S (16, 208, 108), W (108, 128) int8, after the
    probe's two B=128 frame draws (skipped)."""
    rng = np.random.default_rng(0)
    rng.bit_generator.advance(B_STREAM * 416 * 416 * 3 + B_STREAM * 416 * 1248)
    x12 = int8_draw(rng, (32, 208, 12), device)
    S = int8_draw(rng, (16, 208, 108), device)
    W = int8_draw(rng, (108, 128), device)
    return {"x12": x12, "S": S, "W": W}


_m6 = functools.partial(_drawn, mosaic6_arrays)


def p15_view(x12):
    """P15's nine row-shifted slices ``x12[s : s+16]`` side by side along
    the minor dim, as one view (16, 208, 9, 12) of x12."""
    return x12.as_strided((16, 208, 9, 12), (208 * 12, 12, 208 * 12, 1))


def _block_sums(shape, seed, high=127):
    def build(device, small=False):
        B = B_SMALL if small else B_STREAM
        return {"x": device_int8((B,) + shape, seed, device, -127 if high == 127 else 0,
                                 high)}
    return build


def dp4a_case(device, rows: int = 128):
    """P16's function at ``rows``× its rows — S (16·rows, 208, 108) · W
    (108, 128) — the contraction at a size the card's memory rate bounds:
    seeded on the device."""
    S = device_int8((16 * rows, 208, 108), 16, device)
    W = device_int8((108, 128), 17, device)
    return {"a": S.reshape(-1, 108), "b": W}


# not a JAX probe: P16's function at 128× its rows, its byte-bound case
DP4A = Probe("P16x128", "tools/probe_mosaic6.py:114", "int8_contract",
             lambda device, small=False: dp4a_case(device, 1 if small else 128),
             _contract((-1, 208, 128)), contract_work)


def _p15_work(inp, out):
    return 2 * nbytes(out), 0, "f32"


_SUMS = lambda inp, ops: ops.strided_map(inp["x"], "sum")  # noqa: E731

MOSAIC67 = [
    Probe("P15", "tools/probe_mosaic6.py:96", "strided_map",
          _m6(lambda d: {"x": p15_view(d["x12"])}),
          lambda inp, ops: ops.strided_map(inp["x"]).reshape(16, 208, 108),
          _p15_work, library=_clone_lib(_x)),
    Probe("P16", "tools/probe_mosaic6.py:114", "int8_contract",
          _m6(lambda d: {"a": d["S"].reshape(16 * 208, 108), "b": d["W"]}),
          _contract((16, 208, 128)), contract_work),
    Probe("Q16", "tools/probe_mosaic6.py:126", "strided_map",
          _block_sums((208, 208, 12), 16, high=128), _SUMS, sum_work,
          rule="sum", library=_sum_lib, last_block=True),
    Probe("Q17", "tools/probe_mosaic6.py:142", "strided_map",
          _block_sums((208, 208, 128), 17), _SUMS, sum_work, rule="sum",
          library=_sum_lib, last_block=True),
    Probe("Q18", "tools/probe_mosaic7.py:123", "strided_map",
          _block_sums((208, 208, 108), 18, high=128), _SUMS, sum_work,
          rule="sum", library=_sum_lib, last_block=True),
]

# ---------------------------------------------------------------------------
# tools/reprobe.py
# ---------------------------------------------------------------------------

def _rp(name, view):
    return _drawn(functools.partial(reprobe_arrays, name), view)


DMA = {"dma_dynamic_image_index": ([2, 0, 3, 1], None, 1),
       "dma_dynamic_row_window": ([2, 0, 3, 1], [0, 32, 64, 16], 1),
       "dma_dynamic_row_window_x8": ([2, 0, 3, 1], [0, 4, 8, 2], 8)}


def reprobe_arrays(name: str, device="cpu"):
    """``reprobe._probe(name)``'s arrays: x8 (16, 208, 64) int8 and xf (64,
    256) f32, then the probe's own draws."""
    rng = np.random.default_rng(0)
    d = {"x8": int8_draw(rng, (16, 208, 64), device),
         "xf": _f32(rng, (64, 256), device)}
    if name == "rank3_dim0_contraction":
        d["w"] = int8_draw(rng, (16, 64), device)
    elif name == "rank3_minor_contraction":
        d["w"] = int8_draw(rng, (64, 128), device)
    elif name == "bf16_compare":
        d["xb"] = bf16_from(rng.standard_normal((64, 256)), device)
    elif name in DMA:
        fidx, r0, unit = DMA[name]
        d["frames"] = _f32(rng, (4, 128, 256), device)
        d["fidx"] = torch.tensor(fidx, dtype=torch.int32, device=device)
        d["r0"] = None if r0 is None else torch.tensor(r0, dtype=torch.int32,
                                                       device=device)
        d["unit"] = unit
    return d


def _dma_view(d):
    """The window of each of the 4 programs: frame fidx[i], rows from
    r0[i]·unit, 64 × 256 — a zero program stride plus per-program bases."""
    f = d["frames"]
    index = [(d["fidx"], 128 * 256)]
    if d["r0"] is not None:
        index.append((d["r0"], d["unit"] * 256))
    return {"x": f.as_strided((4, 64, 256), (0, 256, 1)), "index": index}


def _lane_subrange_inputs(d):
    """xf's first 128 lanes, and one f32 zero that a zero-stride view
    spreads over the output."""
    return {"x": d["xf"][:, :128],
            "zero": torch.zeros((1, 1), dtype=torch.float32, device=d["xf"].device)}


def _lane_subrange(inp, ops):
    """As the TPU kernel does: zero the whole (64, 256) output, then write
    x into lanes 64:192 — two kernel launches."""
    out = torch.empty((64, 256), dtype=torch.float32, device=inp["x"].device)
    ops.strided_map(inp["zero"].expand(64, 256), out=out)
    ops.strided_map(inp["x"], out=out[:, 64:192])
    return out


def _lane_subrange_work(inp, out):
    """The zero fill writes the output; the copy reads and writes x."""
    return nbytes(out) + 2 * nbytes(inp["x"]), 0, "f32"


RP89, RP201 = "tools/reprobe.py:89", "tools/reprobe.py:201"

REPROBE = [
    Probe("strided_slice_sublane", RP89, "strided_map",
          _rp("strided_slice_sublane", lambda d: {"x": d["x8"][:, 0:207:2]}),
          _copy(_x), copy_work, library=_clone_lib(_x)),
    Probe("lane_merge_reshape", RP89, "strided_map",
          _rp("lane_merge_reshape", lambda d: {"x": d["x8"].reshape(16, 104, 128)}),
          _copy(_x), copy_work, library=_clone_lib(_x)),
    Probe("rank3_dim0_contraction", RP89, "int8_contract",
          _drawn(functools.partial(reprobe_arrays, "rank3_dim0_contraction"),
              lambda d: {"a": d["x8"].reshape(16, 208 * 64).t(), "b": d["w"]}),
          _contract((208, 64, 64)), contract_work, library=_int_mm_lib),
    Probe("bf16_compare", RP89, "strided_map",
          _rp("bf16_compare", lambda d: {"x": d["xb"]}),
          lambda inp, ops: ops.strided_map(inp["x"], "compare"), map_work(1)),
    Probe("transpose_2d", RP89, "strided_map",
          _rp("transpose_2d", lambda d: {"x": d["xf"].t()}), _copy(_x),
          copy_work, library=_clone_lib(_x)),
    Probe("dynamic_ds", RP89, "strided_map",
          _rp("dynamic_ds", lambda d: {"x": d["xf"]}),
          lambda inp, ops: ops.strided_map(inp["x"], "scale", 2.0), map_work(1),
          library=lambda inp: (lambda: torch.mul(inp["x"], 2.0))),
    Probe("lane_subrange_write", RP89, "strided_map",
          _rp("lane_subrange_write", _lane_subrange_inputs), _lane_subrange,
          _lane_subrange_work),
    Probe("rank3_minor_contraction", RP89, "int8_contract",
          _drawn(functools.partial(reprobe_arrays, "rank3_minor_contraction"),
              lambda d: {"a": d["x8"].reshape(16 * 208, 64), "b": d["w"]}),
          _contract((16, 208, 128)), contract_work, library=_int_mm_lib),
] + [Probe(name, RP201, "strided_map", _rp(name, _dma_view), indexed_copy,
           copy_work) for name in DMA]

PROBES = MOSAIC1 + MOSAIC2 + MOSAIC345 + MOSAIC67 + REPROBE
