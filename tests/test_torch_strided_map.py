"""``strided_map``'s path picker (``ops/strided_map.py:pick_path``) and the
index arithmetic of its card kernels (``csrc/strided_map.cu``), on the CPU:
the path each probe view takes, the rank-4 dims and strides a path is given
addressing exactly the elements of the view, and the rows kernel's 16-byte
slots covering each element of a row once."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mit_driverless_cv_traininginfra_tpu_torch.ops.strided_map import (
    path_of,
    pick_path,
    strided_map_plain,
)
from mit_driverless_cv_traininginfra_tpu_torch.probes import BY_NAME
from mit_driverless_cv_traininginfra_tpu_torch.probes.base import PLAIN

# the path of each strided_map call a probe makes, in order (22 sites of
# tools/, P11's and P13c's copies before their contractions); transposes
# under TILED_MIN elements go one element a thread
EXPECTED = {
    "P2a": ["rows"], "P2b": ["rows"], "P3": ["rows"], "P4": ["rows"], "P6": ["rows"],
    "T1a": ["generic"], "T1b": ["generic"], "T1c": ["transpose"], "P11": ["rows"],
    "Q5": ["sum"], "P12": ["rows"], "T14": ["transpose"], "T15": ["transpose"],
    "Q8@mosaic3": ["rows"], "Q8@mosaic5": ["rows"], "P13c": ["rows"], "P15": ["rows"],
    "Q16": ["sum"], "Q17": ["sum"], "Q18": ["sum"], "strided_slice_sublane": ["rows"],
    "lane_merge_reshape": ["rows"], "bf16_compare": ["rows"], "transpose_2d": ["generic"],
    "dynamic_ds": ["rows"], "lane_subrange_write": ["generic", "rows"],
    "dma_dynamic_image_index": ["rows"], "dma_dynamic_row_window": ["rows"],
    "dma_dynamic_row_window_x8": ["rows"], "P20": ["rows"], "D1": ["rows"], "D2": ["rows"],
    "D3": ["rows"], "D4": ["rows"],
}


def _record(probe):
    """The paths of the strided_map calls ``probe`` makes on its CPU-size
    inputs (each call then taken by the plain version)."""
    paths = []

    def recording(src, op="copy", c=1.0, index=(), out=None, out_dtype=None):
        paths.append(path_of(src, op, out, index))
        return strided_map_plain(src, op, c, index, out, out_dtype)

    probe.run(probe.build("cpu", small=True),
              SimpleNamespace(strided_map=recording, int8_contract=PLAIN.int8_contract))
    return paths


def test_every_strided_map_probe_is_listed():
    uses = {p.name for p in BY_NAME.values() if p.kernel == "strided_map"} | {"P11", "P13c"}
    assert uses == set(EXPECTED)
    sites = {BY_NAME[n].ref for n in EXPECTED if BY_NAME[n].kernel == "strided_map"}
    assert len(sites) == 22


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_picker_names_the_path_of_every_probe_view(name):
    assert _record(BY_NAME[name]) == EXPECTED[name]


def _views():
    """Views of a (5, 6, 7, 4) array and output layouts: contiguous, sliced,
    permuted, broadcast, overlapping, size-1 dims."""
    x = torch.arange(5 * 6 * 7 * 4, dtype=torch.float32).reshape(5, 6, 7, 4)
    return {
        "contiguous": x, "sliced": x[1:4, ::2, 1:, :3], "permuted": x.permute(2, 0, 3, 1),
        "minor_transposed": x.transpose(-1, -2), "broadcast": x[:, :1].expand(5, 3, 7, 4),
        "overlapping": x.reshape(-1).as_strided((4, 3, 9, 4), (28, 4, 28, 1)),
        "strided_inner": x.reshape(5, -1)[:, 3:100:3], "size_one": x[:1, 2:3, :, 1:2],
        "zero_program_stride": x.reshape(-1).as_strided((3, 5, 8), (0, 8, 1)),
        "big_permuted": torch.arange(16 * 64 * 70, dtype=torch.float32)
        .reshape(16, 64, 70).permute(0, 2, 1),  # ≥ TILED_MIN: a tiled transpose
    }


@pytest.mark.parametrize("indexed", [False, True])
@pytest.mark.parametrize("out_kind", ["fresh", "transposed", "padded"])
@pytest.mark.parametrize("view", sorted(_views()))
def test_picked_dims_address_the_elements_of_the_view(view, out_kind, indexed):
    """Walking the rank-4 (dims, input strides, output strides) a path is
    given, as its kernel does, writes each output element once with the
    element the plain version puts there; rows have unit inner strides,
    transposes a unit input stride at dim 2."""
    src = _views()[view]
    shape = tuple(src.shape)
    if out_kind == "fresh":
        out = torch.empty(shape)
    elif out_kind == "transposed":
        out = torch.empty(shape[::-1]).permute(*reversed(range(len(shape))))
    else:
        out = torch.empty(shape[:-1] + (shape[-1] + 5,))[..., 2:2 + shape[-1]]
    path, dims, s, o = pick_path("copy", shape, src.stride(), out.stride(), indexed)
    grids = np.meshgrid(*(np.arange(d) for d in dims), indexing="ij")
    oi = out.storage_offset() + sum(g * k for g, k in zip(grids, o)).ravel()
    ii = src.storage_offset() + sum(g * k for g, k in zip(grids, s)).ravel()
    assert len(np.unique(oi)) == oi.size  # each output element written once
    flat_in = torch.tensor([], dtype=src.dtype).set_(src.untyped_storage())
    got = torch.full((out.untyped_storage().nbytes() // 4,), -1.0)
    got[torch.from_numpy(oi)] = flat_in[torch.from_numpy(ii)]
    base_out = out.storage_offset()
    want = torch.full_like(got, -1.0)
    want.as_strided(out.shape, out.stride(), base_out).copy_(strided_map_plain(src))
    assert torch.equal(got, want)
    if path == "rows":
        assert dims[3] == 1 or (s[3] == 1 and o[3] == 1)
    elif path == "transpose":
        assert not indexed and s[2] == 1 and o[3] == 1 and s[3] != 1
    if indexed:
        assert (dims[0], s[0], o[0]) == (shape[0], src.stride(0), out.stride(0))


@pytest.mark.parametrize("esize", [1, 2, 4])
def test_row_slots_cover_each_element_once(esize):
    """The rows kernel's slots: slot v of a row whose first element sits
    ``a`` elements past the input's 16-byte grid holds elements [v·V − a,
    (v + 1)·V − a); each element of the row falls in one slot, a slot is
    loaded whole only where all V lie in the row, and the host's slot count
    covers every a."""
    V = 16 // esize
    for d3 in range(1, 3 * V + 2):
        host_slots = (V - 1 + d3 + V - 1) // V
        for a in range(V):
            n_slots = (a + d3 + V - 1) // V
            assert n_slots <= host_slots
            covered = []
            for v in range(n_slots):
                e0 = v * V - a
                if e0 >= 0 and e0 + V <= d3:
                    assert ((a + e0) * esize) % 16 == 0  # a 16-byte aligned load
                    covered += range(e0, e0 + V)
                else:
                    covered += [e for e in range(e0, e0 + V) if 0 <= e < d3]
            assert sorted(covered) == list(range(d3))


def test_quantize_without_conversions_rounds_like_rint():
    """The kernel's quantize: NaN → 0, clamp to ±127, + 1.5·2²³ in f32,
    the low byte — equal to int8(clip(rint(x·c), ±127)) with NaN → 0 on
    halves, ±inf, ±0 and the clamp edges."""
    xs = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5,
                   126.5, -126.5, 127.49, 127.5, -127.5, 300.0, -300.0, 3.2, -7.7],
                  np.float32)
    v = np.where(np.isnan(xs), np.float32(0), np.clip(xs, -127, 127)).astype(np.float32)
    bits = (v + np.float32(12582912.0)).astype(np.float32).view(np.uint32)
    got = (bits & 0xFF).astype(np.uint8).view(np.int8)
    want = strided_map_plain(torch.from_numpy(xs), "quantize", 1.0).numpy()
    assert np.array_equal(got, want)
