"""The port's Pallas probes (``probes.PROBES``) against the JAX repository's
``tools/`` probes on the CPU.

Each probe's plain route runs on its seeded inputs (the CPU builds, with
the B=128 stream probes cut to B=2) and is held to the JAX side:

- the closure probes of ``tools/probe_mosaic*.py`` and the crop probes
  cannot be called from outside their ``main()``, so their draws are
  repeated here, as the probe makes them (``default_rng(0)``, ``jnp``
  casts, its draw order — the two B=128 frame draws of ``probe_mosaic6``
  included, in chunks), and the plain route is held to the probe's own
  ``expect=`` expression; where a probe states none (the block sums and
  quantizes, the crop resample), to its kernel body written in ``jnp``;
- ``tools/reprobe.py``'s probes run as the JAX tool runs them, through
  ``reprobe._probe(name)`` under ``pltpu.force_tpu_interpret_mode()``
  (each asserts its kernel against its expectation), and the plain route
  is held to the same expectation on the same draws.

Copies, maps and contractions are held bit for bit, block sums within
``ops.strided_map.SUM_RTOL`` of the exact sum, the tail conv value for
value. ``reprobe._probe`` points JAX at a persistent compilation cache:
the fixture sends it to a temporary directory and restores JAX's three
cache settings afterwards.
"""

import contextlib
import functools
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mit_driverless_cv_traininginfra_tpu_torch.ops.strided_map import (
    SUM_RTOL,
    strided_map_plain,
)
from mit_driverless_cv_traininginfra_tpu_torch.ops.window_resample import (
    window_resample_plain,
)
from mit_driverless_cv_traininginfra_tpu_torch.probes import BY_NAME, PLAIN, PROBES
from mit_driverless_cv_traininginfra_tpu_torch.probes import crop, mosaic

REPO = Path(__file__).resolve().parents[1]
TOOLS = REPO / "tools"
CACHE_KEYS = ("jax_compilation_cache_dir",
              "jax_persistent_cache_min_entry_size_bytes",
              "jax_persistent_cache_min_compile_time_secs")


def _grep_sites():
    sites = set()
    for f in sorted(TOOLS.glob("*.py")):
        for i, line in enumerate(f.read_text().splitlines(), 1):
            if re.search(r"pl\.pallas_call\(", line):
                sites.add(f"tools/{f.name}:{i}")
    return sites


def test_table_covers_every_pallas_call_of_the_tools():
    sites = _grep_sites()
    assert len(sites) == 34
    assert {p.ref for p in PROBES} == sites
    assert len(PROBES) == 46 and len(BY_NAME) == 46
    assert {p.kernel for p in PROBES} == {"tail_conv", "window_resample",
                                          "int8_contract", "strided_map"}


def test_chip_smoke_rows_name_every_site_of_their_kernel():
    """``chip_smoke.KERNEL_ROWS``' ``replaces`` of the four probe kernels
    ("file:line,line; …") list exactly the sites of ``PROBES`` on each."""
    spec = importlib.util.spec_from_file_location("chip_smoke_rows", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for kernel in ("tail_conv", "window_resample", "int8_contract", "strided_map"):
        source, replaces = smoke.KERNEL_ROWS[kernel]
        assert (REPO / source).is_file()
        sites = set()
        for part in replaces.split("; "):
            f, lines = part.split(":")
            sites |= {f"{f}:{n}" for n in lines.split(",")}
        assert sites == {p.ref for p in PROBES if p.kernel == kernel}, kernel


# ---------------------------------------------------------------------------
# the JAX side: each probe's draws and expectation
# ---------------------------------------------------------------------------


def _i8(rng, shape):
    return jnp.asarray(rng.integers(-127, 127, shape), jnp.int8)


def _f32(rng, shape):
    return jnp.asarray(rng.standard_normal(shape), jnp.float32)


def _contract(x, w, dims):
    return jax.lax.dot_general(x, w, (dims, ((), ())),
                               preferred_element_type=jnp.int32)


@functools.cache
def _mosaic1():
    rng = np.random.default_rng(0)
    x, w = _i8(rng, (17, 208, 64)), _i8(rng, (64, 128))
    y = _f32(rng, (64, 128))
    a, b = _i8(rng, (256, 32)), _i8(rng, (32, 64))
    s = _f32(rng, (1, 128))
    exp1 = _contract(x, w, ((2,), (0,)))
    xn = np.asarray(x)
    return {"P1": exp1, "P2a": xn[0:15:2], "P2b": xn[:, 0:207:2],
            "P3": xn.reshape(17, 104, 128), "P4": np.asarray(y) * 2,
            "P5": np.asarray(a, np.int32) @ np.asarray(b, np.int32),
            "P6": xn[:, :, 32:],
            "P7": (np.asarray(exp1, np.float32) * np.asarray(s)).astype(jnp.bfloat16)}


@functools.cache
def _mosaic2():
    rng = np.random.default_rng(0)
    x32 = jnp.asarray(rng.integers(-2 ** 20, 2 ** 20, (128, 208)), jnp.int32)
    xb = jnp.asarray(rng.standard_normal((64, 208)), jnp.bfloat16)
    x3 = jnp.asarray(rng.standard_normal((16, 64, 208)), jnp.bfloat16)
    F, W = _i8(rng, (48, 208)), _i8(rng, (48, 128))
    wtf = np.asarray(W, np.int32).T @ np.asarray(F, np.int32)
    return {"T1a": np.asarray(x32).T, "T1b": np.asarray(xb).T,
            "T1c": np.transpose(np.asarray(x3), (0, 2, 1)), "P10": wtf, "P11": wtf}


@functools.cache
def _mosaic34():
    rng = np.random.default_rng(0)
    x = _i8(rng, (416, 1248))
    S, W = _i8(rng, (48, 32, 208)), _i8(rng, (48, 128))
    y = _i8(rng, (64, 32, 208))
    out = {"P12": np.asarray(x).reshape(208, 2, 1248)[:, 1, :],
           "P13": np.einsum("kn,kmg->nmg", np.asarray(W, np.int32),
                            np.asarray(S, np.int32)),
           "T14": np.transpose(np.asarray(y), (1, 2, 0)), "T15": np.asarray(x).T}
    rng = np.random.default_rng(0)  # probe_mosaic4.py
    S, W = _i8(rng, (48, 16, 208)), _i8(rng, (48, 128))
    plane = _i8(rng, (208, 208))
    out["P13b"] = np.einsum("kmg,kn->mgn", np.asarray(S, np.int32),
                            np.asarray(W, np.int32))
    out["P13c"] = np.einsum("kmg,kn->mgn",
                            np.stack([np.asarray(plane, np.int32)[k % 4:k % 4 + 16]
                                      for k in range(48)]),
                            np.asarray(W, np.int32))
    return out


@functools.cache
def _mosaic6():
    rng = np.random.default_rng(0)
    # the probe's two B=128 frame draws, drawn in chunks (the same stream)
    n = 128 * 416 * 416 * 3 + 128 * 416 * 1248
    for start in range(0, n, 1 << 22):
        rng.random(min(1 << 22, n - start))
    x12 = _i8(rng, (32, 208, 12))
    S, W = _i8(rng, (16, 208, 108)), _i8(rng, (108, 128))
    return {"P15": np.concatenate([np.asarray(x12)[s:s + 16, 0:208, :]
                                   for s in range(9)], axis=-1),
            "P16": np.einsum("mgk,kn->mgn", np.asarray(S, np.int32),
                             np.asarray(W, np.int32))}


@functools.cache
def _crop_kernel():
    """probe_crop_kernel.py: P20's windows and the resample body of P21
    (64 crops) and P22 (the first ``crop.N_SMALL`` of its 512)."""
    rng = np.random.default_rng(0)
    B, H, WF, C, WIN, WINW = 16, 416, 1248, 64, 256, 768
    frames = jnp.asarray(rng.random((B, H, WF)), jnp.bfloat16)
    fidx = np.asarray(rng.integers(0, B, C))
    r0 = np.asarray(rng.integers(0, H - WIN, C))
    l0 = np.asarray(rng.integers(0, (WF - WINW) // 128, C) * 128)
    sx = jnp.asarray(rng.uniform(5, 250, (C, 80)), jnp.float32)
    fidx2 = np.asarray(rng.integers(0, B, 512))
    r02 = np.asarray(rng.integers(0, H - WIN, 512))
    l02 = np.asarray(rng.integers(0, (WF - WINW) // 128, 512) * 128)
    sx2 = jnp.asarray(rng.uniform(5, 250, (512, 80)), jnp.float32)
    fnp = np.asarray(frames)

    def windows(f, r, l, n):
        return np.stack([fnp[f[i], r[i]:r[i] + WIN, l[i]:l[i] + WINW]
                         for i in range(n)])

    def kresample(win, sx_row):  # the TPU kernel's body, after its DMA
        li = jax.lax.broadcasted_iota(jnp.int32, (WINW, 240), 0)
        mi = jax.lax.broadcasted_iota(jnp.int32, (WINW, 240), 1)
        w_src = (li // 3).astype(jnp.float32)
        hat = jnp.clip(1.0 - jnp.abs(sx_row[mi // 3] - w_src), 0.0, 1.0)
        rxb = jnp.where(li % 3 == mi % 3, hat, 0.0).astype(jnp.bfloat16)
        return jnp.dot(win[0:80, :], rxb, preferred_element_type=jnp.float32
                       ).astype(jnp.bfloat16)

    n2 = crop.N_SMALL
    return {"P20": windows(fidx, r0, l0, C),
            "P21": jax.vmap(kresample)(jnp.asarray(windows(fidx, r0, l0, C)), sx),
            "P22": jax.vmap(kresample)(jnp.asarray(windows(fidx2, r02, l02, n2)),
                                       sx2[:n2])}


@functools.cache
def _crop_dma():
    rng = np.random.default_rng(0)
    B, H, WF, C, WIN, WINW = 8, 416, 1248, 8, 256, 768
    fnp = np.asarray(jnp.asarray(rng.random((B, H, WF)), jnp.bfloat16))
    fidx = rng.integers(0, B, C)
    r0 = rng.integers(0, H - WIN, C)
    l0 = rng.integers(0, (WF - WINW) // 128, C) * 128
    rows = np.stack([fnp[fidx[i], r0[i]:r0[i] + 64, 0:128] for i in range(C)])
    rows_lanes = np.stack([fnp[fidx[i], r0[i]:r0[i] + 64, l0[i]:l0[i] + 128]
                           for i in range(C)])
    return {"D1": np.stack([fnp[fidx[i], 0:64, 0:128] for i in range(C)]),
            "D2": rows, "D3": rows_lanes, "D4": rows_lanes}


def _reprobe_expect(name):
    """What ``reprobe._probe(name)`` asserts its kernel against, on its
    draws: ``default_rng(0)``, x8, xf, then the probe's own."""
    rng = np.random.default_rng(0)
    x8, xf = _i8(rng, (16, 208, 64)), _f32(rng, (64, 256))
    x8n, xfn = np.asarray(x8), np.asarray(xf)
    if name == "strided_slice_sublane":
        return x8n[:, 0:207:2]
    if name == "lane_merge_reshape":
        return x8n.reshape(16, 104, 128)
    if name == "rank3_dim0_contraction":
        return _contract(x8, _i8(rng, (16, 64)), ((0,), (0,)))
    if name == "bf16_compare":
        xb = jnp.asarray(rng.standard_normal((64, 256)), jnp.bfloat16)
        return (xb > jnp.bfloat16(0.0)).astype(jnp.bfloat16)
    if name == "transpose_2d":
        return xfn.T
    if name == "dynamic_ds":
        return xfn * 2
    if name == "lane_subrange_write":
        out = np.zeros((64, 256), np.float32)
        out[:, 64:192] = xfn[:, :128]
        return out
    if name == "rank3_minor_contraction":
        return _contract(x8, _i8(rng, (64, 128)), ((2,), (0,)))
    frames = np.asarray(_f32(rng, (4, 128, 256)))
    fidx = [2, 0, 3, 1]
    if name == "dma_dynamic_image_index":
        return np.stack([frames[f, :64] for f in fidx])
    starts = ([0, 32, 64, 16] if name == "dma_dynamic_row_window"
              else [8 * r for r in [0, 4, 8, 2]])
    return np.stack([frames[f, s:s + 64] for f, s in zip(fidx, starts)])


def _block_sum(inp):
    x = jnp.asarray(inp["x"].numpy())
    return jnp.sum(x.astype(jnp.float32), axis=tuple(range(1, x.ndim)))


def _quantize127(inp):
    x = jnp.asarray(inp["x"].float().numpy()).astype(jnp.bfloat16)
    return jnp.clip(jnp.round(x.astype(jnp.float32) * 127.0), -127, 127).astype(jnp.int8)


def _tail_twin(inp):
    """The probe's XLA twin (``xla_`` in its ``main``) on its draws at
    C=2, op by op."""
    rng = np.random.default_rng(0)
    C, sx = inp["h"].shape[0], 2.0
    h = jnp.asarray(rng.standard_normal((C, 80, 80, 64)) * 0.5, jnp.bfloat16)
    w = rng.standard_normal((3, 3, 64, 128)).astype(np.float32) * 0.1
    s_w = np.maximum(np.abs(w).max(axis=(0, 1, 2)) / 127.0, 1e-12)
    wq = np.clip(np.round(w / s_w), -127, 127).astype(np.int8)
    scale = jnp.asarray((sx / 127.0) * s_w, jnp.float32).reshape(1, 128)
    bias = jnp.asarray(rng.standard_normal(128) * 0.1, jnp.float32).reshape(1, 128)
    with jax.disable_jit():
        xq = jnp.clip(jnp.round(h.astype(jnp.float32) * (127.0 / sx)),
                      -127, 127).astype(jnp.int8)
        acc = jax.lax.conv_general_dilated(
            xq, jnp.asarray(wq), (1, 1), [(2, 2), (2, 2)], rhs_dilation=(2, 2),
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)
        y = acc.astype(jnp.float32) * scale[0] + bias[0]
        return jnp.maximum(y.astype(jnp.bfloat16), 0)


EXPECT = {**{k: lambda inp, k=k: _mosaic1()[k] for k in
             ("P1", "P2a", "P2b", "P3", "P4", "P5", "P6", "P7")},
          **{k: lambda inp, k=k: _mosaic2()[k] for k in
             ("T1a", "T1b", "T1c", "P10", "P11")},
          **{k: lambda inp, k=k: _mosaic34()[k] for k in
             ("P12", "P13", "T14", "T15", "P13b", "P13c")},
          **{k: lambda inp, k=k: _mosaic6()[k] for k in ("P15", "P16")},
          **{k: lambda inp, k=k: _crop_kernel()[k] for k in ("P20", "P21", "P22")},
          **{k: lambda inp, k=k: _crop_dma()[k] for k in ("D1", "D2", "D3", "D4")},
          **{k: _block_sum for k in ("Q5", "Q16", "Q17", "Q18")},
          "Q8@mosaic3": _quantize127, "Q8@mosaic5": _quantize127, "tail": _tail_twin}


def _np_bits(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    if a.dtype == np.float32:
        return a.view(np.int32)
    return a


def _torch_bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    if t.dtype == torch.float32:
        return t.view(torch.int32).numpy()
    return t.numpy()


def _hold(probe, inp, got, want):
    """``got`` (the plain route) against ``want`` (the JAX side) under the
    probe's rule."""
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, (probe.name, got.shape, want.shape)
    if probe.rule == "sum":
        x = inp["x"].reshape(inp["x"].shape[0], -1).double()
        exact, tol = x.sum(1).numpy(), SUM_RTOL * x.abs().sum(1).numpy()
        assert (np.abs(got.double().numpy() - exact) <= tol).all()
        assert (np.abs(want.astype(np.float64) - exact) <= tol).all()
    elif probe.rule == "values":
        np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
    else:
        assert got.element_size() == want.dtype.itemsize, probe.name
        np.testing.assert_array_equal(_torch_bits(got), _np_bits(want))


@contextlib.contextmanager
def jax_tool(name: str, cache_dir: str):
    """Load the JAX tool ``tools/<name>`` with its compilation cache sent
    to ``cache_dir``; on exit, JAX's three cache settings are restored and
    its cache is reset."""
    from jax._src import compilation_cache

    from mit_driverless_cv_traininginfra_tpu.utils import jaxcache

    saved = {k: getattr(jax.config, k) for k in CACHE_KEYS}
    real = jaxcache.enable_compile_cache
    jaxcache.enable_compile_cache = lambda cache_dir_=None: real(cache_dir)
    spec = importlib.util.spec_from_file_location(f"jax_tools_{Path(name).stem}",
                                                  TOOLS / name)
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
        yield module
    finally:
        jaxcache.enable_compile_cache = real
        for k, v in saved.items():
            jax.config.update(k, v)
        compilation_cache.reset_cache()


@pytest.fixture(scope="module")
def jreprobe(tmp_path_factory):
    with jax_tool("reprobe.py", str(tmp_path_factory.mktemp("jax_cache"))) as m:
        yield m


def test_jax_tool_leaves_the_cache_settings_as_they_were(tmp_path):
    before = {k: getattr(jax.config, k) for k in CACHE_KEYS}
    with jax_tool("reprobe.py", str(tmp_path)) as m:
        with pltpu.force_tpu_interpret_mode():
            m._probe("transpose_2d")
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    assert {k: getattr(jax.config, k) for k in CACHE_KEYS} == before


REPROBES = [p.name for p in mosaic.REPROBE]


@pytest.mark.parametrize("name", [p.name for p in PROBES if p.name not in REPROBES])
def test_plain_route_matches_the_jax_probe(name):
    probe = BY_NAME[name]
    inp = probe.build("cpu", small=True)
    got = probe.run(inp, PLAIN)
    _hold(probe, inp, got, EXPECT[name](inp))
    if probe.last_block:  # the TPU grid leaves the last program's block
        assert got.shape[0] == inp["x"].shape[0]


@pytest.mark.parametrize("name", REPROBES)
def test_plain_route_matches_reprobe_in_interpret_mode(jreprobe, name):
    with pltpu.force_tpu_interpret_mode():
        jreprobe._probe(name)  # raises if its kernel misses its expectation
    probe = BY_NAME[name]
    inp = probe.build("cpu", small=True)
    _hold(probe, inp, probe.run(inp, PLAIN), _reprobe_expect(name))



# ---------------------------------------------------------------------------
# the strided views against numpy slicing
# ---------------------------------------------------------------------------


def test_p13c_stack_is_a_strided_view_of_the_plane():
    plane = mosaic.mosaic4_arrays()["plane"]
    want = np.stack([plane.numpy()[k % 4:k % 4 + 16] for k in range(48)])
    view = mosaic.p13c_stack_view(plane)
    assert view.data_ptr() == plane.data_ptr()
    np.testing.assert_array_equal(view.reshape(48, 16, 208).numpy(), want)


def test_p15_slices_are_a_strided_view():
    x12 = mosaic.mosaic6_arrays()["x12"]
    want = np.concatenate([x12.numpy()[s:s + 16] for s in range(9)], axis=-1)
    view = mosaic.p15_view(x12)
    assert view.data_ptr() == x12.data_ptr()
    np.testing.assert_array_equal(view.reshape(16, 208, 108).numpy(), want)


@pytest.mark.parametrize("name", ["D1", "D2", "D3", "D4", "P20",
                                  "dma_dynamic_image_index",
                                  "dma_dynamic_row_window",
                                  "dma_dynamic_row_window_x8"])
def test_windows_gather_what_numpy_slicing_reads(name):
    """A zero program stride plus per-program bases (frame, row, lane)
    reads each window that numpy slices out of the frames."""
    inp = BY_NAME[name].build("cpu", small=True)
    x, index = inp["x"], inp["index"]
    flat = _torch_bits(x.as_strided(
        (x.untyped_storage().nbytes() // x.element_size(),), (1,), 0))
    n, rows, lanes = x.shape
    row_pitch = x.stride(1)
    want = []
    for i in range(n):
        base = sum(int(idx[i]) * t for idx, t in index)
        want.append(np.stack([flat[base + r * row_pitch: base + r * row_pitch + lanes]
                              for r in range(rows)]))
    got = strided_map_plain(x, index=index)
    np.testing.assert_array_equal(_torch_bits(got), np.stack(want))


def test_quantize_and_compare_map_nan_to_zero():
    x = torch.tensor([[float("nan"), -0.0, 0.3, -1.2, 2.0, 0.5 / 127]],
                     dtype=torch.bfloat16)
    q = strided_map_plain(x, "quantize", 127.0)
    assert q.dtype == torch.int8
    assert q.tolist() == [[0, 0, 38, -127, 127, 0]]
    c = strided_map_plain(x, "compare")
    assert c.dtype == torch.bfloat16 and c.float().tolist() == [[0, 0, 1, 0, 1, 1]]


@pytest.mark.parametrize("op", ["copy", "sum"])
@pytest.mark.parametrize("base", [-1, 3])
def test_strided_map_refuses_a_base_outside_the_storage(op, base):
    """Two windows of 2 rows × 5 of a (4, 10) array: row bases 0 and 2 fit,
    −1 and 3 leave the storage (the kernel traps there)."""
    x = torch.arange(40, dtype=torch.float32).reshape(4, 10)
    view = x.as_strided((2, 2, 5), (0, 10, 1))
    got = strided_map_plain(view, op, index=[(torch.tensor([0, 2]), 10)])
    assert got.shape == ((2,) if op == "sum" else (2, 2, 5))
    with pytest.raises(IndexError):
        strided_map_plain(view, op, index=[(torch.tensor([0, base]), 10)])


@pytest.mark.parametrize("bad", [(0, 2), (0, -1), (1, 11), (1, -1), (2, 7), (2, -1)])
def test_window_resample_refuses_a_window_outside_its_frame(bad):
    """20 rows × 6 columns of 3 channels in (2, 30, 24) frames: frame, row
    and lane origins one past either end (the kernel traps there)."""
    frames = torch.rand((2, 30, 24)).to(torch.bfloat16)
    origin = [torch.tensor([0, 1]), torch.tensor([0, 10]), torch.tensor([0, 6])]
    sx = torch.rand((2, 4)) * 5
    assert window_resample_plain(frames, *origin, sx, rows=20, win_w=6, ch=3).shape == (2, 20, 12)
    which, value = bad
    origin[which] = torch.tensor([0, value])
    with pytest.raises(IndexError):
        window_resample_plain(frames, *origin, sx, rows=20, win_w=6, ch=3)
