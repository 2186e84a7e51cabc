"""Kernel K5's module (``ops/resstage.py``) against the JAX package's
``ops/pallas_resstage.py`` on the CPU: the stage spans, the quantized
bundle, and the plain version of K5 held to the XLA twin and to the Pallas
kernel in interpret mode, bit for bit on ``yq`` and ``ybf``.

The JAX side runs under ``jax.disable_jit()``: op by op it rounds
``acc·scale + b`` as two f32 roundings, as the port does; jitted, XLA:CPU
may contract it into one FMA (the finding of the fused entry's tests)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mit_driverless_cv_traininginfra_tpu.config.flagship import (
    flagship_spec as jflagship_spec,
)
from mit_driverless_cv_traininginfra_tpu.ops import pallas_resstage as jrs
from mit_driverless_cv_traininginfra_tpu_torch import convert
from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import (
    ConvBlock,
    RouteBlock,
    ShortcutBlock,
)
from mit_driverless_cv_traininginfra_tpu_torch.config.flagship import flagship_spec
from mit_driverless_cv_traininginfra_tpu_torch.models import darknet, quantize, stem_opt
from mit_driverless_cv_traininginfra_tpu_torch.ops import entry
from mit_driverless_cv_traininginfra_tpu_torch.ops import resstage

S, C, NB, B, SLOPE = 8, 64, 3, 4, 0.1


def _qconv_params(rng, cin, cout, k):
    """One conv's int8 leaves in the JAX layout (HWIO), as the JAX
    package's tests/test_pallas_resstage.py makes them."""
    w = rng.standard_normal((k, k, cin, cout)).astype(np.float32) * 0.2
    s_w = np.maximum(np.abs(w).max(axis=(0, 1, 2)) / 127.0, 1e-12)
    sx = 2.5
    return {"wq": np.clip(np.round(w / s_w), -127, 127).astype(np.int8),
            "scale": ((sx / 127.0) * s_w).astype(np.float32),
            "b": (rng.standard_normal(cout) * 0.1).astype(np.float32),
            "sx_inv": np.float32(127.0 / sx)}


@pytest.fixture(scope="module")
def stage():
    """The same int8 leaves in both packages, both stage bundles, the port's
    packed bundle and a (B, S, S, C) bf16 input: ``(JAX rs, port rs, pk,
    x as f32 numpy)``."""
    rng = np.random.default_rng(0)
    q = {}
    for i in range(NB):
        q[str(10 + 3 * i)] = _qconv_params(rng, C, C // 2, 1)
        q[str(10 + 3 * i + 1)] = _qconv_params(rng, C // 2, C, 3)
    q["99"] = _qconv_params(rng, C, C, 3)
    jq = jax.tree_util.tree_map(jnp.asarray, q)
    rs_j = jrs.quantize_res_stage(jq, 10, NB, 99)
    rs_t = resstage.quantize_res_stage(convert.quantized_from_jax(q), 10, NB, 99)
    x = np.asarray(jnp.asarray(rng.standard_normal((B, S, S, C)) * 0.5,
                               jnp.bfloat16), np.float32)
    return rs_j, rs_t, resstage.pack_res_stage(rs_t), x


def test_res_stage_spans_flagship():
    spans = resstage.res_stage_spans(flagship_spec(416))
    # Darknet-53 runs: 1×64, 2×128, 8×256, 8×512, 4×1024
    assert [(n, c) for _, n, c in spans] == [
        (1, 64), (2, 128), (8, 256), (8, 512), (4, 1024)]
    assert spans == jrs.res_stage_spans(jflagship_spec(416))


def test_res_stage_spans_terminates_when_first_triplet_routed():
    """The JAX package's regression: a run whose first triplet has a routed
    conv output must not spin forever or emit (start, 0, C) spans."""

    def triplet():
        return [ConvBlock(filters=32, size=1, stride=1, batch_normalize=True,
                          activation="leaky"),
                ConvBlock(filters=64, size=3, stride=1, batch_normalize=True,
                          activation="leaky"),
                ShortcutBlock(from_layer=-3)]

    spec = types.SimpleNamespace(blocks=triplet() + [RouteBlock(layers=(0,))])
    assert resstage.res_stage_spans(spec) == []
    spec2 = types.SimpleNamespace(
        blocks=triplet() + triplet() + [RouteBlock(layers=(3,))])
    assert resstage.res_stage_spans(spec2) == [(0, 1, 64)]


def test_quantize_res_stage_leaves_equal_jax(stage):
    rs_j, rs_t, _, _ = stage
    assert sorted(rs_t) == sorted(rs_j)
    # the JAX bundle's sx_out is a Python float made from an f32 leaf
    assert rs_t["sx_out"].dtype == torch.float32
    assert rs_t["sx_out"].item() == rs_j["sx_out"]
    for k in rs_j:
        if k == "sx_out":
            continue
        want = np.asarray(rs_j[k])
        got = rs_t[k].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)


def test_pack_res_stage_layouts(stage):
    """K5 reads row-major (N, K) matrices with K tap-major; their
    transposes are the column-major (K, N) matrices of ``torch._int_mm``."""
    _, rs_t, pk, _ = stage
    assert pk["w1_k"].shape == (NB, C // 2, C) and pk["w1_k"].is_contiguous()
    assert pk["w3_k"].shape == (NB, C, 9 * C // 2) and pk["w3_k"].is_contiguous()
    # w3_k[blk, n, tap·C/2 + c] is w3[blk, tap, c, n]
    assert pk["w3_k"][2, 7, 5 * (C // 2) + 3] == rs_t["w3"][2, 5, 3, 7]
    assert torch.equal(pk["w1_k"][1].t(), rs_t["w1"][1])
    assert pk["w3_k"][0].t().stride() == (1, 9 * C // 2)
    assert pk["sx_out"].shape == (1,) and pk["sx1"].shape == (NB,)


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def test_reference_bit_equal_to_jax(stage):
    rs_j, _, pk, x = stage
    with jax.disable_jit():
        xr_j, yq_j = jrs.res_stage_reference(jnp.asarray(x, jnp.bfloat16), rs_j,
                                             NB, SLOPE)
    xr, yq = resstage.res_stage_reference(_bf16(x), pk, NB, SLOPE)
    assert yq.dtype == torch.int8 and xr.dtype == torch.bfloat16
    np.testing.assert_array_equal(yq.numpy(), np.asarray(yq_j))
    np.testing.assert_array_equal(xr.float().numpy(), np.asarray(xr_j, np.float32))


def test_plain_k5_bit_equal_to_pallas_interpret(stage):
    """The port's flat plain version against the TPU kernel itself, run in
    Pallas interpret mode (G=2) on the same flat zero-bordered input."""
    rs_j, _, pk, x = stage
    xj = jnp.asarray(x, jnp.bfloat16)
    with jax.disable_jit():
        yq_j, ybf_j = jrs.fused_res_stage(jrs.res_stage_pre(xj), jrs.stage_mask(S, 2),
                                          rs_j, S=S, G=2, n_blocks=NB,
                                          leaky_slope=SLOPE, interpret=True)
    xf = resstage.res_stage_pre(_bf16(x))
    np.testing.assert_array_equal(xf.float().numpy(),
                                  np.asarray(jrs.res_stage_pre(xj), np.float32))
    before = resstage.fused_res_stage.launches
    yq, ybf = resstage.fused_res_stage(xf, pk, S, NB, SLOPE)
    assert resstage.fused_res_stage.launches == before  # the plain version
    assert yq.shape == ybf.shape == (B * (S + 2) ** 2, C)
    np.testing.assert_array_equal(yq.numpy(), np.asarray(yq_j))
    np.testing.assert_array_equal(ybf.float().numpy(), np.asarray(ybf_j, np.float32))
    full = resstage.res_stage_post(yq, B, S)
    for edge in (full[:, 0], full[:, -1], full[:, :, 0], full[:, :, -1]):
        assert int(edge.abs().max()) == 0  # the next conv's zero padding


def test_stage_equals_the_int8_darknet_blocks():
    """On YOLOv3 at 64² (the 26² stage becomes 4²), K5's plain version on the
    int8 forward's stage input equals the int8 Darknet's own walk through
    the stage's blocks: ``ybf`` is the last shortcut's output and ``yq``
    that output quantized with the next conv's input scale."""
    spec = flagship_spec(64)
    rng = np.random.default_rng(3)
    yp, ys = convert.init_darknet_np(spec, rng)
    spec1, folded = stem_opt.slice_preyolo(
        spec, darknet.fold_bn(convert.from_jax(yp), convert.from_jax(ys), spec))
    frames = torch.from_numpy(rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32))
    amax = quantize.calibrate(spec1, folded, frames)
    yolo_q = quantize.quantize_params(spec1, folded, amax)
    model = quantize.Int8Darknet(spec1, yolo_q, entry.quantize_entry(folded, amax))
    start, nb, c = next(s for s in resstage.res_stage_spans(spec1) if s[2] == 512)
    pk = resstage.pack_res_stage(
        resstage.quantize_res_stage(yolo_q, start, nb, start + 3 * nb))
    with torch.inference_mode():
        x = model.truncated_forward(frames.to(torch.bfloat16), start - 1)
        want = model.truncated_forward(frames.to(torch.bfloat16), start + 3 * nb - 1)
        s = x.shape[1]
        yq, ybf = resstage.fused_res_stage(resstage.res_stage_pre(x), pk, s, nb, SLOPE)
    assert x.shape == (2, 4, 4, c) and nb == 8
    inner = np.s_[:, 1:s + 1, 1:s + 1]
    assert torch.equal(resstage.res_stage_post(ybf, 2, s)[inner], want)
    assert torch.equal(resstage.res_stage_post(yq, 2, s)[inner],
                       quantize._q8(want, model.convs[str(start + 3 * nb)].sx_inv))
    with pytest.raises(ValueError, match="cannot stop"):
        model.truncated_forward(frames, 3)  # inside the fused entry


def test_truncated_forward_ends_the_walk_where_asked():
    """The last block of the flagship spec is a yolo head: the walk cut
    there returns the last pre-yolo map of ``forward_features``."""
    spec = flagship_spec(64)
    yp, ys = convert.init_darknet_np(spec, np.random.default_rng(4))
    model = darknet.Darknet(spec, darknet.fold_bn(convert.from_jax(yp),
                                                  convert.from_jax(ys), spec))
    x = torch.from_numpy(np.random.default_rng(5).uniform(0, 1, (1, 64, 64, 3))
                         .astype(np.float32))
    with torch.inference_mode():
        heads = model.forward_features(x)
        last = model.truncated_forward(x, len(spec.blocks) - 1)
    assert torch.equal(last, heads[-1])

