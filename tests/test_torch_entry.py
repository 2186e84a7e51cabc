"""The port's fused int8 entry (``ops/entry.py``) against the JAX package's
``ops/pallas_entry.py`` on the CPU: applicability, the conv1 rewrite and
the quantized bundle (bit-equal), and the plain version of kernel K4,
held to both the XLA twin and the Pallas kernel in interpret mode.

Tolerance of the int8 outputs: ±1 int8 step with ≥ 97% of values equal,
the bound the JAX package holds its own kernel to against its XLA twin
(XLA:CPU may contract ``acc·scale + b`` into one FMA, which moves a value
across a requant rounding boundary now and then)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import entry_specs, tiny_port_spec, tiny_spec, to_numpy
from mit_driverless_cv_traininginfra_tpu.config.flagship import (
    flagship_spec as jflagship_spec,
)
from mit_driverless_cv_traininginfra_tpu.ops import pallas_entry as jentry
from mit_driverless_cv_traininginfra_tpu_torch import convert
from mit_driverless_cv_traininginfra_tpu_torch.config.flagship import flagship_spec
from mit_driverless_cv_traininginfra_tpu_torch.models import quantize
from mit_driverless_cv_traininginfra_tpu_torch.ops import entry

AMAX = {"0": 1.0, "1": 3.0, "2": 2.0, "3": 2.5, "5": 4.0}
SLOPE = 0.1


def _rand_folded(rng):
    """Folded blocks 0-3 in the JAX layout (HWIO), as the JAX package's
    tests/test_pallas_entry.py makes them."""
    def conv(shape):
        return {"w": rng.standard_normal(shape).astype(np.float32) * 0.1,
                "b": rng.standard_normal(shape[-1]).astype(np.float32) * 0.1}

    return {"0": conv((3, 3, 3, 32)), "1": conv((3, 3, 32, 64)),
            "2": conv((1, 1, 64, 32)), "3": conv((3, 3, 32, 64))}


@pytest.fixture(scope="module")
def bundles():
    """The same folded weights quantized by both packages, plus frames:
    ``(folded, JAX bundle, port bundle, port bundle packed, frames)``."""
    rng = np.random.default_rng(2)
    folded = _rand_folded(rng)
    jep = jentry.quantize_entry(folded, AMAX)
    tep = entry.quantize_entry(convert.from_jax(folded), AMAX)
    frames = rng.random((2, 64, 64, 3)).astype(np.float32)
    return folded, jep, tep, entry.pack_entry(tep), frames


def _within_one_step(got, want):
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1
    assert float((got == want).mean()) >= 0.97


def test_applicability(tmp_path):
    assert entry.entry_block_applicable(flagship_spec(416))
    assert entry.entry_block_applicable(entry_specs(tmp_path)[1])
    assert not entry.entry_block_applicable(tiny_port_spec())  # maxpool stem
    # block 5 at stride 1 is not the conv the fused path hardcodes
    bad = tmp_path / "bad"
    bad.mkdir()
    spec = entry_specs(bad)[1]
    blocks = list(spec.blocks)
    blocks[5] = dataclasses.replace(blocks[5], stride=1)
    assert not entry.entry_block_applicable(
        dataclasses.replace(spec, blocks=tuple(blocks)))
    for s, js in ((flagship_spec(416), jflagship_spec(416)),
                  (tiny_port_spec(), tiny_spec())):
        assert (entry.entry_block_applicable(s)
                == jentry.entry_block_applicable(js))


def test_build_conv1_4x4_matches_jax(bundles):
    folded = bundles[0]
    want = jentry.build_conv1_4x4(folded)
    got = entry.build_conv1_4x4(convert.from_jax(folded))
    np.testing.assert_array_equal(got["w"].permute(2, 3, 1, 0).numpy(),
                                  want["w"])
    np.testing.assert_array_equal(got["b"].numpy(), want["b"])


def test_quantize_entry_leaves_bit_equal_to_jax(bundles):
    _, jep, tep, _, _ = bundles
    want = convert.quantized_from_jax(to_numpy(jep))
    assert sorted(tep) == sorted(want)
    for k in want:
        assert tep[k].dtype == want[k].dtype, k
        assert tep[k].shape == want[k].shape, k
        assert torch.equal(tep[k], want[k]), k


def test_conv1_4x4_q8_matches_jax(bundles):
    _, jep, _, tpk, frames = bundles
    fb = jnp.asarray(frames, jnp.bfloat16)
    want = jentry.conv1_4x4_q8(fb, jep, SLOPE)
    got = entry.conv1_4x4_q8(torch.from_numpy(frames).to(torch.bfloat16),
                             tpk, SLOPE)
    assert got.dtype == torch.int8 and got.shape == (2, 32, 32, 128)
    _within_one_step(got.numpy(), want)


@pytest.mark.parametrize("frames_dtype", ["f32", "bf16"])
def test_entry_rest_matches_xla_twin(bundles, frames_dtype):
    _, jep, _, tpk, frames = bundles
    jf, tf = jnp.asarray(frames), torch.from_numpy(frames)
    if frames_dtype == "bf16":
        jf, tf = jf.astype(jnp.bfloat16), tf.to(torch.bfloat16)
    want = jentry.entry_reference_int8(jep, jf, SLOPE)
    got = entry.entry_forward_int8(tpk, tf, SLOPE)
    assert got.dtype == torch.int8 and got.shape == (2, 32, 32, 64)
    _within_one_step(got.numpy(), want)


def test_entry_rest_matches_pallas_kernel_interpret(bundles):
    """The plain version against the TPU kernel itself, run in Pallas
    interpret mode on the CPU."""
    _, jep, _, tpk, frames = bundles
    want = jentry.entry_forward_int8(jep, jnp.asarray(frames), SLOPE,
                                     interpret=True)
    got = entry.entry_forward_int8(tpk, torch.from_numpy(frames), SLOPE)
    _within_one_step(got.numpy(), want)


def test_entry_rest_on_jax_hq_matches_interpret_kernel(bundles):
    """Both fed the very same int8 hq: only the conv2p/res1 chain differs."""
    _, jep, _, tpk, frames = bundles
    hq = jentry.conv1_4x4_q8(jnp.asarray(frames), jep, SLOPE)
    want = jentry._fused_entry_interpret(hq, jep, SLOPE)
    got = entry._entry_rest(torch.from_numpy(np.array(hq)), tpk, SLOPE)
    _within_one_step(got.numpy(), want)


def test_cpu_tensor_takes_the_plain_version(bundles):
    tpk = bundles[3]
    hq = torch.from_numpy(np.random.default_rng(3).integers(
        -127, 128, (1, 16, 32, 128), dtype=np.int8))
    before = entry.fused_entry_block.launches
    got = entry.fused_entry_block(hq, tpk, SLOPE)
    assert torch.equal(got, entry._entry_rest(hq, tpk, SLOPE))
    assert entry.fused_entry_block.launches == before  # no kernel launched


def test_zero_padding_at_frame_edges(bundles):
    """Extreme hq values on the border rows and columns: the conv2p pad is
    top/left only and the 3×3 reads zeros outside the frame. The plain
    version equals a float64 evaluation of the same chain, made from the
    unpacked weights."""
    _, _, tep, tpk, _ = bundles
    rng = np.random.default_rng(4)
    hq = rng.integers(0, 20, (1, 16, 16, 128), dtype=np.int8)
    for edge in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        hq[edge] = rng.choice([-127, 127], hq[edge].shape).astype(np.int8)
    hq_t = torch.from_numpy(hq)
    got = entry._entry_rest(hq_t, tpk, SLOPE)

    def conv64(x, w, pads):
        x = torch.nn.functional.pad(x.double().permute(0, 3, 1, 2), pads)
        return torch.nn.functional.conv2d(x, w.double()).permute(0, 2, 3, 1)

    w2 = tep["w2"].reshape(2, 2, 128, 64).permute(3, 2, 0, 1)
    acc = conv64(hq_t, w2, (1, 0, 1, 0)).to(torch.int32)
    out2 = entry._deq_leaky(acc, tep["w2_scale"][0], tep["w2_b"][0], SLOPE)
    w1 = tep["w1x1"].t()[:, :, None, None]
    t = entry._deq_leaky(conv64(entry._q8(out2, tep["sx"][0, 0]), w1,
                                (0, 0, 0, 0)).to(torch.int32),
                         tep["w1x1_scale"][0], tep["w1x1_b"][0], SLOPE)
    w3 = tep["w3im"].reshape(3, 3, 32, 64).permute(3, 2, 0, 1)
    b3 = entry._deq_leaky(conv64(entry._q8(t, tep["sx"][0, 1]), w3,
                                 (1, 1, 1, 1)).to(torch.int32),
                          tep["w3_scale"][0], tep["w3_b"][0], SLOPE)
    assert torch.equal(got, entry._q8(b3 + out2, tep["sx"][0, 2]))


def test_pack_entry_layouts(bundles):
    """Each packed weight holds the bundle's integers in its consumer's
    layout: column-major matrices for ``torch._int_mm``, 16-channel groups
    for K4."""
    _, _, tep, tpk, _ = bundles
    assert not {"c1_wq", "w2", "w1x1", "w3im"} & set(tpk)
    w2 = tep["w2"].reshape(512, 64)
    for key, want in (("w2_mat", w2), ("w1x1_mat", tep["w1x1"]),
                      ("w3_mat", tep["w3im"])):
        assert torch.equal(tpk[key], want) and tpk[key].stride() == (1, want.shape[0])
    assert torch.equal(tpk["c1_wmat"], quantize._weight_matrix(tep["c1_wq"]))
    # K4 group (tap, c16, n, j) holds input channel c16·16 + j of output n
    assert torch.equal(tpk["w2_k4"][3, 5, 7, 9], w2[3 * 128 + 5 * 16 + 9, 7])
    for key, want in (("w2_k4", w2), ("w1x1_k4", tep["w1x1"]),
                      ("w3_k4", tep["w3im"])):
        got = tpk[key]
        assert got.is_contiguous() and got.shape[-1] == 16
        assert torch.equal(got.permute(0, 1, 3, 2).reshape(want.shape[0], -1),
                           want)
    for key in ("w2_scale", "w1x1_b", "sx", "c1_sx_inv", "hq_sx_inv"):
        assert tpk[key] is tep[key]
