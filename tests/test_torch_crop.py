"""Kernel K1's plain version (the PyTorch port's ROI crops) against the JAX
package: the indexed XLA crop, the windowed Pallas kernel in interpret
mode, and the dense crop."""

import jax.numpy as jnp
import numpy as np
import torch

from mit_driverless_cv_traininginfra_tpu.ops.image import (
    _crop_coords as jax_crop_coords,
    _hat_matrix as jax_hat_matrix,
    roi_crop_bilinear as jax_roi_crop_bilinear,
    roi_crop_bilinear_indexed as jax_roi_crop_indexed,
)
from mit_driverless_cv_traininginfra_tpu.ops.pallas_crop import (
    roi_crop_windowed,
)
from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_crop import roi_crop
from mit_driverless_cv_traininginfra_tpu_torch.ops.image import (
    _crop_coords,
    roi_crop_bilinear,
)

# f32 crops of [0, 1] pixels. The port rounds each pass's two-tap sum once,
# so it stays within 2 ulp (2.4e-7) of an exact float64 evaluation of the
# two passes. XLA:CPU's f32 dot for the column pass lands up to 2.6e-5 off
# that exact value (measured with these seeds), so the packages are held
# to each other at 5e-5.
ATOL_EXACT = 2.4e-7
ATOL = 5e-5


def _exact_indexed(frames, boxes, fidx, out=80):
    """The indexed crop in float64 from the JAX package's f32 hat matrices,
    rows rounded to f32 between the passes as both packages do."""
    B, H, W, C = frames.shape
    sx, sy = jax_crop_coords(jnp.asarray(boxes), out, out, H, W)
    Ry = np.asarray(jax_hat_matrix(sy, H), np.float64)
    Rx = np.asarray(jax_hat_matrix(sx, W), np.float64)
    fr = frames.reshape(B, H, W * C)[fidx].astype(np.float64)
    rows = np.einsum("cih,chm->cim", Ry, fr).astype(np.float32)
    rows = rows.astype(np.float64).reshape(len(boxes), out, W, C)
    return np.einsum("cjw,ciwk->cijk", Rx, rows)


def _boxes(rng, n, size, wmax, hmax):
    """xyxy boxes inside the windowed kernel's contract (h ≤ 240, w ≤ 211
    at C=3), the first ones on the frame edges."""
    x0 = rng.uniform(0, size - 40, n)
    y0 = rng.uniform(0, size - 40, n)
    b = np.stack([x0, y0, np.minimum(x0 + rng.uniform(4, wmax, n), size - 1),
                  np.minimum(y0 + rng.uniform(4, hmax, n), size)], 1)
    b[:3] = [[0, 0, 50, 60], [size - 60, size - 80, size, size],
             [size - 30, 0, size, 100]]
    return b.astype(np.float32)


def test_crop_coords_match_jax_bitwise():
    rng = np.random.default_rng(0)
    boxes = _boxes(rng, 16, 256, 200, 200)
    boxes[4] = [10, 10, 10.0005, 30]  # degenerate width: the 1e-3 floor
    sx, sy = _crop_coords(torch.from_numpy(boxes), 80, 80, 256, 256)
    jsx, jsy = jax_crop_coords(jnp.asarray(boxes), 80, 80, 256, 256)
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))
    np.testing.assert_array_equal(sy.numpy(), np.asarray(jsy))


def test_indexed_plain_matches_xla_and_pallas_window():
    rng = np.random.default_rng(1)
    B, S, N = 2, 256, 8  # 256² is the smallest frame the window admits
    frames = rng.uniform(0, 1, (B, S, S, 3)).astype(np.float32)
    boxes = _boxes(rng, N, S, 200, 230)
    fidx = rng.integers(0, B, N).astype(np.int32)
    got = roi_crop(torch.from_numpy(frames), torch.from_numpy(boxes),
                   torch.from_numpy(fidx)).numpy()
    ref_x = np.asarray(jax_roi_crop_indexed(
        jnp.asarray(frames), jnp.asarray(boxes), jnp.asarray(fidx), 80, 80))
    ref_p = np.asarray(roi_crop_windowed(
        jnp.asarray(frames), jnp.asarray(boxes), jnp.asarray(fidx), 80, 80,
        interpret=True))
    assert got.shape == (N, 80, 80, 3)
    np.testing.assert_allclose(got, _exact_indexed(frames, boxes, fidx),
                               atol=ATOL_EXACT, rtol=0)
    np.testing.assert_allclose(got, ref_x, atol=ATOL, rtol=0)
    # at W·C = 768 lanes the window cannot reach the frame's last pixel
    # column (it clips samples to x ≤ 254): compare the crops inside that
    inside = boxes[:, 2] <= S - 1
    assert inside.sum() >= N - 2
    np.testing.assert_allclose(got[inside], ref_p[inside], atol=ATOL, rtol=0)


def test_dense_plain_matches_xla_and_indexed():
    rng = np.random.default_rng(2)
    B, K, S = 2, 4, 64
    frames = rng.uniform(0, 1, (B, S, S, 3)).astype(np.float32)
    boxes = np.stack([_boxes(rng, K, S, 50, 50) for _ in range(B)])
    got = roi_crop_bilinear(torch.from_numpy(frames), torch.from_numpy(boxes))
    ref = np.asarray(jax_roi_crop_bilinear(jnp.asarray(frames),
                                           jnp.asarray(boxes), 80, 80))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    # the dense path of the pipeline runs the indexed crop with
    # frame_idx = arange(B).repeat_interleave(K): the same values
    flat = roi_crop(torch.from_numpy(frames),
                    torch.from_numpy(boxes.reshape(B * K, 4)),
                    torch.arange(B).repeat_interleave(K))
    torch.testing.assert_close(flat.reshape(got.shape), got,
                               atol=ATOL_EXACT, rtol=0)


def test_non_finite_box_and_cpu_wrapper():
    rng = np.random.default_rng(3)
    frames = torch.from_numpy(rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32))
    boxes = torch.tensor([[-np.inf, 3.0, np.inf, np.nan], [2.0, 2.0, 30.0, 40.0]])
    before = roi_crop.launches
    out = roi_crop(frames, boxes, torch.zeros(2, dtype=torch.int64))
    assert roi_crop.launches == before  # CPU tensors take the plain version
    assert out.shape == (2, 80, 80, 3)
    assert torch.isfinite(out[1]).all()
