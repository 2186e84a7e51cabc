"""The port's YOLO loss (``models/yolo_loss.py``) against the JAX package's
on the CPU, on the same numpy targets and head outputs.

Tolerances. ``build_targets`` is bit-equal, every field: its logs go
through ``log_f32``, the Cephes polynomial XLA:CPU evaluates (``torch.log``
is an ulp off on ~12% of values), and duplicate writes of one cell are
resolved to the highest row, as XLA's in-order scatter leaves them. The
losses: XLA's ``exp``/``log1p`` inside softplus are other approximations
than torch's (≤ 5e-7 absolute on the conf BCE terms) and the masked means
sum in another order, so the loss and its six components are held within
2e-6 relative; ``_bce_logits`` elementwise within 2e-6 relative plus
1e-6 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mit_driverless_cv_traininginfra_tpu.models import yolo_loss as jloss
from mit_driverless_cv_traininginfra_tpu_torch.models import yolo_loss

from _torch_port import tiny_port_spec, tiny_spec

ANCHORS = [(1.2, 1.5), (2.5, 3.1), (5.0, 4.0)]
FIELDS = jloss.YoloTargets._fields
REL = 2e-6


def _rand_targets(rng, B, T, grid=13):
    """Up to T boxes an image in distinct cells, zero-padded rows after."""
    target = np.zeros((B, T, 5), np.float32)
    for b in range(B):
        n = rng.integers(1, T + 1)
        cells = rng.choice(grid * grid, size=n, replace=False)
        for t in range(n):
            cy, cx = divmod(int(cells[t]), grid)
            target[b, t] = [rng.integers(0, 3), (cx + rng.uniform(0.1, 0.9)) / grid,
                            (cy + rng.uniform(0.1, 0.9)) / grid,
                            rng.uniform(0.02, 0.4), rng.uniform(0.02, 0.4)]
    return target


def _shared_cell():
    """Rows 0, 1 and 3 of image 0 fall into cell (6, 6) with one best
    anchor, with other offsets, sizes and classes; row 2 is padding (it
    repeats row 0) and row 4 lies elsewhere, so row 3 wins. In image 1 the
    padded rows after row 1 repeat row 0, so row 0's values win there."""
    target = np.zeros((2, 5, 5), np.float32)
    target[0, 0] = [0, 6.2 / 13, 6.3 / 13, 0.10, 0.12]
    target[0, 1] = [1, 6.7 / 13, 6.8 / 13, 0.11, 0.13]
    target[0, 3] = [2, 6.5 / 13, 6.4 / 13, 0.105, 0.125]
    target[0, 4] = [0, 1.5 / 13, 1.5 / 13, 0.2, 0.2]
    target[1, 0] = [0, 2.5 / 13, 9.5 / 13, 0.05, 0.3]
    target[1, 1] = [1, 2.6 / 13, 9.1 / 13, 0.06, 0.28]
    return target


def _edges():
    """Boxes on the grid's edges: centres at 0 and at exactly 1 (gi, gj
    clip to the last cell), one wider than the frame, and a padded image
    0 row before a real row 2."""
    target = np.zeros((2, 3, 5), np.float32)
    target[0, 0] = [0, 1.0, 1.0, 0.2, 0.3]
    target[0, 2] = [0, 0.0, 0.0, 0.01, 0.02]
    target[1, 0] = [0, 0.999999, 0.5, 1.3, 0.9]
    target[1, 1] = [0, 0.5, 0.0, 0.07, 0.05]
    return target


def _global_ignore():
    """A large box in image 0 and a tiny one elsewhere in image 1: image
    0's cell leaves the conf loss of image 1 too."""
    target = np.zeros((2, 1, 5), np.float32)
    target[0, 0] = [0, 0.5, 0.5, 0.3, 0.3]
    target[1, 0] = [0, 0.1, 0.1, 0.01, 0.01]
    return target


CASES = {
    "random": (lambda: _rand_targets(np.random.default_rng(0), 4, 6), 3),
    "padded": (lambda: _rand_targets(np.random.default_rng(1), 3, 8), 1),
    "shared_cell": (_shared_cell, 3),
    "edges": (_edges, 1),
    "global_ignore": (_global_ignore, 1),
}


def _port_targets(target, num_classes, anchors=ANCHORS, grid=13, thresh=0.5):
    return yolo_loss.build_targets(torch.from_numpy(target),
                                   torch.tensor(anchors, dtype=torch.float32),
                                   num_classes, grid, grid, thresh)


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_targets_bit_equal(case):
    make, num_classes = CASES[case]
    target = make()
    got = _port_targets(target, num_classes)
    want = jloss.build_targets(jnp.asarray(target), jnp.asarray(ANCHORS),
                               num_classes, 13, 13, 0.5)
    for name, g, w in zip(FIELDS, got, want):
        w = np.asarray(w)
        assert g.dtype == (torch.bool if w.dtype == bool else torch.float32), name
        assert g.shape == w.shape, name
        g = g.numpy()
        if w.dtype != bool:  # bits: equal values and equal signs of zero
            g, w = g.view(np.uint32), w.view(np.uint32)
        np.testing.assert_array_equal(g, w, err_msg=f"{case}: {name}")


def test_shared_cell_takes_the_highest_row():
    t = _port_targets(_shared_cell(), 3)
    j, i = 6, 6
    best = int(t.mask[0, :, j, i].nonzero()[0, 0])
    assert int(t.mask[0, :, j, i].sum()) == 1
    assert float(t.tx[0, best, j, i]) == pytest.approx(0.5, abs=1e-5)  # row 3
    assert float(t.ty[0, best, j, i]) == pytest.approx(0.4, abs=1e-5)
    # every row's class is set in the shared slot: the writes are all 1.0
    assert t.tcls[0, best, j, i].tolist() == [1.0, 1.0, 1.0]
    j, i = 9, 2
    best = int(t.mask[1, :, j, i].nonzero()[0, 0])
    assert float(t.tx[1, best, j, i]) == pytest.approx(0.5, abs=1e-5)  # row 0


def test_global_ignore_reaches_the_other_image():
    t = _port_targets(_global_ignore(), 1)
    assert not bool(t.conf_mask[1, :, 6, 6].all())


def test_log_f32_bit_equal_to_xla():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(1e-6, 50, 200_000),
                        np.exp(rng.uniform(-60, 60, 100_000)),
                        [1e-16, 0.5, 1.0, 2.0, 3.4e38, 1.17549435e-38]]).astype(np.float32)
    got = yolo_loss.log_f32(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jnp.log)(jnp.asarray(x)))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_bce_logits_matches_jax_in_saturation():
    """|l| in (16.6, 100), where σ(l) rounds to 1 and the post-sigmoid form
    reads its clamp, and |l| > 100, where the clamp binds; t at 0, 1 and
    between. The gradient is sigmoid's: finite and bounded."""
    rng = np.random.default_rng(4)
    l = np.concatenate([rng.uniform(16.6, 100, 64), -rng.uniform(16.6, 100, 64),
                        rng.uniform(100, 300, 16), -rng.uniform(100, 300, 16),
                        rng.normal(0, 4, 64), [0.0, 100.0, -100.0]]).astype(np.float32)
    t = rng.choice([0.0, 1.0, 0.3], l.size).astype(np.float32)
    lt = torch.from_numpy(l).requires_grad_(True)
    got = yolo_loss._bce_logits(lt, torch.from_numpy(t))
    want = np.asarray(jloss._bce_logits(jnp.asarray(l), jnp.asarray(t)))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=REL, atol=1e-6)
    assert float(got.detach().max()) <= 100.0
    got.sum().backward()
    jgrad = jax.grad(lambda x: jnp.sum(jloss._bce_logits(x, jnp.asarray(t))))(
        jnp.asarray(l))
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-7)


def _heads(spec, B, seed):
    """Random pre-yolo maps for the tiny spec's two heads (64²: 16² and
    32² grids)."""
    from mit_driverless_cv_traininginfra_tpu.config.darknet_cfg import YoloBlock

    rng = np.random.default_rng(seed)
    heads = []
    for yb, g in zip([b for b in spec.blocks if isinstance(b, YoloBlock)], (16, 32)):
        heads.append(rng.normal(0, 2, (B, g, g, len(yb.anchors) * 6)).astype(np.float32))
    return heads


@pytest.mark.parametrize("seed", [5, 6])
def test_head_and_total_loss_match_jax(seed):
    spec, tspec = tiny_spec(), tiny_port_spec()
    B = 3
    heads = _heads(spec, B, seed)
    target = _rand_targets(np.random.default_rng(seed), B, 5, grid=16)
    target[:, :, 0] = 0
    kw = dict(xy_loss=2.0, wh_loss=1.6, object_loss=0.1, no_object_loss=25.0)
    want_l, want_c = jloss.yolo_loss(spec, [jnp.asarray(h) for h in heads],
                                     jnp.asarray(target), **kw)
    got_l, got_c = yolo_loss.yolo_loss(tspec, [torch.from_numpy(h) for h in heads],
                                       torch.from_numpy(target), **kw)
    assert got_c.shape == (6,) and got_l.dtype == torch.float32
    assert float(got_l) == pytest.approx(float(want_l), rel=REL)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=REL, atol=1e-9)
    yb = [b for b in tspec.blocks if b.__class__.__name__ == "YoloBlock"][0]
    hl, hc = yolo_loss.yolo_head_loss(
        torch.from_numpy(heads[0]), torch.from_numpy(target), yb.anchors,
        tspec.net.height, 1, 0.5, **kw)
    jl, jc = jloss.yolo_head_loss(jnp.asarray(heads[0]), jnp.asarray(target),
                                  yb.anchors, spec.net.height, 1, 0.5, **kw)
    assert float(hl) == pytest.approx(float(jl), rel=REL)
    np.testing.assert_allclose(hc.numpy(), np.asarray(jc), rtol=REL, atol=1e-9)
    assert float(hl) == pytest.approx(float(hc.sum()), rel=1e-6)
