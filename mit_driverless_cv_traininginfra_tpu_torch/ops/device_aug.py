"""Batched augmentation on the device, inside the train step (counterpart
of the JAX package's ``ops/device_aug.py``).

Drawing is split from applying: :func:`sample_draws` takes every random
number a batch needs from an explicit ``torch.Generator`` on the images'
device (nothing is read back to the host), and :func:`apply` computes the
rest from those draws, so a test can feed both packages the same draws.

Ops (the reference's sampling ranges):

- random affine: angle ±10°, translate ±40 px, scale 0.9–1.1, shear ±3° —
  an inverse-map bilinear warp with grey fill, coordinates in f32 whatever
  the images' dtype, and the label rewarp of ``data/augment.affine_labels``;
- random left-right flip (p = 0.5);
- brightness / contrast / saturation jitter, factors U(0.75, 1.25), in RGB
  (the host path's hue jitter is not done here);
- additive Gaussian noise, scale U(0, 0.03).

Images are (B, H, W, C) in [0, 1]; labels (B, T, 5) ``[c, x1, y1, x2, y2]``
in pixels, zero rows padding.
"""

from __future__ import annotations

import torch

GREY = 127.0 / 255.0


def sample_draws(gen: torch.Generator, B: int, H: int, W: int, C: int = 3, *,
                 augment_affine: bool = False, lr_flip: bool = True,
                 jitter: bool = True, noise: bool = False) -> dict:
    """Every random number one batch of :func:`apply` needs, drawn from
    ``gen`` on its device: ``angle``, ``tx``, ``ty``, ``scale``, ``shear``
    (B,) for the affine warp; ``flip`` (B,) bool; ``b``, ``c``, ``s`` (B, 1,
    1, 1) jitter factors; ``noise_scale`` (B, 1, 1, 1) and ``noise`` (B, H,
    W, C) standard normals. Only the enabled ops' draws are present."""
    dev = gen.device

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    d = {}
    if augment_affine:
        d["angle"] = uniform((B,), -10.0, 10.0)
        d["tx"] = uniform((B,), -40.0, 40.0)
        d["ty"] = uniform((B,), -40.0, 40.0)
        d["scale"] = uniform((B,), 0.9, 1.1)
        d["shear"] = uniform((B,), -3.0, 3.0)
    if lr_flip:
        d["flip"] = torch.rand((B,), generator=gen, device=dev) < 0.5
    if jitter:
        for k in ("b", "c", "s"):
            d[k] = uniform((B, 1, 1, 1), 0.75, 1.25)
    if noise:
        d["noise_scale"] = uniform((B, 1, 1, 1), 0.0, 0.03)
        d["noise"] = torch.randn((B, H, W, C), generator=gen, device=dev)
    return d


def affine_matrices(draws: dict, h: int, w: int):
    """Forward label homographies M = S·T·R of the draws and their
    inverses for the image warp: (M (B, 3, 3), M_inv (B, 3, 3)), f32."""
    ang, sc, sh = draws["angle"], draws["scale"], draws["shear"]
    B = ang.shape[0]
    rad = torch.deg2rad(ang)
    alpha = sc * torch.cos(rad)
    beta = sc * torch.sin(rad)
    zeros, ones = torch.zeros_like(alpha), torch.ones_like(alpha)
    R = torch.stack([
        torch.stack([alpha, beta, (1 - alpha) * (w / 2.0) - beta * (h / 2.0)], -1),
        torch.stack([-beta, alpha, (beta * w / 2.0) + (1 - alpha) * (h / 2.0)], -1),
        torch.stack([zeros, zeros, ones], -1),
    ], dim=1)
    eye = torch.eye(3, device=ang.device).expand(B, 3, 3)
    T = eye.clone()
    T[:, 0, 2], T[:, 1, 2] = draws["tx"], draws["ty"]
    tan = torch.tan(torch.deg2rad(sh))
    S = eye.clone()
    S[:, 0, 1], S[:, 0, 2] = tan, -tan * h / 2.0
    M = S @ T @ R
    # inv_ex: no check of the result on the host (a scale ≥ 0.9 keeps M
    # invertible), so no sync on the card
    return M, torch.linalg.inv_ex(M).inverse


def warp_bilinear(images, M_inv, fill: float = GREY):
    """Inverse-map bilinear warp of (B, H, W, C) images with a constant
    fill. The coordinates are f32 whatever the images' dtype (a bf16 grid
    cannot hold odd pixel indices above 256); only the [0, 1] weights are
    cast to the images' dtype for the blend."""
    B, H, W, C = images.shape
    dev = images.device
    gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    pts = torch.stack([gx, gy, torch.ones_like(gx)], -1).reshape(1, H * W, 3)
    src = torch.einsum("bij,bpj->bpi", M_inv.float(), pts.expand(B, -1, -1))
    sx = src[..., 0] / src[..., 2]
    sy = src[..., 1] / src[..., 2]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    flat = images.reshape(B, H * W, C)
    fill_v = torch.tensor(fill, dtype=images.dtype, device=dev)

    def sample(yi, xi):
        inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        yc = yi.clamp(0, H - 1).to(torch.int64)
        xc = xi.clamp(0, W - 1).to(torch.int64)
        idx = (yc * W + xc)[..., None].expand(-1, -1, C)
        return torch.where(inb[..., None], torch.gather(flat, 1, idx), fill_v)

    def wgt(v):
        return v.to(images.dtype)[..., None]

    out = (sample(y0, x0) * wgt((1 - fy) * (1 - fx))
           + sample(y0, x0 + 1) * wgt((1 - fy) * fx)
           + sample(y0 + 1, x0) * wgt(fy * (1 - fx))
           + sample(y0 + 1, x0 + 1) * wgt(fy * fx))
    return out.reshape(B, H, W, C)


def affine_labels_batch(labels, M, angles, h: int, w: int):
    """The label rewarp of ``data/augment.affine_labels`` over a batch:
    warp the 4 corners through M, take the enclosing box, shrink it by the
    angle, clamp, and update only non-degenerate boxes. Boxes that fail the
    filter keep their pre-warp coordinates (the reference's quirk); zero
    rows stay zero rows of the same kind."""
    B, T, _ = labels.shape
    height = max(w, h)
    pts = labels[..., 1:5]
    area0 = (pts[..., 2] - pts[..., 0]) * (pts[..., 3] - pts[..., 1])
    corners = torch.stack([
        pts[..., 0], pts[..., 1],
        pts[..., 2], pts[..., 3],
        pts[..., 0], pts[..., 3],
        pts[..., 2], pts[..., 1],
    ], -1).reshape(B, T * 4, 2)
    xy = torch.cat([corners, torch.ones((B, T * 4, 1), dtype=labels.dtype,
                                        device=labels.device)], -1)
    warped = torch.einsum("bij,bpj->bpi", M.to(labels.dtype), xy)
    warped = (warped[..., :2] / warped[..., 2:3]).reshape(B, T, 4, 2)
    x, y = warped[..., 0], warped[..., 1]
    boxes = torch.stack([x.amin(-1), y.amin(-1), x.amax(-1), y.amax(-1)], -1)

    rad = torch.deg2rad(angles)[:, None]
    reduction = torch.maximum(torch.sin(rad).abs(), torch.cos(rad).abs()) ** 0.5
    cx = (boxes[..., 2] + boxes[..., 0]) / 2
    cy = (boxes[..., 3] + boxes[..., 1]) / 2
    bw = (boxes[..., 2] - boxes[..., 0]) * reduction
    bh = (boxes[..., 3] - boxes[..., 1]) * reduction
    boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)
    boxes = boxes.clamp(0, height)

    bw = boxes[..., 2] - boxes[..., 0]
    bh = boxes[..., 3] - boxes[..., 1]
    area = bw * bh
    ar = torch.maximum(bw / (bh + 1e-16), bh / (bw + 1e-16))
    keep = (bw > 4) & (bh > 4) & (area / (area0 + 1e-16) > 0.1) & (ar < 10)
    new_pts = torch.where(keep[..., None], boxes, pts)
    return torch.cat([labels[..., 0:1], new_pts], -1)


def apply(images, labels, draws: dict):
    """Augment a batch with :func:`sample_draws`' draws, in the JAX
    ``augment_batch``'s order: affine, flip, jitter, noise (each only when
    its draws are present). Returns ``(images, labels)``, labels in
    pixels; the jitter and the noise promote the images to f32."""
    B, H, W, C = images.shape
    if "angle" in draws:
        M, M_inv = affine_matrices(draws, H, W)
        images = warp_bilinear(images, M_inv)
        labels = affine_labels_batch(labels, M, draws["angle"], H, W)
    if "flip" in draws:
        do = draws["flip"]
        images = torch.where(do[:, None, None, None], images.flip(2), images)
        valid = labels.sum(-1, keepdim=True) > 0
        fl = torch.stack([labels[..., 0], W - labels[..., 3], labels[..., 2],
                          W - labels[..., 1], labels[..., 4]], -1)
        labels = torch.where(do[:, None, None] & valid, fl, labels)
    if "b" in draws:
        images = images * draws["b"]
        mean = images.mean(dim=(1, 2, 3), keepdim=True)
        images = (images - mean) * draws["c"] + mean
        grey = images.mean(dim=-1, keepdim=True)
        images = ((images - grey) * draws["s"] + grey).clamp(0.0, 1.0)
    if "noise" in draws:
        images = (images + draws["noise"] * draws["noise_scale"]).clamp(0.0, 1.0)
    return images, labels


def pixel_labels_to_targets(labels, H: int, W: int):
    """(B, T, 5) pixel-corner labels → normalised ``[c, cx, cy, w, h]``
    targets, zero rows kept zero (as the JAX device-aug step does)."""
    valid = labels.sum(-1, keepdim=True) > 0
    x1, y1, x2, y2 = labels[..., 1], labels[..., 2], labels[..., 3], labels[..., 4]
    targets = torch.stack([labels[..., 0], (x1 + x2) * 0.5 * (1.0 / W),
                           (y1 + y2) * 0.5 * (1.0 / H), (x2 - x1).abs() * (1.0 / W),
                           (y2 - y1).abs() * (1.0 / H)], -1)
    return torch.where(valid, targets, torch.zeros((), device=labels.device))
