"""The plain reference of the two-stage pipeline: YOLOv3 detect, decode,
threshold, top-k and greedy NMS, the bilinear ROI crop, RektNet and the
soft-argmax, in plain PyTorch on NCHW tensors.

It imports nothing of the program and takes nothing the program made: it
folds batch norm from the raw weight trees, slices the heads to the cone
class by decoding only the first five attributes of each anchor, and for
the int8 configuration calibrates and quantizes again by the published
recipe. It runs in one of four numerics (:class:`Numerics`):

- ``f32``: float32 everywhere, TF32 off (the reference of a bf16 or f32
  configuration);
- ``fp8``: each convolution's input and weights rounded to float8 e4m3
  (per-tensor input scale, per-output-channel weight scale), summed in f32:
  the control of a bf16 configuration, the next precision below it;
- ``int8``: post-training int8 as the configuration states it: weights
  per output channel ``s_w = max|w| / 127``, activations per tensor from
  calibrated absolute maxima, ``clip(round_half_even(x * (1/s_x)), -127,
  127)``, exact integer sums (summed in float64), ``acc * (s_w * s_x) + b``
  in f32, rounded to bf16, bf16 activations between the convolutions; the
  pre-yolo heads in bf16 with exact sums, RektNet's 1x1 head in f32;
- ``int4``: the same recipe with levels +-7: the control of the int8
  configuration.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import arch

BN_EPS = 1e-5
FP8_MAX = 448.0
QMAX = {"int8": 127, "int4": 7}


def full_f32() -> None:
    """float32 means float32: no TF32 in cuDNN convolutions or matmuls."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


class Out(NamedTuple):
    boxes: torch.Tensor      # (B, K, 4) xyxy frame pixels
    scores: torch.Tensor     # (B, K)
    mask: torch.Tensor       # (B, K) bool
    keypoints: torch.Tensor  # (B, K, 7, 2) frame pixels, 0 where not run


# -- folding ------------------------------------------------------------------

def fold_darknet(det: dict, params, state) -> Dict[str, dict]:
    """``{"<block>": {"w", "b"}}``: batch norm folded into each conv."""
    out = {}
    for c in arch.conv_shapes(det):
        k = str(c["block"])
        p = params[k]
        w = p["w"].float()
        if c["bn"]:
            s = state[k]
            inv = p["bn"]["scale"].float() / torch.sqrt(s["var"].float() + BN_EPS)
            out[k] = {"w": w * inv[:, None, None, None],
                      "b": p["bn"]["bias"].float() - s["mean"].float() * inv}
        else:
            out[k] = {"w": w, "b": p["b"].float()}
    return out


def fold_rektnet(params, state) -> Dict[str, dict]:
    """``{"stem" | "res<i>.<conv>" | "out": {"w", "b"}}``: each conv's bias
    and batch norm folded: ``w * g/s``, ``beta + (b - mu) * g/s``."""
    def fold(conv, bn_p, bn_s):
        inv = bn_p["scale"].float() / torch.sqrt(bn_s["var"].float() + BN_EPS)
        return {"w": conv["w"].float() * inv[:, None, None, None],
                "b": bn_p["bias"].float() + (conv["b"].float() - bn_s["mean"].float()) * inv}

    out = {"stem": fold(params["stem"], params["stem"]["bn"], state["stem"]),
           "out": {"w": params["out"]["w"].float(), "b": params["out"]["b"].float()}}
    names = {"conv1": "bn1", "conv2": "bn2", "shortcut_conv": "shortcut_bn"}
    for i in range(1, 5):
        p, s = params[f"res{i}"], state[f"res{i}"]
        for cname, bname in names.items():
            out[f"res{i}.{cname}"] = fold(p[cname], p[bname], s[bname])
    return out


# -- numerics -----------------------------------------------------------------

class Numerics:
    """One rounding regime of the reference (module docstring). ``amax``:
    the calibrated input absolute maximum of each conv, by name, for the
    integer regimes."""

    def __init__(self, kind: str, amax: Optional[Dict[str, float]] = None):
        if kind not in ("f32", "fp8", "int8", "int4"):
            raise ValueError(f"unknown numerics {kind!r}")
        self.kind = kind
        self.amax = amax or {}
        self._wq: Dict[str, tuple] = {}

    @property
    def integer(self) -> bool:
        return self.kind in QMAX

    @property
    def act_dtype(self):
        """What activations are held in between the convolutions."""
        return torch.bfloat16 if self.integer else torch.float32

    def _fp8(self, x, dims):
        s = x.abs().amax(dim=dims, keepdim=True).clamp_min(1e-12) / FP8_MAX
        return (x / s).to(torch.float8_e4m3fn).float() * s

    def _quantized_weights(self, name: str, w, b):
        if name not in self._wq:
            q = QMAX[self.kind]
            amax_w = w.float().abs().amax(dim=(1, 2, 3)).cpu()
            s_w = torch.clamp_min(amax_w / float(q), 1e-12).to(w.device)
            wq = torch.clamp(torch.round(w.float() / s_w[:, None, None, None]), -q, q)
            s_x = max(float(self.amax[name]), 1e-12) / q
            sx_inv = torch.tensor(1.0 / s_x, dtype=torch.float32, device=w.device)
            self._wq[name] = (wq.double(), s_w * s_x, b.float(), sx_inv)
        return self._wq[name]

    def conv(self, name: str, x, w, b, stride: int = 1, padding: int = 0,
             dilation: int = 1, linear_head: bool = False):
        """One convolution with its bias, NCHW, in this regime."""
        if self.kind == "f32":
            return F.conv2d(x.float(), w, b, stride, padding, dilation)
        if self.kind == "fp8":
            return F.conv2d(self._fp8(x.float(), (0, 1, 2, 3)),
                            self._fp8(w, (1, 2, 3)), b, stride, padding, dilation)
        if linear_head:
            # the int8 configuration's pre-yolo heads: bf16 operands, exact
            # sums, rounded once to bf16, then the bf16 bias
            y = F.conv2d(x.to(torch.bfloat16).double(),
                         w.to(torch.bfloat16).double(), None, stride, padding,
                         dilation)
            return y.to(torch.bfloat16) + b.to(torch.bfloat16)[None, :, None, None]
        wq, scale, bias, sx_inv = self._quantized_weights(name, w, b)
        q = QMAX[self.kind]
        xq = torch.clamp(torch.round(x.float() * sx_inv), -q, q)
        acc = F.conv2d(xq.double(), wq, None, stride, padding, dilation)
        y = acc.float() * scale[None, :, None, None] + bias[None, :, None, None]
        return y.to(torch.bfloat16)

    def leaky(self, x, slope: float):
        s = float(torch.tensor(slope, dtype=x.dtype))
        return torch.where(x >= 0, x, x * s)


# -- detector -----------------------------------------------------------------

class Detector:
    """YOLOv3 on folded weights; :meth:`decode` gives ``(B, N, 5)`` f32
    ``[cx, cy, w, h, conf]`` in input pixels over every anchor of every head
    (head order, then anchor, row, column)."""

    def __init__(self, det: dict, folded, numerics: Numerics):
        self.det = det
        self.blocks = arch.yolov3_blocks(det)
        self.folded = folded
        self.num = numerics
        self.grids = arch.head_grids(det)

    def heads(self, frames, hook=None):
        """frames (B, H, W, 3) f32 in [0, 1] -> the pre-yolo maps, NCHW.
        ``hook(name, x)`` sees each conv's input."""
        slope = self.det["leaky_slope"]
        x = frames.permute(0, 3, 1, 2).to(self.num.act_dtype)
        outs: List[torch.Tensor] = []
        heads = []
        for i, b in enumerate(self.blocks):
            if b.kind == "conv":
                p = self.folded[str(i)]
                if hook is not None:
                    hook(str(i), x)
                x = self.num.conv(str(i), x, p["w"], p["b"], b.stride,
                                  (b.size - 1) // 2, linear_head=not b.bn)
                if b.leaky:
                    x = self.num.leaky(x, slope)
            elif b.kind == "shortcut":
                x = outs[-1] + outs[b.src[0]]
            elif b.kind == "route":
                x = torch.cat([outs[j] for j in b.src], dim=1)
            elif b.kind == "upsample":
                x = F.interpolate(x.float(), scale_factor=b.stride,
                                  mode="nearest").to(x.dtype)
            elif b.kind == "yolo":
                heads.append(x)
            outs.append(x)
        return heads

    def decode(self, frames):
        out = []
        nattr = 5 + self.det["classes"]
        H = self.det["input"]
        for h, (head, g) in enumerate(zip(self.heads(frames), self.grids)):
            mask = self.det["masks"][h]
            B = head.shape[0]
            p = head.float().reshape(B, len(mask), nattr, g, g)[:, :, :5]
            stride = H / g
            gx = torch.arange(g, device=p.device, dtype=torch.float32)
            anc = torch.tensor([self.det["anchors"][m] for m in mask],
                               dtype=torch.float32, device=p.device)
            cx = (torch.sigmoid(p[:, :, 0]) + gx[None, None, None, :]) * stride
            cy = (torch.sigmoid(p[:, :, 1]) + gx[None, None, :, None]) * stride
            w = torch.exp(p[:, :, 2]) * anc[None, :, 0, None, None]
            hh = torch.exp(p[:, :, 3]) * anc[None, :, 1, None, None]
            conf = torch.sigmoid(p[:, :, 4])
            out.append(torch.stack([cx, cy, w, hh, conf], -1).reshape(B, -1, 5))
        return torch.cat(out, 1)


def calibrate_detector(det: dict, folded, frames) -> Dict[str, float]:
    """Absolute maximum of each conv's input over ``frames`` in f32."""
    amax: Dict[str, float] = {}

    def hook(name, x):
        amax[name] = float(x.abs().max())

    with torch.no_grad():
        Detector(det, folded, Numerics("f32")).heads(frames, hook)
    return amax


# -- threshold, top-k, NMS ----------------------------------------------------

def pairwise_iou(a, b):
    """(..., N, 4) x (..., M, 4) xyxy -> IoU without the +1 convention."""
    x1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    y1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    x2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    y2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.where(union == 0, torch.ones_like(union), union)


def nms(dets, conf_thresh: float, overlap: float, k: int):
    """dets (B, N, 5) -> the top ``k`` candidates above ``conf_thresh`` in
    descending confidence (ties to the lower index), then greedy
    suppression of later candidates at IoU > ``overlap``: ``(boxes (B, k,
    4) xyxy, scores (B, k), keep (B, k))``."""
    conf = dets[..., 4]
    masked = torch.where(conf > conf_thresh, conf, torch.full_like(conf, -torch.inf))
    order = torch.sort(masked, dim=1, descending=True, stable=True)[1][:, :k]
    top = torch.gather(masked, 1, order)
    d = torch.gather(dets, 1, order[..., None].expand(-1, -1, 5))
    xy, wh = d[..., 0:2], d[..., 2:4] / 2
    boxes = torch.cat([xy - wh, xy + wh], -1)
    iou = pairwise_iou(boxes, boxes)
    alive = torch.isfinite(top)
    keep = torch.zeros_like(alive)
    slot = torch.arange(k, device=dets.device)
    for i in range(k):
        keep[:, i] = alive[:, i]
        later = slot[None, :] > i
        alive = alive & ~(later & (iou[:, i, :] > overlap) & alive[:, i:i + 1])
    return boxes, top, keep


# -- crop ---------------------------------------------------------------------

def crop(frames, boxes, fidx, size: int, dtype=torch.float32):
    """Bilinear crops ``(n, size, size, C)`` of xyxy ``boxes`` from frames
    (B, H, W, C): sampling centres ``x0 + w * (j + 0.5) / size - 0.5`` (w
    at least 1e-3), held inside the box's last pixel, then inside the frame;
    rows first, then columns, weights and each pass rounded to ``dtype``."""
    B, H, W, C = frames.shape
    boxes = boxes.float()
    x0, y0, x1, y1 = boxes.unbind(-1)
    bw = torch.clamp(x1 - x0, min=1e-3)
    bh = torch.clamp(y1 - y0, min=1e-3)
    j = (torch.arange(size, dtype=torch.float32, device=frames.device) + 0.5) / size
    sx = x0[:, None] + bw[:, None] * j - 0.5
    sy = y0[:, None] + bh[:, None] * j - 0.5
    sx = torch.minimum(torch.maximum(sx, x0[:, None]), x1[:, None] - 1.0).clamp(0.0, W - 1.0)
    sy = torch.minimum(torch.maximum(sy, y0[:, None]), y1[:, None] - 1.0).clamp(0.0, H - 1.0)

    def taps(s, n):
        """The two source pixels and their hat weights ``max(0, 1 - |s -
        j|)``, rounded to ``dtype`` as the samples are."""
        i0 = torch.floor(s).clamp(0, n - 1)
        w0 = torch.clamp(1.0 - torch.abs(s - i0), 0.0, 1.0).to(dtype).float()
        w1 = torch.clamp(1.0 - torch.abs(s - (i0 + 1)), 0.0, 1.0).to(dtype).float()
        i0 = i0.long()
        return i0, (i0 + 1).clamp(max=n - 1), w0, w1

    y_0, y_1, wy0, wy1 = taps(sy, H)
    x_0, x_1, wx0, wx1 = taps(sx, W)
    img = frames[fidx.long()].float()                       # (n, H, W, C)
    n = img.shape[0]
    ar = torch.arange(n, device=frames.device)[:, None]
    rows = (img[ar, y_0] * wy0[..., None, None]
            + img[ar, y_1] * wy1[..., None, None]).to(dtype).float()   # (n, s, W, C)
    ar3 = ar[:, :, None]
    cols = torch.arange(size, device=frames.device)[None, :, None]
    out = (rows[ar3, cols, x_0[:, None, :]] * wx0[:, None, :, None]
           + rows[ar3, cols, x_1[:, None, :]] * wx1[:, None, :, None])
    return out.to(dtype)


# -- keypoint net ---------------------------------------------------------------

class Keypoints:
    """RektNet on folded weights and the flat soft-argmax: crops (n, S, S,
    3) -> points (n, K, 2) in [0, 1) crop coordinates (x then y, grid
    ``j / S``)."""

    def __init__(self, kp: dict, folded, numerics: Numerics):
        self.kp, self.folded, self.num = kp, folded, numerics

    def logits(self, crops, hook=None):
        num = self.num
        h = crops.permute(0, 3, 1, 2).to(num.act_dtype)

        def conv(name, x, pad=0, dil=1):
            if hook is not None:
                hook(name, x)
            p = self.folded[name]
            return num.conv(name, x, p["w"], p["b"], 1, pad, dil)

        h = F.relu(conv("stem", h, 3))
        for i in range(1, 5):
            a = F.relu(conv(f"res{i}.conv1", h, 2, 2))
            b2 = conv(f"res{i}.conv2", a, 1)
            sc = conv(f"res{i}.shortcut_conv", h)
            h = F.relu(sc + b2)
        if hook is not None:
            hook("out", h)
        p = self.folded["out"]
        if num.kind == "fp8":
            return num.conv("out", h, p["w"], p["b"])
        return F.conv2d(h.float(), p["w"], p["b"])

    def points(self, crops, block: int = 256):
        outs = []
        for s in range(0, crops.shape[0], block):
            z = self.logits(crops[s:s + block]).float()
            n, k, hh, ww = z.shape
            p = torch.softmax(z.reshape(n, k, hh * ww), dim=-1)
            xs = torch.arange(ww, device=z.device, dtype=torch.float32) / ww
            ys = torch.arange(hh, device=z.device, dtype=torch.float32) / hh
            px = (p.reshape(n, k, hh, ww) * xs).sum(dim=(2, 3))
            py = (p.reshape(n, k, hh, ww) * ys[:, None]).sum(dim=(2, 3))
            outs.append(torch.stack([px, py], -1))
        if not outs:
            return torch.zeros((0, self.kp["num_kpt"], 2), device=crops.device)
        return torch.cat(outs)


def calibrate_keypoints(kp: dict, folded, crops) -> Dict[str, float]:
    """Absolute maximum of each RektNet conv's input over ``crops``; a
    shortcut conv shares its block's first conv's input."""
    amax: Dict[str, float] = {}

    def hook(name, x):
        amax[name] = float(x.abs().max())

    with torch.no_grad():
        Keypoints(kp, folded, Numerics("f32")).logits(crops, hook)
    return amax


# -- the pipeline ---------------------------------------------------------------

class Pipeline:
    """Detect, NMS, compacted crop and keypoints, as a served pipeline
    answers: every frame ``max_det`` slots, RektNet on the top ``cap``
    valid slots of the batch (by score, ties to the lower slot), keypoints
    ``x0y0 + pts * wh`` of the box, zero where RektNet did not run."""

    def __init__(self, cfg: dict, detector: Detector, keypoints: Keypoints,
                 conf_thresh: float):
        self.cfg, self.det, self.kpt = cfg, detector, keypoints
        self.conf_thresh = conf_thresh

    def frames_in(self, frames_u8):
        x = frames_u8.float() * (1.0 / 255.0)
        return x.to(self.det.num.act_dtype).float() if self.det.num.integer else x

    @torch.no_grad()
    def __call__(self, frames_u8, cap: int) -> Out:
        sv = self.cfg["serving"]
        frames = self.frames_in(frames_u8)
        dets = self.det.decode(frames)
        boxes, scores, mask = nms(dets, self.conf_thresh, sv["nms_thresh"], sv["max_det"])
        B, K = mask.shape
        key = torch.where(mask.reshape(-1), scores.reshape(-1),
                          torch.full((B * K,), -torch.inf, device=mask.device))
        sel = torch.sort(key, descending=True, stable=True)[1][:cap]
        sel = sel[mask.reshape(-1)[sel]]
        size = self.cfg["keypoints"]["crop"]
        crops = crop(frames.to(self.det.num.act_dtype), boxes.reshape(-1, 4)[sel],
                     sel // K, size, self.det.num.act_dtype)
        pts = self.kpt.points(crops)
        kpts = torch.zeros((B * K, pts.shape[1], 2), device=mask.device)
        b = boxes.reshape(-1, 4)[sel]
        kpts[sel] = b[:, None, 0:2] + pts * (b[:, None, 2:4] - b[:, None, 0:2])
        return Out(boxes, scores, mask, kpts.reshape(B, K, -1, 2))


def build(cfg: dict, dparams, dstate, kparams, kstate, numerics: str,
          calib_frames=None, calib_crops=None, conf_thresh: float = 0.5) -> Pipeline:
    """The reference pipeline of a configuration from the raw weight trees.
    The integer regimes calibrate on ``calib_frames`` (B, H, W, 3) f32 in
    [0, 1] and ``calib_crops`` (n, S, S, 3) f32, as the configuration's
    recipe states."""
    det, kp = cfg["detector"], cfg["keypoints"]
    dfold = fold_darknet(det, dparams, dstate)
    kfold = fold_rektnet(kparams, kstate)
    if numerics in QMAX:
        damax = calibrate_detector(det, dfold, calib_frames)
        kamax = calibrate_keypoints(kp, kfold, calib_crops)
        for i in range(1, 5):
            kamax[f"res{i}.shortcut_conv"] = kamax[f"res{i}.conv1"]
        dnum, knum = Numerics(numerics, damax), Numerics(numerics, kamax)
    else:
        dnum = knum = Numerics(numerics)
    return Pipeline(cfg, Detector(det, dfold, dnum), Keypoints(kp, kfold, knum),
                    conf_thresh)


@torch.no_grad()
def pick_conf_thresh(dets, nms_thresh: float, max_det: int, group: int,
                     target: int) -> float:
    """The operating confidence threshold from the reference's f32 decode
    ``dets`` (S, N, 5) of the scene pool: the lowest at which no group of
    ``group`` consecutive scenes keeps more than ``target`` detections after
    NMS, placed in the middle of the gap above it, so that a rounding
    difference cannot move a candidate across it. Every seed so serves the
    same load, whatever its weights make of its scenes."""
    S = dets.shape[0]
    conf = dets[..., 4]
    cands = torch.unique(torch.topk(conf, 4 * max_det, dim=1).values)   # ascending

    def load(t: float) -> int:
        keep = nms(dets, t, nms_thresh, max_det)[2]
        return int(keep.reshape(S // group, -1).sum(1).max())

    lo, hi = 0, cands.numel() - 1
    while lo < hi:
        mid = (lo + hi) // 2
        if load(float(cands[mid])) <= target:
            hi = mid
        else:
            lo = mid + 1
    up = float(cands[min(lo + 1, cands.numel() - 1)])
    return (float(cands[lo]) + up) / 2 if up > cands[lo] else float(cands[lo])
