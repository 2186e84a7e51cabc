"""The comparison that decides ``correct`` for a served cell.

Each answer is judged by what it says, frame by frame, against the plain
reference on the same frame:

- ``det_mismatch``: the served detections (valid slots) and the
  reference's are matched greedily, highest score first, at IoU >= 0.5 on
  the same frame; the share of the detections of both sides left
  unmatched.
- ``box_err``: over the matched pairs, the corner difference over the
  reference box's longer side; ``box_err_mean`` its mean, ``box_err`` its
  largest.
- ``score_err_mean`` / ``score_err``: the confidence difference of the
  matched pairs, mean and largest.
- ``kpt_err_mean`` / ``kpt_err_p90`` / ``kpt_err``: for each served slot
  that carries keypoints, the reference RektNet is run on the reference
  crop of the served box itself; the keypoint difference in crop units (a
  fraction of the box), the largest of a slot's, then the mean, the 90th
  percentile and the largest over the slots.
- ``kpt_missing``: the share of served valid slots without keypoints.

The largest of a difference swings from seed to seed with the few
detections nearest to a rounding flip; its mean is the steady number.

Each number that the configuration limits (``limits``) has to be at or
under its limit, every sampled answer has to have come, and some
detection has to have been judged.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import reference

def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return reference.pairwise_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()


def match(sb, ss, rb, rs, thresh: float = 0.5):
    """Greedy match of served boxes ``sb`` (scores ``ss``) to reference
    boxes ``rb`` (scores ``rs``): served in descending score, each to the
    unmatched reference box of highest IoU >= ``thresh``. Returns the
    pairs ``[(i_served, j_ref)]``."""
    if len(sb) == 0 or len(rb) == 0:
        return []
    iou = _iou(sb.astype(np.float32), rb.astype(np.float32))
    used = np.zeros(len(rb), bool)
    pairs = []
    for i in np.argsort(-ss, kind="stable"):
        cand = np.where(used, -1.0, iou[i])
        j = int(np.argmax(cand))
        if cand[j] >= thresh:
            used[j] = True
            pairs.append((int(i), j))
    return pairs


@torch.no_grad()
def judge(frames: List[dict], ref_dets: Dict[int, tuple], pipe, scenes_u8,
          device) -> Dict[str, float]:
    """``frames``: the sampled served answers, each ``{"scene", "boxes",
    "scores", "mask", "keypoints"}`` (numpy rows of one frame, or None
    where the answer never came). ``ref_dets[scene]``: the reference's
    slots of that scene (:func:`reference_dets`). ``pipe``: the
    reference :class:`~.reference.Pipeline`; ``scenes_u8`` (S, H, W, 3)
    uint8 on ``device``. Returns the numbers of the module docstring,
    ``missing`` (answers that never came), ``judged`` (frames that came)
    and ``detections`` (of both sides)."""
    unmatched = total = 0
    box, score = [], []
    n_valid = n_no_kpt = 0
    crop_boxes, crop_scene, served_pts = [], [], []
    missing = 0
    for f in frames:
        if f is None:
            missing += 1
            continue
        m = f["mask"].astype(bool)
        sb, ss = f["boxes"][m], f["scores"][m]
        rb, rs, rk = ref_dets[f["scene"]]
        rb, rs = rb[rk], rs[rk]
        pairs = match(sb, ss, rb, rs)
        total += len(sb) + len(rb)
        unmatched += len(sb) + len(rb) - 2 * len(pairs)
        for i, j in pairs:
            side = max(float(rb[j, 2] - rb[j, 0]), float(rb[j, 3] - rb[j, 1]), 1.0)
            box.append(float(np.abs(sb[i] - rb[j]).max()) / side)
            score.append(abs(float(ss[i]) - float(rs[j])))
        kp = f["keypoints"][m]
        has = np.abs(kp).reshape(len(kp), -1).max(axis=1) > 0 if len(kp) else np.zeros(0, bool)
        n_valid += len(kp)
        n_no_kpt += int((~has).sum())
        for i in np.nonzero(has)[0]:
            b = sb[i]
            wh = np.maximum(b[2:4] - b[0:2], 1e-3)
            served_pts.append((kp[i] - b[None, 0:2]) / wh[None, :])
            crop_boxes.append(b)
            crop_scene.append(f["scene"])
    kpt = np.zeros(0)
    if crop_boxes:
        size = pipe.cfg["keypoints"]["crop"]
        dtype = pipe.kpt.num.act_dtype
        frames_in = pipe.frames_in(scenes_u8).to(dtype)
        boxes = torch.from_numpy(np.stack(crop_boxes).astype(np.float32)).to(device)
        fidx = torch.tensor(crop_scene, device=device)
        pts = []
        for s in range(0, len(crop_boxes), 256):
            crops = reference.crop(frames_in, boxes[s:s + 256], fidx[s:s + 256], size, dtype)
            pts.append(pipe.kpt.points(crops).cpu().numpy())
        ref_pts = np.concatenate(pts)
        kpt = np.abs(np.stack(served_pts) - ref_pts).reshape(len(ref_pts), -1).max(axis=1)

    def mean(a):
        return float(np.mean(a)) if len(a) else 0.0

    return {"det_mismatch": unmatched / max(total, 1),
            "box_err_mean": mean(box), "box_err": max(box, default=0.0),
            "score_err_mean": mean(score), "score_err": max(score, default=0.0),
            "kpt_err_mean": mean(kpt),
            "kpt_err_p90": float(np.percentile(kpt, 90)) if len(kpt) else 0.0,
            "kpt_err": float(kpt.max(initial=0.0)),
            "kpt_missing": n_no_kpt / max(n_valid, 1), "missing": missing,
            "judged": len(frames) - missing, "detections": total}


@torch.no_grad()
def reference_dets(pipe, scenes_u8, block: int = 8) -> Dict[int, tuple]:
    """The reference's NMS'd slots of every scene: ``{scene: (boxes,
    scores, keep)}`` numpy."""
    sv = pipe.cfg["serving"]
    out = {}
    for s in range(0, scenes_u8.shape[0], block):
        dets = pipe.det.decode(pipe.frames_in(scenes_u8[s:s + block]))
        b, sc, k = reference.nms(dets, pipe.conf_thresh, sv["nms_thresh"], sv["max_det"])
        for i in range(b.shape[0]):
            out[s + i] = (b[i].cpu().numpy(), sc[i].cpu().numpy(), k[i].cpu().numpy())
    return out
