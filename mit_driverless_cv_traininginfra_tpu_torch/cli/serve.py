"""Production serving CLI: a warmed ``TwoStageServer`` over a stream of
frames (counterpart of the JAX package's ``cli/serve.py``).

Loads both models (a Darknet ``.weights`` and a RektNet ``.pt``), slices
the detector's heads to its classes, quantizes to int8 on the stream's own
leading frames when asked, builds the (batch, capacity) bucket lattice
(``TwoStageServer.warmup``: a CUDA graph per bucket on the card), then
streams the source through in fixed batches; a short final batch rides a
padded bucket. Detections and their 7 keypoints are written as CSV in
source pixels; the run ends with one JSON line: frames/s and every server
counter.

    python -m mit_driverless_cv_traininginfra_tpu_torch.cli.serve \\
        --source synthetic:64 --yolo_weights yolo.weights \\
        --rektnet_weights rektnet.pt --precision int8 --batch_size 8

Sources: a directory of images (JPEG/PNG through the repository's native
core, else PIL or OpenCV) and/or ``.npy`` frames (always readable), a
video file (needs OpenCV), or ``synthetic:N`` (N rendered cone scenes at
the model's input size). Runs on ``--device cuda`` unless ``--device cpu``
is asked for.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import sys
import threading
import time
from collections import deque

import numpy as np
import torch

from mit_driverless_cv_traininginfra_tpu_torch.utils.logger import add_bool_arg

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".npy")
VID_EXTS = (".mp4", ".avi", ".mov", ".mkv")

LEFT_OUT = ("Not carried over from the JAX package's serve CLI: --mesh "
            "(multi-device serving is not ported), and --crop_kernel and "
            "--syn_oversize_tail, which drive the TPU crop kernel's DMA "
            "window and its oversize watch; the CUDA crop samples boxes of "
            "every size exactly.")


def _iter_source(source: str):
    """Yield (frame index, RGB uint8 H×W×3) from a video file or a
    directory of images / ``.npy`` frames, in name order."""
    from mit_driverless_cv_traininginfra_tpu_torch.data.decode import read_rgb

    ext = os.path.splitext(source)[1].lower()
    if ext in VID_EXTS:
        import cv2  # a video needs OpenCV

        cap = cv2.VideoCapture(source)
        if not cap.isOpened():
            raise IOError(f"cannot open video {source}")
        try:
            i = 0
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                yield i, cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                i += 1
        finally:
            cap.release()
        return
    if os.path.isdir(source):
        names = sorted(n for n in os.listdir(source)
                       if os.path.splitext(n)[1].lower() in IMG_EXTS)
        if not names:
            raise IOError(f"no frames ({'/'.join(IMG_EXTS)}) in {source}")
        for i, n in enumerate(names):
            yield i, read_rgb(os.path.join(source, n))
        return
    raise IOError("--source must be a video file, a directory of images or "
                  f".npy frames, or synthetic:N; got {source}")


def _prefetch(gen, depth: int):
    """Run ``gen`` on a daemon thread, yielding through a bounded queue:
    decode and letterbox overlap the device's work. A producer exception
    is raised again in the consumer."""
    q: queue.Queue = queue.Queue(maxsize=max(2, depth))
    done = object()

    def work():
        try:
            for item in gen:
                q.put(item)
            q.put(done)
        except BaseException as e:  # noqa: BLE001 — raised in the consumer
            q.put(e)

    threading.Thread(target=work, daemon=True).start()
    while True:
        item = q.get()
        if item is done:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def _letterbox_u8(img: np.ndarray, H: int, W: int) -> np.ndarray:
    """One RGB uint8 frame letterboxed to (H, W) on the host: the native
    core when it builds (cv2-exact), PIL otherwise, else the port's own
    ``ops.image.letterbox`` on the CPU, rounded back to uint8."""
    from mit_driverless_cv_traininginfra_tpu_torch.data.decode import native_core
    from mit_driverless_cv_traininginfra_tpu_torch.ops.boxes import (
        calculate_padding,
    )

    nat = native_core()
    if nat is not None:
        return nat.letterbox(np.ascontiguousarray(img), H, W)
    h, w = img.shape[:2]
    try:
        from PIL import Image
    except ImportError:
        from mit_driverless_cv_traininginfra_tpu_torch.ops.image import letterbox

        out, _ = letterbox(torch.from_numpy(img).float() / 255.0, H, W)
        return (out * 255.0).round().clamp(0, 255).to(torch.uint8).numpy()
    pad_h, pad_w, _ = calculate_padding(h, w, H, W)
    padded = Image.new("RGB", (w + 2 * pad_w, h + 2 * pad_h), (127, 127, 127))
    padded.paste(Image.fromarray(img), (pad_w, pad_h))
    return np.asarray(padded.resize((W, H), Image.BILINEAR))


def _darknet_trees(spec):
    """(params, state) trees holding only each conv's weight shape, for
    :func:`models.darknet.load_darknet_weights` to fill."""
    from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import (
        ConvBlock,
    )

    return {str(i): {"w": torch.empty((b.filters, spec.out_channels[i],
                                       b.size, b.size))}
            for i, b in enumerate(spec.blocks)
            if isinstance(b, ConvBlock)}, {}


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="warmed two-stage serving over a stream of frames",
        epilog=LEFT_OUT)
    parser.add_argument("--source", type=str, required=True,
                        help="video file (needs OpenCV), directory of "
                             "images and/or .npy frames, or synthetic:N (N "
                             "rendered cone scenes at the model input "
                             "size: the device's rate through the server, "
                             "no decode or letterbox)")
    parser.add_argument("--model_cfg", type=str,
                        default="model_cfg/yolo_baseline.cfg")
    parser.add_argument("--yolo_weights", type=str, required=True,
                        help="Darknet .weights file")
    parser.add_argument("--rektnet_weights", type=str, required=True,
                        help="RektNet .pt checkpoint")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu, only when asked")
    parser.add_argument("--precision", choices=("int8", "bf16", "f32"),
                        default="int8",
                        help="serving precision (int8 calibrates on the "
                             "stream's first frames)")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--conf_thres", type=float, default=0.8)
    parser.add_argument("--nms_thres", type=float, default=0.25)
    parser.add_argument("--max_det", type=int, default=16)
    parser.add_argument("--capacities", type=str, default="",
                        help="comma-separated crop-capacity lattice to warm "
                             "(default: the policy's buckets from its floor)")
    parser.add_argument("--calib_frames", type=int, default=8,
                        help="leading stream frames used for int8 "
                             "calibration")
    parser.add_argument("--output_csv", type=str, default="",
                        help="write per-detection rows (frame, box, conf, "
                             "7 keypoints) in source pixels")
    parser.add_argument("--observe_every", type=int, default=8)
    parser.add_argument("--inflight", type=int, default=1,
                        help="batches kept in flight before fencing the "
                             "oldest (results stay in order)")
    parser.add_argument("--syn_repeat", type=int, default=1,
                        help="cycle the synthetic scenes this many times "
                             "(render once, serve N·R frames)")
    add_bool_arg(parser, "latency_mode", False,
                 "serve frame by frame through the MicroBatcher and report "
                 "fenced per-request latency percentiles")
    parser.add_argument("--latency_buckets", type=str, default="1,2",
                        help="batch buckets to warm and aggregate into in "
                             "latency mode")
    parser.add_argument("--cameras", type=int, default=2,
                        help="simulated concurrent camera streams in "
                             "latency mode (frames submitted per wave)")
    parser.add_argument("--max_wait_ms", type=float, default=2.0,
                        help="MicroBatcher co-arrival window")
    add_bool_arg(parser, "vanilla_anchor", False, "use the vanilla anchors")
    add_bool_arg(parser, "feed_uint8", True,
                 "ship frames to the device as uint8 and normalise there "
                 "(4x fewer host-to-device bytes than f32)")
    add_bool_arg(parser, "device_cache", False,
                 "synthetic source only: stage the rendered scenes on the "
                 "device once and cycle them (no per-batch frame transfer)")
    add_bool_arg(parser, "warmup", True,
                 "build the bucket lattice before serving")
    add_bool_arg(parser, "prefetch", True,
                 "decode and letterbox on a background thread")
    add_bool_arg(parser, "assert_no_compiles", False,
                 "exit nonzero if a bucket that was not warmed ran after "
                 "warmup")
    return parser


def _models(opt, spec, dev, lead_frames):
    """The detector and keypoint net at ``opt.precision`` on ``dev``, and
    their frame dtype. int8 calibrates on ``lead_frames`` (N, H, W, 3) f32
    in [0, 1]."""
    from mit_driverless_cv_traininginfra_tpu_torch.models import (
        darknet,
        quantize,
        rektnet,
        stem_opt,
    )
    from mit_driverless_cv_traininginfra_tpu_torch.ops import entry

    params, state, _ = darknet.load_darknet_weights(
        spec, *_darknet_trees(spec), opt.yolo_weights)
    spec, folded = stem_opt.slice_preyolo(
        spec, darknet.fold_bn(params, state, spec))
    folded = _tree_to(folded, dev)
    rfolded = _tree_to(rektnet.fold_bn(*rektnet.load_torch_checkpoint(
        opt.rektnet_weights)), dev)
    if opt.precision == "int8":
        H, W = spec.net.height, spec.net.width
        amax = quantize.calibrate(spec, folded, torch.from_numpy(lead_frames))
        # RektNet calibration crops: random crops of the same frames (the
        # real crop distribution is not known before detection runs)
        rng = np.random.default_rng(0)
        crops = []
        for _ in range(32):
            f = lead_frames[rng.integers(len(lead_frames))]
            y = rng.integers(0, max(1, H - 80))
            x = rng.integers(0, max(1, W - 80))
            crops.append(f[y:y + 80, x:x + 80])
        rekt_q = quantize.quantize_rektnet_params(
            rfolded, quantize.calibrate_rektnet(rfolded, np.stack(crops)))
        entry_q = (entry.quantize_entry(folded, amax)
                   if entry.entry_block_applicable(spec) else None)
        yolo = quantize.Int8Darknet(
            spec, quantize.quantize_params(spec, folded, amax), entry_q)
        rekt = quantize.Int8RektNet(rekt_q)
    else:
        dtype = torch.bfloat16 if opt.precision == "bf16" else torch.float32
        yolo = darknet.Darknet(spec, folded).to(dtype=dtype)
        rekt = rektnet.RektNet(rfolded).to(dtype=dtype)
        if dev.type == "cuda":
            yolo.to(memory_format=torch.channels_last)
            rekt.to(memory_format=torch.channels_last)
    return spec, yolo.to(dev).eval(), rekt.to(dev).eval()


def _tree_to(tree, dev):
    if torch.is_tensor(tree):
        return tree.to(dev)
    return {k: _tree_to(v, dev) for k, v in tree.items()}


def _csv_rows(idx, geom, boxes, scores, mask, kpts):
    """CSV rows of one frame's detections in source pixels (host numpy,
    the JAX CLI's arithmetic). A detection whose crop was dropped carries
    the all-zero keypoint sentinel and gets empty keypoint fields."""
    pad_h, pad_w, ratio = geom
    bb = boxes / ratio - np.asarray([pad_w, pad_h, pad_w, pad_h], np.float32)
    rows = []
    for d in np.flatnonzero(mask):
        row = [idx, int(d)] + [f"{v:.2f}" for v in bb[d]]
        row += [f"{scores[d]:.4f}"]
        if kpts[d].any():
            kk = kpts[d] / ratio - np.asarray([pad_w, pad_h], np.float32)
            row += [f"{v:.2f}" for v in kk.ravel()]
        else:
            row += [""] * 14
        rows.append(",".join(str(v) for v in row) + "\n")
    return rows


def main(argv=None) -> int:
    opt = _parser().parse_args(argv)

    from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import (
        load_network_spec,
    )
    from mit_driverless_cv_traininginfra_tpu_torch.device import resolve_device
    from mit_driverless_cv_traininginfra_tpu_torch.infer.capacity import (
        AdaptiveCapacity,
    )
    from mit_driverless_cv_traininginfra_tpu_torch.infer.microbatch import (
        MicroBatcher,
        to_host,
    )
    from mit_driverless_cv_traininginfra_tpu_torch.infer.serving import (
        TwoStageServer,
    )
    from mit_driverless_cv_traininginfra_tpu_torch.ops.boxes import (
        calculate_padding,
    )

    dev = resolve_device(opt.device)
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = True
        if opt.precision == "f32":  # f32 means f32: no TF32 convolutions
            torch.backends.cudnn.allow_tf32 = False
    spec = load_network_spec(opt.model_cfg, vanilla_anchor=opt.vanilla_anchor)
    H, W = spec.net.height, spec.net.width

    def boxed(img):
        """One RGB uint8 frame → (model-sized frame, its letterbox geometry);
        uint8 with ``--feed_uint8`` (normalised on the device), else f32 in
        [0, 1]."""
        h, w = img.shape[:2]
        geom = calculate_padding(h, w, H, W)
        out = img if (h, w) == (H, W) else _letterbox_u8(img, H, W)
        if opt.feed_uint8:
            return out, geom
        return out.astype(np.float32) / 255.0, geom

    n_syn = 0
    if opt.source.startswith("synthetic:"):
        n_syn = int(opt.source.split(":", 1)[1])
        if H != W:
            raise SystemExit("the synthetic source needs a square model input")
        from mit_driverless_cv_traininginfra_tpu_torch.data.synthetic import (
            yolo_batch,
        )

        def _syn_frames():
            rng = np.random.default_rng(42)
            made, cache = 0, []
            while made < n_syn:
                k = min(64, n_syn - made)
                imgs, _ = yolo_batch(rng, k, size=H)
                for i in range(k):
                    frame = (imgs[i] * 255).astype(np.uint8)
                    if opt.syn_repeat > 1:
                        cache.append(frame)
                    yield made + i, frame
                made += k
            for r in range(1, opt.syn_repeat):
                for i, frame in enumerate(cache):
                    yield r * n_syn + i, frame

        frames_it = _syn_frames()
    else:
        frames_it = _iter_source(opt.source)

    # int8 calibrates on the leading frames, which are then served first
    lead: list = []
    cal = None
    if opt.precision == "int8":
        for idx, img in frames_it:
            fb, geom = boxed(img)
            lead.append((idx, fb, geom))
            if len(lead) >= opt.calib_frames:
                break
        if not lead:
            print("ERROR: empty source", file=sys.stderr)
            return 1
        cal = np.stack([f for _, f, _ in lead]).astype(np.float32)
        if opt.feed_uint8:
            cal /= 255.0    # calibration always sees [0, 1] f32 frames
    spec, yolo, rekt = _models(opt, spec, dev, cal)
    server = TwoStageServer(yolo, rekt, conf_thresh=opt.conf_thres,
                            nms_thresh=opt.nms_thres, max_det=opt.max_det,
                            policy=AdaptiveCapacity(),
                            observe_every=opt.observe_every)
    # what crosses host → device per batch: uint8, normalised on the device
    # in the bucket's graph, or frames in the detector's dtype
    wire_dtype = torch.uint8 if opt.feed_uint8 else yolo.frame_dtype

    B = opt.batch_size
    lat_buckets = sorted({int(b) for b in opt.latency_buckets.split(",") if b})
    if opt.warmup:
        caps = ([int(c) for c in opt.capacities.split(",") if c]
                if opt.capacities else None)
        secs = server.warmup(lat_buckets if opt.latency_mode else [B],
                             capacities=caps, frame_dtype=wire_dtype)
        print(f"warmup: {sorted(server.warmed)} in {secs:.1f}s",
              file=sys.stderr)

    csv_f = None
    if opt.output_csv:
        os.makedirs(os.path.dirname(opt.output_csv) or ".", exist_ok=True)
        csv_f = open(opt.output_csv, "w")
        csv_f.write("frame,det,x1,y1,x2,y2,conf,"
                    + ",".join(f"kp{i}_x,kp{i}_y" for i in range(7)) + "\n")

    def decoded():
        # the calibration frames first, then the rest of the stream
        yield from lead
        for idx, img in frames_it:
            fb, geom = boxed(img)
            yield idx, fb, geom

    def finish_run(summary) -> int:
        if csv_f is not None:
            csv_f.close()
            print(f"detections -> {opt.output_csv}", file=sys.stderr)
        summary.update(server.stats())
        print(json.dumps(summary, default=str))
        if opt.assert_no_compiles and opt.warmup and summary["compiles"]:
            print(f"ERROR: {summary['compiles']} bucket(s) run after warmup "
                  "that warmup did not build", file=sys.stderr)
            return 2
        return 0

    if opt.latency_mode:
        # frames one at a time through the MicroBatcher: co-arrivals of the
        # --cameras streams aggregate into the smallest warmed bucket, and
        # every request is fenced by its fetch
        n_frames = 0
        waves = max(1, opt.cameras)
        mb = MicroBatcher(server, bucket_sizes=lat_buckets,
                          max_wait_ms=opt.max_wait_ms)
        t0 = time.perf_counter()
        with mb:
            group: list = []

            def drain():
                nonlocal n_frames
                for idx, geom, fut in group:
                    r = fut.result()
                    if csv_f is not None:
                        csv_f.writelines(_csv_rows(
                            idx, geom, r["boxes"], r["scores"], r["mask"],
                            r["keypoints"]))
                    n_frames += 1
                group.clear()

            stream = (_prefetch(decoded(), depth=2 * waves) if opt.prefetch
                      else decoded())
            for idx, fb, geom in stream:
                group.append((idx, geom, mb.submit(fb)))
                if len(group) >= waves:
                    drain()   # wait for the wave: a 1-deep, fenced pipe
            drain()
        wall = time.perf_counter() - t0
        mstats = mb.stats()
        return finish_run({
            "mode": "latency", "frames": n_frames, "wall_s": wall,
            "fps": n_frames / wall if wall else None,
            "precision": opt.precision, "cameras": waves,
            "latency_buckets": lat_buckets,
            # submit → results on the host: co-arrival wait, device, fetch
            "request_frame_ms": mstats["request_ms"], "microbatch": mstats})

    n_frames = 0
    pend_i, pend_f, pend_g = [], [], []
    # dispatched batches whose results are not on the host yet: --inflight
    # of them let the device run batch N while the host fetches N-depth
    inflight: deque = deque()
    depth = max(0, opt.inflight)
    batch_lat_ms: list = []   # dispatch → results on the host, per batch

    def finish(idxs, geoms, out, n, t_disp):
        nonlocal n_frames
        boxes, scores, mask, kpts = to_host(out)   # the fence
        if csv_f is not None:
            for r in range(n):
                csv_f.writelines(_csv_rows(idxs[r], geoms[r], boxes[r],
                                           scores[r], mask[r], kpts[r]))
        batch_lat_ms.append((time.perf_counter() - t_disp) * 1000.0)
        n_frames += n

    def dispatch(idxs, geoms, frames):
        t_disp = time.perf_counter()
        inflight.append((idxs, geoms, server(frames), len(idxs), t_disp))
        while len(inflight) > depth:
            finish(*inflight.popleft())

    def take_pending():
        batch = torch.from_numpy(np.stack(pend_f)).to(wire_dtype)
        out = (list(pend_i), list(pend_g), batch)
        pend_i.clear(), pend_f.clear(), pend_g.clear()
        return out

    if opt.device_cache:
        # stage the scenes on the device once (untimed, like warmup), then
        # cycle them --syn_repeat times: the device's rate through the
        # whole server with no per-batch frame transfer
        if not n_syn:
            raise SystemExit("--device_cache needs a synthetic source")
        staged = []
        for idx, fb, geom in decoded():
            pend_i.append(idx), pend_f.append(fb), pend_g.append(geom)
            if len(pend_i) == B:
                idxs, geoms, batch = take_pending()
                staged.append((idxs, geoms, batch.to(dev)))
                if len(staged) == max(1, n_syn // B):
                    break
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(opt.syn_repeat):
            for idxs, geoms, batch in staged:
                dispatch(idxs, geoms, batch)
    else:
        t0 = time.perf_counter()
        stream = (_prefetch(decoded(), depth=2 * B) if opt.prefetch
                  else decoded())
        for idx, fb, geom in stream:
            pend_i.append(idx), pend_f.append(fb), pend_g.append(geom)
            if len(pend_i) == B:
                dispatch(*take_pending())
        if pend_i:
            dispatch(*take_pending())
    while inflight:
        finish(*inflight.popleft())
    wall = time.perf_counter() - t0
    lat = np.asarray(batch_lat_ms, np.float64)
    return finish_run({
        "frames": n_frames, "wall_s": wall,
        "fps": n_frames / wall if wall else None,
        "precision": opt.precision, "batch_size": B,
        # dispatch → every output on the host, per batch
        "e2e_batch_ms": ({p: float(np.percentile(lat, p))
                          for p in (50, 95, 99)} if lat.size else None)})


if __name__ == "__main__":
    sys.exit(main())
