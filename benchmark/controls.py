#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card, in one
process: for each seed, the program's answers in a short window at the
cell's own load (its runner's ``control_sample``), judged against the
reference (the sound readings), and on the control seeds the control's
answers to the same requests (the reference in the next precision below
the configuration's, in the program's place), judged alike.

    python3 benchmark/controls.py --workload NAME --seeds 1,2,... \
        --control-seeds 1,2,3 [--seconds 2] [--out FILE]

Each seed prints one JSON line ``{"seed", "side", "numbers"}``.
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from yardstick import harness, judge, reference, serve  # noqa: E402


def control_answers(st, pipe, requests):
    """The control pipeline's answers to ``requests`` ``[(scenes, cap)]``,
    frame by frame, in the served answers' form."""
    out = []
    pool = torch.from_numpy(st.pool).to(st.device)
    for scenes, cap in requests:
        o = pipe(pool[list(scenes)], cap)
        o = [t.cpu().numpy() for t in o]
        for i, s in enumerate(scenes):
            out.append({"scene": s, "boxes": o[0][i], "scores": o[1][i], "mask": o[2][i],
                        "keypoints": o[3][i]})
    return out


def readings(cfg, traffic, seed, seconds, device, with_control: bool):
    st = serve.Setup(cfg, traffic, seed, device)
    answers, reqs = harness.runner(traffic["runner"]).control_sample(st, seconds)
    st.free_program()
    t = time.perf_counter()
    pipe = st.reference(cfg["reference"]["numerics"])
    scenes_u8 = torch.from_numpy(st.pool).to(device)
    ref = judge.reference_dets(pipe, scenes_u8)
    out = [{"seed": seed, "side": "program",
            "numbers": judge.judge(answers, ref, pipe, scenes_u8, device),
            "reference_s": time.perf_counter() - t}]
    if with_control:
        ctrl = st.reference(cfg["reference"]["control"])
        out.append({"seed": seed, "side": "control", "numerics": cfg["reference"]["control"],
                    "numbers": judge.judge(control_answers(st, ctrl, reqs), ref, pipe,
                                           scenes_u8, device)})
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default="")
    args = p.parse_args()
    bench = harness.load_bench(ROOT)
    cell = harness.find_cell(bench, args.workload)
    cfg = harness.load_config(bench, ROOT, cell["config"])
    traffic = harness.load_traffic(cell["traffic"])
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    reference.full_f32()
    device = torch.device("cuda:0")
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",") if s]
    seeds += [s for s in sorted(ctrl) if s not in seeds]
    out = open(args.out, "a") if args.out else None
    for seed in seeds:
        for line in readings(cfg, traffic, seed, args.seconds, device, seed in ctrl):
            text = json.dumps(line)
            print(text, flush=True)
            if out:
                out.write(text + "\n")
                out.flush()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
