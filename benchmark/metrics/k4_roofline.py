"""K4 (the int8 fused entry, blocks 1-4 of YOLOv3) against its roofline,
in %: its bound at the served shape (hq read, resq written, over 3.35
TB/s; its int8 operations over 1,979 TOP/s) over its device time in the
traced window."""

from yardstick import arch


def read(rec):
    t = rec.get("trace")
    if rec.get("kind") != "closed_loop" or not t:
        return None
    sh = rec["shape"]
    count = s = 0
    for name, (c, sec) in t["kernels"].items():
        if "entry_block_kernel" in name:
            count += c
            s += sec
    if not count or s <= 0:
        return None
    return 100.0 * count * arch.entry_block_bound_s(sh["B"], sh["H"] // 2) / s
