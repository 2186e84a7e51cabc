"""The served model's share of the card's peak, in %: counted FLOPs of the
frames served in the window (65.3 GFLOP a frame of YOLOv3-416 with its
heads sliced to the cone class, 3.96 GFLOP a kept RektNet crop) over the
window times the peak of the configuration's precision (989 TFLOP/s bf16,
1,979 TOP/s int8; NVIDIA H100 SXM, dense, 700 W)."""

from yardstick import arch


def read(rec):
    if rec.get("kind") != "closed_loop" or not rec.get("window_s"):
        return None
    peak = arch.PEAK[rec["cfg"]["precision"]]
    return 100.0 * rec["flops"] / (rec["window_s"] * peak)
