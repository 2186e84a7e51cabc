"""K1 (ROI crop), K2 (soft-argmax) and K3 (threshold, top-k, NMS) against
their roofline, in %: the sum of their bound times at the served shapes
(each input byte read once, each output written once, over 3.35 TB/s;
operations over the peak) over the sum of their device times in the traced
window. A call's bound takes the mean capacity of the traced requests."""

from yardstick import arch

KERNELS = ("roi_crop_kernel", "softargmax_kernel", "nms_topk_kernel")


def read(rec):
    t = rec.get("trace")
    if rec.get("kind") != "closed_loop" or not t or not t.get("caps"):
        return None
    sh = rec["shape"]
    cap = sum(t["caps"]) / len(t["caps"])
    bound = {"roi_crop_kernel": arch.roi_crop_bound_s(sh["B"], sh["H"], sh["H"], sh["C"],
                                                      cap, sh["crop"]),
             "softargmax_kernel": arch.softargmax_bound_s(cap * sh["num_kpt"], sh["crop"] ** 2),
             "nms_topk_kernel": arch.nms_topk_bound_s(sh["B"], sh["N"], sh["max_det"])}
    b = s = 0.0
    for name, (count, sec) in t["kernels"].items():
        for k in KERNELS:
            if k in name:
                b += count * bound[k]
                s += sec
    return 100.0 * b / s if s > 0 and b > 0 else None
