"""The device's idle share of the traced window, in %: one minus the union
of the device activities' intervals over the window (torch.profiler)."""


def read(rec):
    t = rec.get("trace")
    if rec.get("kind") != "camera_streams" or not t or not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
