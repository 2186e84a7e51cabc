"""Device milliseconds a crop of the program's keypoint net alone: CUDA
events around its calls on the served capacity's crops, after the window."""


def read(rec):
    return rec.get("keypoint_ms_per_crop")
