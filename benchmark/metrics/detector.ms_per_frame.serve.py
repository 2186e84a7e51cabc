"""Device milliseconds a frame of the program's detector alone: CUDA
events around the benchmark's own calls of it, at the cell's batch and
dtype, after the window."""


def read(rec):
    return rec.get("detector_ms_per_frame")
