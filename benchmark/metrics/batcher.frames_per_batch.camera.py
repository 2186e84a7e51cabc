"""Real frames per batch the ``MicroBatcher`` ran over the window:
``frames / batches`` of its counters (pad frames not counted)."""


def read(rec):
    if rec.get("kind") != "camera_streams" or not rec.get("batches"):
        return None
    return rec["batched_frames"] / rec["batches"]
