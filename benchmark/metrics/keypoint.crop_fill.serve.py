"""RektNet's useful work over its attempts, in %: crops whose keypoints
were kept over the capacity slots run (the capacity of each request of the
window, summed)."""


def read(rec):
    if rec.get("kind") != "closed_loop" or not rec.get("cap_slots"):
        return None
    return 100.0 * rec["kept_crops"] / rec["cap_slots"]
