"""Host milliseconds a ``TwoStageServer.__call__`` takes to enqueue a
request: the benchmark's span around each call in the window, averaged."""


def read(rec):
    if rec.get("kind") != "closed_loop":
        return None
    return rec.get("server_call_ms")
