"""Bytes a captured replay copies into the pool's leaves rather than
writing them in place (``core/capture.py``: ``pool_copy_bytes`` over
``replays``; the recurrent states' write-back of the steady decode step)
in the traced span of the serving window, in GB (1e9 bytes).  A program
without the counter reports nothing."""


def read(ctx):
    d = ctx["traced"]
    if not d or not d.get("capture.replays") \
            or "capture.pool_copy_bytes" not in d:
        return None
    return d["capture.pool_copy_bytes"] / d["capture.replays"] / 1e9
