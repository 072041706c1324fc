"""Bytes the captured segments copy in and out around each replay
(``core/capture.py``: ``copy_in_bytes`` + ``copy_out_bytes`` over
``replays``) in the traced span of the serving window, in GB (1e9 bytes)."""


def read(ctx):
    d = ctx["traced"]
    if not d or not d.get("capture.replays"):
        return None
    return (d["capture.copy_in_bytes"] + d["capture.copy_out_bytes"]) \
        / d["capture.replays"] / 1e9
