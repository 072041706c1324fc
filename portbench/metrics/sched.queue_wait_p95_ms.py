"""95th percentile of the time a request waited from its arrival to its
admission (``serve/scheduler/lifecycle.py``, the queueing delay each
``RequestAdmit`` event carries), over every admission in the traced span."""

from portbench.core.stats import percentile


def read(ctx):
    waits = ctx.get("admit_waits") or []
    if not waits:
        return None
    return 1e3 * percentile(waits, 95)
