"""Host time of the co-execution engine a training step: the Python
thread's dispatch time plus its stalls at fetch points, over the
window's iterations (``core/engine.py``, ``core/executor/``)."""


def read(ctx):
    d = ctx["delta"]
    if not d.get("iterations"):
        return None
    return 1e3 * (d["dispatch_time"] + d["py_stall_time"]) / d["iterations"]
