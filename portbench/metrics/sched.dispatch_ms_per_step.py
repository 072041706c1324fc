"""Host time the scheduler loop spends dispatching a step
(``serve/scheduler/scheduler.py``: ``step_dispatch_time`` over decode and
prefill steps) in the traced span of the serving window."""


def read(ctx):
    d = ctx["traced"]
    if not d:
        return None
    steps = d["decode_steps"] + d["prefill_steps"]
    if not steps:
        return None
    return 1e3 * d["step_dispatch_time"] / steps
