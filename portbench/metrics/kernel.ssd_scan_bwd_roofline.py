"""The SSD scan's gradient kernels (``kernels/ssd_scan.py``,
``csrc/ssd_scan.cu``) against their roofline: the frozen bound of one
call at the training shape times the calls in the traced window, over the
device time of every kernel of those calls."""

from portbench.roofline import bounds, kernels


def read(ctx):
    tr, d = ctx["trace"], ctx["traced"]
    calls = d.get("launch.ssd_scan_bwd", 0) if d else 0
    if tr is None or not calls:
        return None
    m, t = ctx["config"]["model"], ctx["traffic"]
    bound_ms = bounds.ssd_bwd_bound_ms(t["batch"], t["seq_len"],
                                       m["ssm_heads"], m["ssm_head_dim"],
                                       m["ssm_state"])
    return 100.0 * calls * bound_ms * 1e-3 / kernels.device_time(
        tr, "ssd_scan_bwd")
