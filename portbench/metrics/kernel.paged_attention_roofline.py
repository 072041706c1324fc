"""The paged-attention kernels (``kernels/paged_attention.py``,
``csrc/paged_attention.cu``) against their roofline: the frozen bound of
each traced decode step's active rows at their lengths, once a layer,
over the device time of the split and combine kernels.  Rows a step
computes for no request (free slots) are work the bound does not count."""

from portbench.roofline import bounds, kernels


def read(ctx):
    tr, d = ctx["trace"], ctx["traced"]
    steps = ctx.get("decode_valid") or []
    if tr is None or not d or not d.get("launch.paged_attention") \
            or not steps:
        return None
    m, t = ctx["config"]["model"], ctx["traffic"]
    per_layer = sum(bounds.paged_bound_ms(v, m["n_heads"], m["n_kv_heads"],
                                          m["head_dim"],
                                          t["scheduler"]["page_size"])
                    for v in steps if v)
    calls_per_step = d["launch.paged_attention"] / len(steps)
    return 100.0 * per_layer * calls_per_step * 1e-3 / kernels.device_time(
        tr, "paged_attention")
