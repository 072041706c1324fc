"""The whole training step's share of the chip's bf16 peak: 6·N model
operations a token (N every parameter, counted from the configuration's
sizes) over the traced window."""

from portbench.core import weights
from portbench.roofline.peaks import BF16_OPS_PER_S


def read(ctx):
    if ctx["trace"] is None or not ctx["tokens"]:
        return None
    n = weights.count(ctx["config"], active=False)
    return 100.0 * 6 * n * ctx["tokens"] / (ctx["trace"].window_s
                                            * BF16_OPS_PER_S)
