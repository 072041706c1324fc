"""The whole serving step's share of the chip's bf16 peak: 2·N_active
model operations a token through the model (prompt tokens prefilled,
plus generated tokens that a decode step made: a request's first token
comes from its prefill) in the traced span, over its length."""

from portbench.core import weights
from portbench.roofline.peaks import BF16_OPS_PER_S


def read(ctx):
    d = ctx["traced"]
    if ctx["trace"] is None or d is None:
        return None
    tokens = d["prefill_tokens"] + d["generated_tokens"] - d["admitted"]
    if tokens <= 0:
        return None
    n = weights.count(ctx["config"], active=True)
    return 100.0 * 2 * n * tokens / (ctx["trace"].window_s * BF16_OPS_PER_S)
