"""The precision a plain reference computes in.

``f32`` is the references' own: float32 everywhere, TF32 off.  ``fp8`` is
the correctness control for a bfloat16 configuration, the nearest
precision below it: every operand of every product is rounded to
float8 e4m3 with a per-tensor scale (its largest magnitude onto 448) and
the product is then taken in float32.  In autograd the rounding passes
the gradient straight through, so a training step's gradients are those
of the rounded forward."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def strict_f32() -> None:
    """No TF32 anywhere: a float32 product is a float32 product."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(t: torch.Tensor) -> torch.Tensor:
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    s = E4M3_MAX / amax
    return (t.float() * s).to(torch.float8_e4m3fn).float() / s


class Prec:
    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """An operand of a product, at this precision (float32 out)."""
        t = t.float()
        if self.name == "f32":
            return t
        r = _fp8(t)
        if t.requires_grad:
            return t + (r - t).detach()
        return r

    def mm(self, a, b):
        return torch.matmul(self.q(a), self.q(b))
