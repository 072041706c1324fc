"""The model configuration as the port takes it, and the weights the
benchmark makes for both sides from the seed.

The weights are made on the device with one ``torch.Generator`` there, in
one call a leaf of the port's stacked layout (a few dozen calls for a
whole model), directly in the type they are served in.  The rule is the
benchmark's own, after the published models' initializers (``_fill``);
nothing of the port's initializer is used, so the reference can take the
same tensors as its inputs."""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import torch


def model_config(config: dict):
    """The port's ``ModelConfig`` from the configuration file's keys that
    name its fields (lists become tuples)."""
    from repro_torch.configs.base import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in config["model"].items() if k in names}
    cfg = ModelConfig(**kw)
    cfg.validate()
    return cfg


def leaf_paths(tree, prefix: str = "") -> List[Tuple[str, object]]:
    """(dotted path, leaf) in the port's flattening order: dict keys
    sorted, lists in order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaf_paths(tree[k], f"{prefix}{k}.")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, t in enumerate(tree):
            out += leaf_paths(t, f"{prefix}{i}.")
        return out
    if tree is None:
        return []
    return [(prefix[:-1], tree)]


# out projections onto the residual stream: scaled down by the depth's
# square root, as Mamba's and GPT-2's initializers do
OUT_PROJ = ("w_out", "wo", "w_down")
ZEROS = ("scale", "bias", "bq", "bk", "bv", "b_a", "b_x", "gate")


def _fill(t, path: str, n_layers: int, gen) -> None:
    """Draw leaf ``path`` in place: Mamba-2's rule for the SSD's step
    sizes (dt log-uniform in [1e-3, 1e-1], through softplus's inverse)
    and decay rates (A uniform in [1, 16]); zeros for norm offsets and
    biases; otherwise a normal draw, 1/sqrt(fan-in) for a matrix (out
    projections also 1/sqrt(depth)), d^-1/2 for the embeddings, 0.1 for
    the conv taps."""
    last = path.rsplit(".", 1)[-1]
    shape = t.shape
    if last == "a_log":
        t.uniform_(1.0, 16.0, generator=gen).log_()
    elif last == "dt_bias":
        u = torch.empty(shape, dtype=torch.float32, device=t.device)
        u.uniform_(math.log(1e-3), math.log(1e-1), generator=gen).exp_()
        t.copy_(u + torch.log(-torch.expm1(-u)))
    elif last in ZEROS:
        t.zero_()
    elif last in ("embed", "lm_head", "enc_pos"):
        t.normal_(0.0, shape[-1] ** -0.5, generator=gen)
    elif last == "w_conv":
        t.normal_(0.0, 0.1, generator=gen)
    else:
        s = shape[-2] ** -0.5
        if last in OUT_PROJ:
            s /= math.sqrt(n_layers)
        t.normal_(0.0, s, generator=gen)


def make_params(cfg, seed: int, device):
    """The model's weights from ``seed``, in the port's tree, on
    ``device``.  Returns (tree, [(path, tensor)])."""
    from repro_torch.core.pytree import tree_flatten, tree_unflatten
    from repro_torch.models import model as M
    shapes = M.abstract_params(cfg)
    _, treedef = tree_flatten(shapes)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    leaves = []
    for path, meta in leaf_paths(shapes):
        t = torch.empty(meta.shape, dtype=meta.dtype, device=device)
        _fill(t, path, cfg.n_layers, gen)
        leaves.append((path, t))
    return tree_unflatten(treedef, [t for _, t in leaves]), leaves


def count(config: dict, active: bool) -> int:
    """Parameters of the configuration from its sizes alone (the
    yardstick's own count): every parameter, or those a token uses
    (attention, the routed experts it goes to and the shared ones, the
    router and the output head)."""
    m = config["model"]
    d, V, L = m["d_model"], m["vocab"], m["n_layers"]
    kinds = m.get("block_pattern", ["attn"])
    if kinds != ["moe"] and kinds != ["ssd"]:
        raise NotImplementedError(f"no count for blocks {kinds}")
    if kinds == ["ssd"]:
        H, P, N, K = (m["ssm_heads"], m["ssm_head_dim"], m["ssm_state"],
                      m["conv_kernel"])
        di = H * P
        per = (d * (2 * di + 2 * N + H) + (di + 2 * N) * K + 2 * H
               + di * d + d)
        head = 0 if m.get("tie_embeddings") else V * d
        return V * d + L * per + d + head
    H, Hkv, D = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    attn = d * H * D + 2 * d * Hkv * D + H * D * d
    E, k, f, sh = (m["n_experts"], m["top_k"], m["moe_d_ff"],
                   m["n_shared_experts"])
    expert = 3 * d * f
    router = d * E
    head = V * d
    if active:
        return L * (attn + (k + sh) * expert + router) + head
    return V * d + L * (attn + (E + sh) * expert + router + 2 * d) + d + head
