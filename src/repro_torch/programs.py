"""The ten imperative DL programs of the paper's evaluation (§5.1) on the
port's op layer, with the same failure-inducing Python features as the
reference's ``benchmarks/programs.py``:

    DropBlock        — Python object mutation (drop prob schedule)
    MusicTransformer — Python object mutation (cached numpy rel-pos mask)
    SDPoint          — stochastic downsample point chosen by Python RNG
    BERT-CLS         — third-party (numpy) call on a materialized tensor
    FasterRCNN       — tensor materialization steering Python control flow
    BERT-Q&A, GPT2, DCGAN, ResNet, YOLOv3 — convertible programs

Each program exposes:
    make_step(variant, device=None) -> (step_fn, batch_fn)
      variant in {"terra", "imperative"}
Both variants run the same step through the instrumented op layer
(Variables and GradientTape): "terra" is driven through
``repro_torch.core.function``, "imperative" inside
``repro_torch.core.imperative()``.  Weights come from the reference's
``np.random.RandomState`` seeds, so both packages start from identical
values, and are made on ``device`` (default: the CUDA card; without one
the call raises unless ``device="cpu"``).  The whole-step compiled variant
("fulljit") raises ``NotImplementedError``: it is a later item of
``ROADMAP.md``.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.core import GradientTape, Variable, ops
from repro_torch.core.device import resolve_device

REGISTRY: Dict[str, Callable] = {}


def program(name):
    def deco(f):
        def make_step(variant, device=None, **sizes):
            if variant == "fulljit":
                raise NotImplementedError(
                    "the fulljit variant (the whole step compiled as one "
                    "graph) is not ported yet; see ROADMAP.md")
            if variant not in ("terra", "imperative"):
                raise ValueError(f"unknown variant {variant!r}")
            return f(resolve_device(device), **sizes)
        make_step.__name__ = f.__name__
        REGISTRY[name] = make_step
        return make_step
    return deco


def _var(a, name, dev):
    return Variable(torch.from_numpy(np.asarray(a, np.float32)).to(dev), name)


def _sgd(tape, loss, variables, lr=0.05):
    grads = tape.gradient(loss, variables)
    for v, g in zip(variables, grads):
        v.assign_sub(ops.mul(g, lr))


def _mlp_vars(rng, sizes, prefix, dev):
    vs = []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        vs.append(_var(rng.randn(a, b) * (2.0 / a) ** 0.5,
                       f"{prefix}_w{i}", dev))
    return vs


# ==========================================================================
# 1. DropBlock — object mutation of the drop probability schedule
# ==========================================================================

@program("dropblock")
def dropblock(dev, d=64, batch=16):
    rng = np.random.RandomState(0)

    class DropBlock:                       # the mutated Python object
        drop_prob = 0.0

    db = DropBlock()
    ws = _mlp_vars(rng, [d, d, d, 10], "db", dev)

    def batch_fn(i):
        r = np.random.RandomState(i)
        return (r.randn(batch, d).astype(np.float32),
                r.randint(0, 10, batch).astype(np.int32))

    def step(i):
        db.drop_prob = 0.1 if i >= 5 else 0.0         # object mutation
        x, y = batch_fn(i)
        with GradientTape() as tape:
            h = x
            for w in ws[:-1]:
                h = ops.relu(ops.matmul(h, w.read()))
                h = ops.dropout(h, db.drop_prob)
            logits = ops.matmul(h, ws[-1].read())
            loss = ops.softmax_xent(logits, y)
        _sgd(tape, loss, ws)
        return loss
    return step, batch_fn


# ==========================================================================
# 2. MusicTransformer — mutation: numpy-cached relative mask object
# ==========================================================================

@program("musictransformer")
def musictransformer(dev, d=64, seq=32, batch=8, heads=4):
    rng = np.random.RandomState(1)
    wq, wk, wv, wo = _mlp_vars(rng, [d, d, d, d, d], "mt", dev)[:4]
    w_out = _var(rng.randn(d, 32) * 0.1, "mt_out", dev)

    class RelMask:                         # python-side cached mask object
        window = seq

        def get(self):
            m = np.tril(np.ones((seq, seq), np.float32))
            m *= (np.abs(np.subtract.outer(np.arange(seq),
                                           np.arange(seq)))
                  < self.window).astype(np.float32)
            return m

    rel = RelMask()

    def batch_fn(i):
        r = np.random.RandomState(100 + i)
        return (r.randn(batch, seq, d).astype(np.float32),
                r.randint(0, 32, (batch, seq)).astype(np.int32))

    def model(x, mask, read):
        q = ops.matmul(x, read(wq))
        k = ops.matmul(x, read(wk))
        v = ops.matmul(x, read(wv))
        s = ops.einsum(q, k, expr="bsd,btd->bst")
        s = ops.add(ops.mul(s, 1.0 / d ** 0.5),
                    ops.mul(ops.sub(mask, 1.0), 1e9))
        a = ops.softmax(s, axis=-1)
        h = ops.einsum(a, v, expr="bst,btd->bsd")
        h = ops.matmul(h, read(wo))
        return ops.matmul(h, read(w_out))

    def step(i):
        rel.window = 8 if i >= 5 else seq          # mutation
        x, y = batch_fn(i)
        with GradientTape() as tape:
            logits = model(x, rel.get(), lambda v: v.read())
            loss = ops.softmax_xent(
                ops.reshape(logits, new_shape=(batch * seq, 32)),
                y.reshape(batch * seq))
        _sgd(tape, loss, [wq, wk, wv, wo, w_out])
        return loss
    return step, batch_fn


# ==========================================================================
# 3. SDPoint — stochastic downsampling point picked by the Python RNG
# ==========================================================================

@program("sdpoint")
def sdpoint(dev, d=64, batch=16):
    rng = np.random.RandomState(2)
    ws = _mlp_vars(rng, [d, d, d, d, 10], "sd", dev)
    pyrng = np.random.RandomState(42)

    def batch_fn(i):
        r = np.random.RandomState(200 + i)
        return (r.randn(batch, d).astype(np.float32),
                r.randint(0, 10, batch).astype(np.int32))

    def fwd(x, point, read):
        h = x
        for j, w in enumerate(ws[:-1]):
            h = ops.relu(ops.matmul(h, read(w)))
            if j == point:                       # python-chosen downsample
                h = ops.mul(h, 0.5)
        return ops.matmul(h, read(ws[-1]))

    def step(i):
        point = pyrng.randint(0, 3)              # dynamic python control
        x, y = batch_fn(i)
        with GradientTape() as tape:
            logits = fwd(x, point, lambda v: v.read())
            loss = ops.softmax_xent(logits, y)
        _sgd(tape, loss, ws)
        return loss
    return step, batch_fn


# ==========================================================================
# 4. BERT-CLS — third-party numpy call inside the step
# ==========================================================================

@program("bert_cls")
def bert_cls(dev, d=64, batch=16):
    rng = np.random.RandomState(3)
    ws = _mlp_vars(rng, [d, d, d, 4], "bc", dev)

    def batch_fn(i):
        r = np.random.RandomState(300 + i)
        return (r.randn(batch, d).astype(np.float32),
                r.randint(0, 4, batch).astype(np.int32))

    def step(i):
        x, y = batch_fn(i)
        with GradientTape() as tape:
            h = ops.relu(ops.matmul(ops.relu(ops.matmul(x, ws[0].read())),
                                    ws[1].read()))
            logits = ops.matmul(h, ws[2].read())
            # third-party library use on materialized values (Fig. 1a)
            preds = np.argmax(logits.numpy(), axis=-1)
            acc = float((preds == y).mean())          # noqa: F841
            loss = ops.softmax_xent(logits, y)
        _sgd(tape, loss, ws)
        return loss
    return step, batch_fn


# ==========================================================================
# 5. FasterRCNN — tensor materialization steering Python control flow
# ==========================================================================

@program("fasterrcnn")
def fasterrcnn(dev, d=64, batch=8, n_anchors=32):
    rng = np.random.RandomState(4)
    w_rpn = _mlp_vars(rng, [d, d, 1], "rpn", dev)
    w_head = _mlp_vars(rng, [d, d, 5], "head", dev)

    def batch_fn(i):
        r = np.random.RandomState(400 + i)
        return (r.randn(batch, n_anchors, d).astype(np.float32),
                r.randint(0, 5, batch).astype(np.int32))

    def step(i):
        x, y = batch_fn(i)
        with GradientTape() as tape:
            s = ops.matmul(ops.relu(ops.matmul(x, w_rpn[0].read())),
                           w_rpn[1].read())
            # materialize the proposal count and feed it back; counts are
            # bucketed to powers of two as real detectors do, so the
            # TraceGraph converges to 4 branches
            n_pos = int((ops.sigmoid(s).numpy() > 0.5).sum())
            k = 4
            while k < min(max(n_pos // batch, 4), n_anchors):
                k *= 2
            top = ops.getitem(x, idx=(slice(None), slice(0, k)))
            h = ops.relu(ops.matmul(top, w_head[0].read()))
            logits = ops.reduce_mean(ops.matmul(h, w_head[1].read()), axis=1)
            loss = ops.softmax_xent(logits, y)
        _sgd(tape, loss, w_rpn + w_head)
        return loss
    return step, batch_fn


# ==========================================================================
# 6-10. convertible programs
# ==========================================================================

def _simple_classifier(name, sizes, n_cls, seed):
    @program(name)
    def prog(dev, batch=16):
        rng = np.random.RandomState(seed)
        ws = _mlp_vars(rng, sizes + [n_cls], name, dev)

        def batch_fn(i):
            r = np.random.RandomState(seed * 100 + i)
            return (r.randn(batch, sizes[0]).astype(np.float32),
                    r.randint(0, n_cls, batch).astype(np.int32))

        def step(i):
            x, y = batch_fn(i)
            with GradientTape() as tape:
                h = x
                for w in ws[:-1]:
                    h = ops.relu(ops.matmul(h, w.read()))
                loss = ops.softmax_xent(ops.matmul(h, ws[-1].read()), y)
            _sgd(tape, loss, ws)
            return loss
        return step, batch_fn
    return prog


_simple_classifier("bert_qa", [96, 96, 96], 8, 5)
_simple_classifier("resnet", [128, 128, 128, 128], 10, 6)
_simple_classifier("yolov3", [128, 192, 128], 16, 7)


@program("gpt2")
def gpt2(dev, d=64, seq=32, batch=8):
    rng = np.random.RandomState(8)
    wq, wk, wv, wo = _mlp_vars(rng, [d, d, d, d, d], "g2", dev)[:4]
    w_out = _var(rng.randn(d, 64) * 0.1, "g2o", dev)
    mask = np.tril(np.ones((seq, seq), np.float32))

    def batch_fn(i):
        r = np.random.RandomState(800 + i)
        return (r.randn(batch, seq, d).astype(np.float32),
                r.randint(0, 64, (batch, seq)).astype(np.int32))

    def step(i):
        x, y = batch_fn(i)
        with GradientTape() as tape:
            q = ops.matmul(x, wq.read())
            k = ops.matmul(x, wk.read())
            v = ops.matmul(x, wv.read())
            s = ops.einsum(q, k, expr="bsd,btd->bst")
            s = ops.add(ops.mul(s, 1.0 / d ** 0.5),
                        ops.mul(ops.sub(mask, 1.0), 1e9))
            h = ops.einsum(ops.softmax(s, axis=-1), v, expr="bst,btd->bsd")
            logits = ops.matmul(ops.matmul(h, wo.read()), w_out.read())
            loss = ops.softmax_xent(
                ops.reshape(logits, new_shape=(batch * seq, 64)),
                y.reshape(batch * seq))
        _sgd(tape, loss, [wq, wk, wv, wo, w_out])
        return loss
    return step, batch_fn


@program("dcgan")
def dcgan(dev, dz=32, d=64, batch=16):
    rng = np.random.RandomState(9)
    gw = _mlp_vars(rng, [dz, d, d], "gen", dev)
    dw = _mlp_vars(rng, [d, d, 1], "dis", dev)

    def batch_fn(i):
        r = np.random.RandomState(900 + i)
        return (r.randn(batch, d).astype(np.float32),
                r.randn(batch, dz).astype(np.float32))

    def step(i):
        real, z = batch_fn(i)
        with GradientTape() as tape:
            fake = ops.matmul(ops.relu(ops.matmul(z, gw[0].read())),
                              gw[1].read())
            dr = ops.matmul(ops.relu(ops.matmul(real, dw[0].read())),
                            dw[1].read())
            df = ops.matmul(ops.relu(ops.matmul(fake, dw[0].read())),
                            dw[1].read())
            d_l = ops.add(ops.reduce_mean(ops.log(ops.add(ops.exp(ops.neg(dr)), 1.0))),
                          ops.reduce_mean(ops.log(ops.add(ops.exp(df), 1.0))))
        _sgd(tape, d_l, dw)
        with GradientTape() as tape2:
            fake = ops.matmul(ops.relu(ops.matmul(z, gw[0].read())),
                              gw[1].read())
            df = ops.matmul(ops.relu(ops.matmul(fake, dw[0].read())),
                            dw[1].read())
            g_l = ops.reduce_mean(ops.log(ops.add(ops.exp(ops.neg(df)), 1.0)))
        _sgd(tape2, g_l, gw)
        return ops.add(d_l, g_l)
    return step, batch_fn


NON_CONVERTIBLE = {
    "dropblock": "Python object mutation",
    "musictransformer": "Python object mutation",
    "sdpoint": "Python object mutation",
    "bert_cls": "third-party library call",
    "fasterrcnn": "tensor materialization during conversion",
}
