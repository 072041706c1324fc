"""Batched serving engine: request queue -> batched prefill -> decode loop.

The counterpart of the reference's ``serve/engine.py``.  A deliberately
small but real serving loop: requests arrive with prompts; the engine
forms a batch, prefills once, then decodes all sequences in lock-step,
retiring finished sequences at EOS / max-tokens.  The decode loop is an
imperative Python program (per-request bookkeeping, early exits,
third-party detokenizers all live here), so it runs under Terra
co-execution by default (``use_terra=True``): the decode step is a single
DL op, params and KV cache live in the engine's device-resident variable
store, and only the sampled token is fetched per step (see
serve/terra_decode.py).  ``use_terra=False`` keeps the captured
donate-the-cache baseline (serve/serve_step.py).  ``device`` (default:
the CUDA card) holds the params, the cache and every step.

Side inputs: the VLM's vision states (``cross_states``) feed prefill and
every decode step, as in the reference.  Whisper's frame embeddings
(``frontend_embeds``) are encoded once per batch, and the encoder states
feed prefill and every decode step as ``cross_states``: the model-level
path (``tests/test_smoke_archs.py:75-80``).  The reference's
``run_batch`` drops them after prefill, so its decode attends over the
new token in place of the audio (``src/repro/serve/engine.py:123-124``;
ROADMAP.md Queue 3 keeps the difference on purpose).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.events import EventStream
from repro_torch.core.executor.families import bucket_pow2
from repro_torch.core.pytree import tree_flatten, tree_unflatten
from repro_torch.core.trace import as_tensor, to_numpy
from repro_torch.serve.serve_step import jit_encode_step, jit_serve_steps
from repro_torch.serve.terra_decode import TerraDecoder


@dataclasses.dataclass(eq=False)    # identity semantics: prompt is an array
class Request:
    prompt: np.ndarray              # [S] int32
    max_new_tokens: int = 32
    eos_id: int = -1                # -1: never
    out_tokens: Optional[list] = None
    done: bool = False
    # latency accounting: all three on the same time.perf_counter() clock;
    # arrival defaults to construction time
    arrival_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    # per-token streaming callback — the third-party-code stand-in; called
    # as stream(request, token, index) from the serving loop's Python side
    stream: Optional[Callable] = None
    # request id stamped by the scheduler at submit time (the join key of
    # the request's event trace, DESIGN.md §13); a resubmission restarts
    # the lifecycle and gets a fresh rid
    rid: Optional[int] = None

    def __post_init__(self):
        if self.arrival_time is None:
            self.arrival_time = time.perf_counter()


class ServingEngine:
    """``bucket_batches=True`` pads every batch up to the next power-of-two
    size (repeating the last prompt row; pad rows decode but are ignored),
    bounding the number of distinct batch shapes — and therefore TraceGraph
    families (DESIGN.md §8) — to O(log max-batch)."""

    def __init__(self, cfg: ModelConfig, params, *, max_len: int = 512,
                 temperature: float = 0.0, use_terra: bool = True,
                 bucket_batches: bool = False, optimize=None, device=None):
        self.device = dev = resolve_device(device)
        self.cfg = cfg
        leaves, treedef = tree_flatten(params)
        # params already on the device are used as they are (no copy)
        self.params = tree_unflatten(treedef,
                                     [as_tensor(l, dev) for l in leaves])
        self.max_len = max_len
        self.bucket_batches = bucket_batches
        self.prefill, self.decode = jit_serve_steps(
            cfg, max_len, temperature, donate_cache=True, device=dev)
        # Whisper's encoder, in the serving steps' capture context
        self.encode = (jit_encode_step(cfg, dev,
                                       getattr(self.decode, "ctx", None))
                       if cfg.enc_layers else None)
        # serving defaults to the SAFE pass pipeline (no constant-feed
        # folding: decode-step token feeds change every call, DESIGN.md
        # §10); $TERRA_OPTIMIZE still overrides when optimize is None
        self.terra = (TerraDecoder(cfg, self.params, temperature,
                                   optimize=optimize, device=dev)
                      if use_terra else None)
        # lock-step counters ride the same event substrate as everything
        # else (DESIGN.md §13): stats IS the stream's counter dict
        self.events = EventStream(counters={
            "prefill_tokens": 0, "decode_steps": 0,
            "decode_time": 0.0, "prefill_time": 0.0})
        self.stats = self.events.counters

    def run_batch(self, requests: List[Request], **extras) -> List[Request]:
        """Serve one batch of same-length prompts in lock-step.

        Ragged prompt lengths are rejected up front (the batch tensor is
        rectangular by construction — variable-length admission is what
        the continuous-batching scheduler in serve/scheduler/ is for).
        The decode loop's budget tracks the *live* requests only: rows
        that hit EOS or their token budget stop counting, so the loop
        ends exactly when the last live row finishes; pad rows added by
        ``bucket_batches`` never extend it.

        ``cross_states`` [B, T, d] (the VLM's vision states) or
        ``frontend_embeds`` [B, T, d] (Whisper's frames, encoded here
        once; a model without an encoder ignores them, as the
        reference's prefill does) go with the batch, row for row; pad
        rows repeat the last row's."""
        cross = extras.pop("cross_states", None)
        frames = extras.pop("frontend_embeds", None)
        if extras:
            raise TypeError(f"unexpected arguments {sorted(extras)}")
        B = len(requests)
        lengths = {len(r.prompt) for r in requests}
        if len(lengths) != 1:
            raise ValueError(
                f"run_batch requires same-length prompts, got lengths "
                f"{sorted(lengths)}; use "
                f"serve.scheduler.ContinuousBatchingScheduler for "
                f"mixed-length workloads")
        prompts = np.stack([r.prompt for r in requests]).astype(np.int32)
        if self.bucket_batches:
            padded = bucket_pow2(B)
            if padded > B:
                prompts = np.concatenate(
                    [prompts, np.repeat(prompts[-1:], padded - B, axis=0)])
        t0 = time.perf_counter()
        if self.encode is not None and frames is not None:
            cross = self.encode(self.params, self._rows(frames, len(prompts)))
        elif cross is not None:
            cross = self._rows(cross, len(prompts))
        next_tok, cache = self.prefill(self.params,
                                       as_tensor(prompts, self.device), cross)
        next_tok = to_numpy(next_tok)[:, None]
        now = time.perf_counter()
        self.stats["prefill_time"] += now - t0
        # pad rows are repeats, not work done for a request
        self.stats["prefill_tokens"] += prompts[:B].size

        def live():
            return [r for r in requests
                    if not r.done and len(r.out_tokens) < r.max_new_tokens]

        cap = self.max_len - prompts.shape[1] - 1   # cache capacity
        t0 = time.perf_counter()
        # the finally block keeps the engine and the batch's accounting
        # consistent even when a user stream callback raises mid-batch:
        # pending symbolic work is drained, unfinished rows get their
        # finish stamp, and decode_time is recorded
        try:
            for r, t in zip(requests, next_tok[:, 0]):
                r.out_tokens = [int(t)]
                r.first_token_time = now
                r.done = (int(t) == r.eos_id)
                if r.done or r.max_new_tokens <= 1:
                    r.finish_time = now
                if r.stream is not None:
                    r.stream(r, int(t), 0)
            if self.terra is not None:
                self.terra.begin_batch(cache)
            steps = 0
            while steps < cap:
                # the break condition counts live rows only: done/pad
                # rows never stretch the loop
                if not live():
                    break
                if self.terra is not None:
                    tok = self.terra.step(next_tok, cross)
                    next_tok = np.asarray(tok)    # Output Fetching point
                else:
                    tok, cache = self.decode(self.params, cache,
                                             as_tensor(next_tok, self.device),
                                             None, cross)
                    next_tok = to_numpy(tok)
                steps += 1
                self.stats["decode_steps"] += 1
                now = time.perf_counter()
                for i, r in enumerate(requests):
                    if r.done or len(r.out_tokens) >= r.max_new_tokens:
                        continue
                    t = int(next_tok[i, 0])
                    r.out_tokens.append(t)
                    if t == r.eos_id:
                        r.done = True
                    # stamp finish at the step the row actually retires,
                    # not at batch drain — early-EOS latency must not
                    # include the steps the row merely rode along for
                    if (r.done or len(r.out_tokens) >= r.max_new_tokens) \
                            and r.finish_time is None:
                        r.finish_time = now
                    if r.stream is not None:
                        r.stream(r, t, len(r.out_tokens) - 1)
        finally:
            if self.terra is not None:
                self.terra.wait()
            now = time.perf_counter()
            for r in requests:
                if r.finish_time is None:  # capped, or aborted mid-batch
                    r.finish_time = now
            self.stats["decode_time"] += now - t0
        return requests

    def _rows(self, states, rows: int):
        """Side-input states on the engine's device, padded to ``rows``
        by repeating the last row (the pad rows' prompts repeat too)."""
        states = as_tensor(states, self.device)
        if states.shape[0] < rows:
            states = torch.cat([states, states[-1:].expand(
                rows - states.shape[0], *states.shape[1:])])
        return states

    def close(self) -> None:
        if self.terra is not None:
            self.terra.close()
        ctx = getattr(self.decode, "ctx", None)     # captured on a card
        if ctx is not None:
            ctx.release()
