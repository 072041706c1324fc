"""Serving decode under Terra co-execution.

The counterpart of the reference's ``serve/terra_decode.py``.  The
serving engine's decode loop is an imperative Python program — per-request
bookkeeping, EOS early-exits, detokenizers — which is exactly the workload
class Terra targets (paper §2).  This module routes it through the Terra
runtime instead of a captured step:

* the whole decode step becomes a **single DL op** (``serve.decode_step``,
  the paper's framework-granularity segment model, DESIGN.md §2),
* model parameters and the KV/recurrent cache live as framework
  :class:`Variable`\\ s, so their buffers stay device-resident in the
  engine's VariableStore and thread segment-to-segment without bouncing
  through Python,
* only the sampled token crosses back per step (an Output Fetching point),
  leaving Python free for retirement bookkeeping while the GraphRunner
  queues the next step,
* the VLM's vision states or Whisper's encoder states (``cross_states``)
  are a per-step feed of the decode op, as in the reference.

On a CUDA card the engine captures the compiled decode segment as a CUDA
graph, as it does every segment (``core/capture.py``).  Pytrees are
flattened at the boundary: ``_META`` keeps the (static) treedefs out of
band so the op's attributes stay hashable.
"""

from __future__ import annotations

import os
from typing import List, Optional

from repro_torch.core import function as terra_function
from repro_torch.core import ops as ops_mod
from repro_torch.core.ops import def_op
from repro_torch.core.pytree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.core.tensor import Variable
from repro_torch.core.trace import as_tensor
from repro_torch.serve.meta import MetaRegistry
from repro_torch.serve.serve_step import build_decode_step

# meta id -> (params_treedef, cache_treedef, decode_fn)
_META = MetaRegistry()


def _register_meta(params_def, cache_def, decode_fn) -> int:
    return _META.register((params_def, cache_def, decode_fn))


def _decode_impl(*leaves, _meta: int, _n_params: int, _n_cache: int,
                 _has_rng: bool, _has_cross: bool):
    params_def, cache_def, decode_fn = _META.get(_meta)
    params = tree_unflatten(params_def, leaves[:_n_params])
    cache = tree_unflatten(cache_def, leaves[_n_params:_n_params + _n_cache])
    rest = list(leaves[_n_params + _n_cache:])
    tokens = rest.pop(0)
    rng = rest.pop(0) if _has_rng else None
    cross = rest.pop(0) if _has_cross else None
    tok, new_cache = decode_fn(params, cache, tokens, rng=rng,
                               cross_states=cross)
    return (tok,) + tuple(tree_leaves(new_cache))


_decode_op = def_op("serve.decode_step", _decode_impl)


class TerraDecoder:
    """Drives lock-step decode through a ``terra.function``.

    One call of the wrapped step function is one Terra iteration: the first
    two steps of the first batch trace, every later step co-executes.  The
    KV cache is rebound (``reset_variable``) from the prefill output at
    each batch start and the *same* cache variables are recycled across
    batches even when the batch size changes: a new shape rebinds the
    variables to new avals, which selects (or traces) the matching
    shape-class TraceGraph family (DESIGN.md §8).  Fresh variables are
    only minted when the cache *structure* (treedef / leaf count) changes
    — a different model, not a different batch.  ``device`` (default: the
    CUDA card) is the engine's.
    """

    def __init__(self, cfg, params, temperature: float = 0.0,
                 optimize: Optional[str] = None, device=None):
        if optimize is None:
            # serving's default is the SAFE pipeline (no constant-feed
            # folding: the token feed changes every call, DESIGN.md §10);
            # $TERRA_OPTIMIZE still overrides it
            optimize = os.environ.get("TERRA_OPTIMIZE") or "safe"
        self.cfg = cfg
        self.temperature = temperature
        self._decode_fn = build_decode_step(cfg, temperature)
        leaves, self._params_def = tree_flatten(params)
        self._param_vars: List[Variable] = [
            Variable(l, name=f"srv.p{i}") for i, l in enumerate(leaves)]
        self._cache_vars: Optional[List[Variable]] = None
        self._cache_def = None
        self._meta: Optional[int] = None
        self._tf = terra_function(self._step, optimize=optimize,
                                  device=device)

    # ------------------------------------------------------------------
    @property
    def phase(self) -> str:
        return self._tf.phase

    @property
    def stats(self):
        return self._tf.stats

    @property
    def engine(self):
        return self._tf.engine

    # ------------------------------------------------------------------
    def begin_batch(self, cache) -> None:
        """Bind the prefilled cache into the engine's variable store.

        Shape changes REUSE the existing cache variables: ``reset_variable``
        rebinds them and the engine's shape-class signature flips to the
        matching TraceGraph family.  Only a cache-structure change mints
        fresh variables, releasing the old set from the store."""
        leaves, cache_def = tree_flatten(cache)
        eng = self._tf.engine
        leaves = [as_tensor(l, eng.device) for l in leaves]
        if self._cache_vars is not None and cache_def == self._cache_def \
                and len(leaves) == len(self._cache_vars):
            for var, leaf in zip(self._cache_vars, leaves):
                eng.reset_variable(var, leaf)
            return
        if self._cache_vars is not None:
            for var in self._cache_vars:
                eng.release_variable(var)
        # _META entries stay: retired decode nodes survive in their
        # TraceGraph families as dead branches and still trace through
        # their meta id (the entries are treedefs — tiny)
        self._cache_vars = [Variable(l, name=f"srv.c{i}")
                            for i, l in enumerate(leaves)]
        self._cache_def = cache_def
        self._meta = _register_meta(self._params_def, cache_def,
                                    self._decode_fn)

    # ------------------------------------------------------------------
    def step(self, tokens, cross_states=None):
        """One decode step; returns a (possibly placeholder) token tensor.
        ``cross_states`` (on the engine's device) is a feed of the step."""
        return self._tf(tokens, cross_states)

    def _step(self, tokens, cross_states):
        args = [v.read() for v in self._param_vars]
        args += [v.read() for v in self._cache_vars]
        args.append(tokens)
        has_rng = self.temperature > 0.0
        if has_rng:
            args.append(ops_mod._next_key())    # iteration-stable key feed
        has_cross = cross_states is not None
        if has_cross:
            args.append(cross_states)
        outs = _decode_op(*args, _meta=self._meta,
                          _n_params=len(self._param_vars),
                          _n_cache=len(self._cache_vars), _has_rng=has_rng,
                          _has_cross=has_cross)
        for var, leaf in zip(self._cache_vars, outs[1:]):
            var.assign(leaf)
        return outs[0]

    # ------------------------------------------------------------------
    def wait(self):
        self._tf.wait()

    def close(self):
        self._tf.close()
