"""Serving requests.

This slice of the port carries the request record the continuous-batching
scheduler (serve/scheduler/) serves.  The lock-step ``ServingEngine``
(batched prefill, then lock-step decode through ``serve/terra_decode.py``
and ``serve/serve_step.py``) arrives in a later slice.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np


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
