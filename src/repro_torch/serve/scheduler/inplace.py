"""In-place forms of the pool ops (``def_op(..., inplace=, writes=)``).

``serve.slot_decode``, ``kernel.slot_decode_paged`` and
``serve.slot_prefill`` return new pool leaves, positions and token frame
(outputs 1..) for their pool inputs; their in-place forms write them into
those inputs and return the inputs.  Only a caller that owns the pool may
call one: a steady iteration's twin (core/graphgen.py) or a prefill's
splice while a live steady plan owns the pool (scheduler.py), which no
rollback snapshot holds (DESIGN.md §4.2).  The ``use_terra=False``
baseline's steps write their donated pool through :func:`in_place` too.
"""

from __future__ import annotations

from repro_torch.core.capture import count_pool_copy
from repro_torch.models import attention as A


def pool_writes(_n_params: int, _n_cache: int, **_):
    """The in-place (input, output) pairs: pool leaves, pos and tokf."""
    return tuple((_n_params + k, 1 + k) for k in range(_n_cache + 2))


def in_place_form(impl):
    """``impl`` writing into its pool inputs: the K/V rows into the arena
    and the prefill's rows into the pool (``attention.cache_in_place``),
    the rest once the step consumed them (:func:`in_place`)."""
    def run(*leaves, **attrs):
        lo = attrs["_n_params"]
        with A.cache_in_place():
            return in_place(impl, lo, lo + attrs["_n_cache"] + 2, attrs,
                            *leaves)
    return run


def in_place(fn, lo: int, hi: int, attrs: dict, *args):
    """``fn(*args)`` with its new pool leaves (outputs 1..) written into
    the pool arguments ``args[lo:hi]``, which it returns in their place
    (a leaf ``fn`` wrote in place is not copied; the bytes of those that
    are go to ``capture.count_pool_copy``)."""
    outs = fn(*args, **attrs)
    pool = args[lo:hi]
    for dst, src in zip(pool, outs[1:]):
        if src.data_ptr() != dst.data_ptr() or src.stride() != dst.stride():
            dst.copy_(src)
            count_pool_copy(dst.nbytes)
    return (outs[0],) + tuple(pool)
