"""The instrumented imperative op namespace (Terra's "DL operations").

Every function here is a *DL operation* in the paper's sense: when executed
under a Terra engine it is recorded into the trace (tracing phase) or
validated against the TraceGraph (co-execution phase); with no engine active
it simply executes eagerly with torch — that is the plain imperative
baseline the paper compares against.

Argument convention
-------------------
* positional arguments are tensors: TerraTensor | Variable-read | torch
  tensor or numpy array (becomes a *feed point*) | Python scalar (becomes a
  baked constant — exactly TF's constant-capture semantics, so programs
  that mutate such values exhibit the paper's Figure-1c behaviour and are
  handled by Terra through trace branching).
* keyword arguments are op *attributes* (part of node equality, Appendix A).

Every impl is a plain function of torch tensors (and baked Python scalars)
that never writes into its inputs: the engine keeps iteration-start
buffers for rollback, so results are always fresh tensors or views.  An
op may also register an *in-place* form (``def_op(..., inplace=,
writes=)``): the same results, with some outputs written into the inputs
``writes(**attrs)`` names and those inputs returned in their place.  Only
a caller that owns those inputs calls it (a steady iteration's twin,
core/graphgen.py, DESIGN.md §4.2).

Autodiff: ``GradientTape`` replays the recorded trace backwards, emitting one
``<op>.vjp`` operation per forward operation — so the backward pass lands in
the TraceGraph exactly like LazyTensor/PyTorch-XLA backward traces.  A
``.vjp`` op differentiates its forward impl with ``torch.func.vjp``, which
computes gradients inside the segments' ``torch.no_grad()`` too.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.tensor import TerraTensor, Variable, current_engine
from repro_torch.core.trace import (Aval, Ref, VarRef, as_tensor, torch_dtype,
                                    user_location)


# --------------------------------------------------------------------------
# Op registry
# --------------------------------------------------------------------------

@dataclasses.dataclass
class OpDef:
    name: str
    impl: Callable                 # pure torch fn: (*tensors, **attrs) -> tensor | tuple
    # False: the impl reads the device on the host or copies from pageable
    # memory, so a segment holding it cannot be a CUDA graph (capture.py)
    capturable: bool = True
    # the in-place form: same signature and results, output ``o`` written
    # into input ``a`` (and returned) for each (a, o) of ``writes(**attrs)``
    inplace: Optional[Callable] = None
    writes: Optional[Callable] = None


OPS: Dict[str, OpDef] = {}


@dataclasses.dataclass(frozen=True)
class Const:
    """A Python scalar captured as a baked constant input slot."""
    value: Any

    def __hash__(self):
        return hash((type(self.value).__name__, self.value))


def def_op(name: str, impl: Callable, capturable: bool = True,
           inplace: Optional[Callable] = None,
           writes: Optional[Callable] = None) -> Callable:
    """Register ``impl`` and return the user-facing instrumented function.
    ``capturable=False`` declares that the impl cannot run inside a CUDA
    graph capture; segments and chains holding it then run eagerly.
    ``inplace`` is the op's in-place form and ``writes(**attrs)`` the
    (input position, output index) pairs it writes in place."""
    OPS[name] = OpDef(name, impl, capturable, inplace, writes)

    def op_fn(*tensor_args, **attrs):
        return _call_op(name, tensor_args, attrs)

    op_fn.__name__ = name
    return op_fn


def op_impl(name: str) -> Callable:
    return OPS[name].impl


# --------------------------------------------------------------------------
# Dispatch
# --------------------------------------------------------------------------

def _canon_attrs(attrs: dict) -> Tuple[Tuple[str, Any], ...]:
    def canon(v):
        if isinstance(v, list):
            return tuple(canon(x) for x in v)
        if isinstance(v, np.dtype):
            return str(v)
        return v
    return tuple(sorted((k, canon(v)) for k, v in attrs.items()))


def _classify_arg(a):
    """-> ('tensor', TerraTensor) | ('const', scalar) | ('feed', np/torch array)."""
    if isinstance(a, TerraTensor):
        return ("tensor", a)
    if isinstance(a, Variable):
        # implicit read
        return ("tensor", a.read()) if current_engine() is not None else ("feed", a._value)
    if isinstance(a, (bool, int, float)) or a is None:
        return ("const", a)
    if isinstance(a, (np.ndarray, np.generic)):
        return ("feed", np.asarray(a))
    if isinstance(a, torch.Tensor):
        return ("feed", a)
    raise TypeError(f"unsupported op argument of type {type(a)}")


def _call_op(name: str, tensor_args, attrs):
    eng = current_engine()
    attrs_t = _canon_attrs(attrs)
    args = [_classify_arg(a) for a in tensor_args]
    if eng is None:
        # plain imperative execution — unwrap and run
        vals = []
        for kind, a in args:
            if kind == "tensor":
                vals.append(a._eager if a._eager is not None else a.value())
            elif kind == "const":
                vals.append(a.value if isinstance(a, Const) else a)
            else:
                vals.append(as_tensor(a))
        out = OPS[name].impl(*vals, **dict(attrs_t))
        return _wrap_eager(out)
    loc = user_location(skip_files=getattr(eng, "skip_files", ()))
    return eng.record_op(name, args, attrs_t, loc)


def _wrap_eager(out):
    if isinstance(out, tuple):
        return tuple(TerraTensor(None, Aval.of(o), eager=o) for o in out)
    return TerraTensor(None, Aval.of(out), eager=out)


# --------------------------------------------------------------------------
# Generic VJP ops: one `<name>.vjp` op per forward op
# --------------------------------------------------------------------------

def _zero_cotangent(x, device) -> torch.Tensor:
    """The cotangent of an input that is not differentiated: zeros of its
    own shape and dtype (a 0-d tensor for a baked scalar)."""
    if isinstance(x, torch.Tensor):
        return torch.zeros_like(x)
    return torch.zeros((), device=device, dtype=as_tensor(x).dtype)


def get_vjp_op_name(fwd_name: str) -> str:
    name = fwd_name + ".vjp"
    if name not in OPS:
        fwd_impl = OPS[fwd_name].impl

        def vjp_impl(*args, _n_out: int, _n_in: int, **attrs):
            cts = args[:_n_out]
            inputs = list(args[_n_out:_n_out + _n_in])
            # torch.func.vjp takes floating tensors only: integer tensors
            # and baked scalars are closed over and get zero cotangents
            # (the tape's float filter drops them, as it drops JAX's
            # float0 cotangents)
            diff = [i for i, x in enumerate(inputs)
                    if isinstance(x, torch.Tensor) and x.is_floating_point()]
            grads = [_zero_cotangent(x, cts[0].device) for x in inputs]
            if diff:
                def primal(*d):
                    ins = list(inputs)
                    for i, v in zip(diff, d):
                        ins[i] = v
                    return fwd_impl(*ins, **attrs)

                _, vjp_fn = torch.func.vjp(primal,
                                           *(inputs[i] for i in diff))
                outs = vjp_fn(cts[0] if _n_out == 1 else tuple(cts))
                for i, g in zip(diff, outs):
                    grads[i] = g
            return tuple(grads) if len(grads) > 1 else grads[0]

        OPS[name] = OpDef(name, vjp_impl, OPS[fwd_name].capturable)
    return name


# --------------------------------------------------------------------------
# GradientTape (TF-style; backward ops are recorded as Terra ops)
# --------------------------------------------------------------------------

class GradientTape:
    def __init__(self):
        self._start = None
        self._engine = None

    def __enter__(self):
        eng = current_engine()
        if eng is None:
            raise RuntimeError("GradientTape requires an active Terra engine "
                               "(use terra.imperative()/Terra runtime)")
        self._engine = eng
        self._start = eng.tape_mark()
        return self

    def __exit__(self, *exc):
        return False

    def gradient(self, loss: TerraTensor, sources):
        """Emit the backward trace for ``loss`` w.r.t. ``sources``.

        ``sources`` is a list of Variables or TerraTensors.  Returns a list
        of TerraTensors (cotangents), zeros where unconnected.
        """
        eng = self._engine
        entries, tensors_of = eng.tape_slice(self._start)
        if not isinstance(loss.ref, Ref):
            raise ValueError("loss must be produced by a recorded op")

        source_refs = []
        for s in sources:
            if isinstance(s, Variable):
                source_refs.append(eng.variable_read_ref(s))
            else:
                source_refs.append(s.ref)

        ct: Dict[Any, TerraTensor] = {loss.ref: ones_like(loss)}

        # entries are in execution (topological) order — walk backward
        for idx in range(len(entries) - 1, -1, -1):
            ordinal, entry = entries[idx]
            out_cts = [ct.get(Ref(ordinal, i)) for i in range(len(entry.out_avals))]
            if all(c is None for c in out_cts):
                continue
            if entry.op_name in _NONDIFF_OPS:
                continue
            outs = tensors_of(ordinal)
            filled = [c if c is not None else zeros_like(outs[i])
                      for i, c in enumerate(out_cts)]
            in_tensors = eng.tensors_for_input_slots(ordinal, entry)
            vjp_name = get_vjp_op_name(entry.op_name)
            grads = _call_op(
                vjp_name,
                tuple(filled) + tuple(in_tensors),
                dict(entry.attrs) | {"_n_out": len(entry.out_avals),
                                     "_n_in": len(in_tensors)},
            )
            if not isinstance(grads, tuple):
                grads = (grads,)
            for slot, g in zip(entry.input_refs, grads):
                if isinstance(slot, (Ref, VarRef)) and _is_float(g.aval.dtype):
                    prev = ct.get(slot)
                    ct[slot] = g if prev is None else add(prev, g)

        results = []
        for s, r in zip(sources, source_refs):
            g = ct.get(r)
            if g is None:
                ref_t = s.read() if isinstance(s, Variable) else s
                g = zeros_like(ref_t)
            results.append(g)
        return results


def _is_float(dtype) -> bool:
    return torch_dtype(dtype).is_floating_point


# ops with no gradient (kernel_sub adds its fused ops)
_NONDIFF_OPS = {"greater", "less", "greater_equal", "less_equal", "equal",
                "argmax", "argmin", "stop_gradient", "iota", "one_hot_int"}


# --------------------------------------------------------------------------
# Composite ops: register any pure torch function as a single DL operation
# --------------------------------------------------------------------------

def terra_op(fn: Callable = None, *, name: str = None, nondiff: bool = False):
    """Decorator: wrap a pure torch function as one Terra DL operation.

    This is the framework-scale granularity: e.g. a whole decode step
    becomes a single node in the TraceGraph (see DESIGN.md §2, row "TF ops
    = graph nodes").
    """
    def deco(f):
        opname = name or f"composite.{f.__module__}.{f.__qualname__}"
        op = def_op(opname, f)
        if nondiff:
            _NONDIFF_OPS.add(opname)
        functools.update_wrapper(op, f)
        return op
    return deco(fn) if fn is not None else deco


# --------------------------------------------------------------------------
# RNG plumbing (random ops take a key feed so graphs stay iteration-stable)
# --------------------------------------------------------------------------

def draw_key(gen: torch.Generator) -> torch.Tensor:
    """A random-op key: two int64 words drawn from ``gen`` (a host tensor,
    fed to the graph like the reference's uint32[2] key)."""
    return torch.randint(0, 2 ** 62, (2,), generator=gen, dtype=torch.int64)


_eager_gen = torch.Generator().manual_seed(0)
_eager_key_lock = threading.Lock()


def _next_key():
    eng = current_engine()
    if eng is not None:
        return eng.next_rng_key()
    with _eager_key_lock:
        return draw_key(_eager_gen)


# A key becomes random bits by a counter hash: element i of a draw gets
# mix(mix(i ^ s1) ^ (i >> 32) ^ s2), where (s1, s2) are hashed from the
# key's two words and ``mix`` is a 32-bit avalanche (xor-shifts and odd
# multipliers).  Every value is a non-negative int64 below 2**32 and every
# multiplier is below 2**31, so no product wraps: the bits are the same on
# the CPU and on the card, and they are made where the key lies, with no
# host sync.  (They cannot match the reference's ``jax.random`` draws.)
_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def _random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` hashed 32-bit words (int64 tensor on the key's device)."""
    s1 = _mix32((key[0] & _M32) ^ _mix32((key[0] >> 32) & _M32))
    s2 = _mix32((key[1] & _M32) ^ _mix32(((key[1] >> 32) & _M32) ^ s1))
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    return _mix32(_mix32((i & _M32) ^ s1) ^ (i >> 32) ^ s2)


def _uniform01(key, n: int) -> torch.Tensor:
    """float32 in [0, 1): the top 24 bits of each word, exactly."""
    return (_random_bits(key, n) >> 8).to(torch.float32) * 2.0 ** -24


# --------------------------------------------------------------------------
# The op set
# --------------------------------------------------------------------------

def _idx_encode(idx):
    def enc(i):
        if isinstance(i, slice):
            return ("slice", i.start, i.stop, i.step)
        if i is Ellipsis:
            return ("ellipsis",)
        if i is None:
            return ("newaxis",)
        if isinstance(i, int):
            return ("int", i)
        raise TypeError(f"only static indices supported, got {type(i)}")
    if not isinstance(idx, tuple):
        idx = (idx,)
    return tuple(enc(i) for i in idx)


def _idx_decode(enc):
    out = []
    for e in enc:
        if e[0] == "slice":
            out.append(slice(e[1], e[2], e[3]))
        elif e[0] == "ellipsis":
            out.append(Ellipsis)
        elif e[0] == "newaxis":
            out.append(None)
        else:
            out.append(e[1])
    return tuple(out)


def _tensor_like(b, a) -> torch.Tensor:
    if isinstance(b, torch.Tensor):
        return b
    if isinstance(b, (bool, int, float)):
        # a fill on the device: no host-to-device copy, so capturable
        return torch.full((), b, dtype=a.dtype, device=a.device)
    return torch.as_tensor(b, dtype=a.dtype, device=a.device)


def _both(fn):
    """A binary torch function that also takes a baked scalar on either
    side (the reference's weakly typed Python scalars)."""
    def impl(a, b):
        if not isinstance(a, torch.Tensor):
            a = _tensor_like(a, b)
        return fn(a, _tensor_like(b, a))
    return impl


def _reduce(fn, a, axis, keepdims):
    out = fn(a) if axis is None else fn(a, dim=axis, keepdim=keepdims)
    if keepdims and axis is None:
        out = out.reshape((1,) * a.ndim)
    return out


# integer and boolean sums come out in the default 32-bit integer, as in
# the reference (64-bit types off)
_SUM_NARROW = (torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32)


def _sum(a, axis=None, keepdims=False):
    out = _reduce(torch.sum, a, axis, keepdims)
    if a.is_floating_point():
        return out
    return out.to(torch.int32 if a.dtype in _SUM_NARROW else a.dtype)


def _mean(a, axis=None, keepdims=False):
    return _reduce(torch.mean, a if a.is_floating_point() else a.float(),
                   axis, keepdims)


def _max(a, axis=None, keepdims=False):
    if axis is None:
        out = torch.amax(a)
        return out.reshape((1,) * a.ndim) if keepdims else out
    return torch.amax(a, dim=axis, keepdim=keepdims)


def _transpose(a, axes=None):
    return a.permute(*(axes if axes is not None else range(a.ndim - 1, -1, -1)))


def promoted(fn):
    """A product of several operands that first casts them all to their
    promoted type, as ``jnp.matmul``/``jnp.einsum`` do (torch's kernels
    refuse mixed dtypes; its promotion table agrees with JAX's for the
    float32/bfloat16/int32 pairs the op layer sees)."""
    def impl(*xs, **attrs):
        dt = functools.reduce(torch.promote_types, (x.dtype for x in xs))
        return fn(*(x.to(dt) for x in xs), **attrs)
    return impl


def _rms_norm(x, g, eps=1e-6):
    return g * x * torch.rsqrt(torch.mean(torch.square(x), -1, keepdim=True)
                               + eps)


def _layer_norm(x, g, b, eps=1e-5):
    mu = torch.mean(x, -1, keepdim=True)
    var = torch.mean(torch.square(x - mu), -1, keepdim=True)
    return g * (x - mu) * torch.rsqrt(var + eps) + b


def _softmax_xent(logits, labels):
    logp = torch.log_softmax(logits, -1)
    oh = F.one_hot(labels.long(), logits.shape[-1]).to(logp.dtype)
    return -torch.mean(torch.sum(logp * oh, -1))


identity      = def_op("identity", lambda a: as_tensor(a))
add           = def_op("add", lambda a, b: a + b)
sub           = def_op("sub", lambda a, b: a - b)
mul           = def_op("mul", lambda a, b: a * b)
div           = def_op("div", lambda a, b: a / b)
power         = def_op("power", lambda a, b: a ** b)
neg           = def_op("neg", lambda a: torch.neg(a))
exp           = def_op("exp", lambda a: torch.exp(a))
log           = def_op("log", lambda a: torch.log(a))
sqrt          = def_op("sqrt", lambda a: torch.sqrt(a))
rsqrt         = def_op("rsqrt", lambda a: torch.rsqrt(a))
square        = def_op("square", lambda a: torch.square(a))
tanh          = def_op("tanh", lambda a: torch.tanh(a))
sigmoid       = def_op("sigmoid", lambda a: torch.sigmoid(a))
relu          = def_op("relu", lambda a: torch.relu(a))
gelu          = def_op("gelu", lambda a: F.gelu(a, approximate="tanh"))
silu          = def_op("silu", lambda a: F.silu(a))
softmax       = def_op("softmax", lambda a, *, axis=-1: torch.softmax(a, axis))
log_softmax   = def_op("log_softmax", lambda a, *, axis=-1: torch.log_softmax(a, axis))
matmul        = def_op("matmul", promoted(torch.matmul))
einsum        = def_op("einsum", promoted(lambda *xs, expr: torch.einsum(expr, *xs)))
reshape       = def_op("reshape", lambda a, *, new_shape: torch.reshape(a, new_shape))
transpose     = def_op("transpose", _transpose)
_getitem_raw  = def_op("getitem", lambda a, *, idx: a[_idx_decode(idx)])
concat        = def_op("concat", lambda *xs, axis=0: torch.cat(xs, axis))
stack_op      = def_op("stack", lambda *xs, axis=0: torch.stack(xs, axis))
reduce_sum    = def_op("reduce_sum", _sum)
reduce_mean   = def_op("reduce_mean", _mean)
reduce_max    = def_op("reduce_max", _max)
argmax        = def_op("argmax", lambda a, *, axis=-1: torch.argmax(a, axis).to(torch.int32))
greater       = def_op("greater", lambda a, b: a > b)
less          = def_op("less", lambda a, b: a < b)
greater_equal = def_op("greater_equal", lambda a, b: a >= b)
less_equal    = def_op("less_equal", lambda a, b: a <= b)
equal         = def_op("equal", _both(torch.eq))
where         = def_op("where", lambda c, a, b: torch.where(c, a, b))
cast          = def_op("cast", lambda a, *, dtype: a.to(torch_dtype(dtype)))
stop_gradient = def_op("stop_gradient", lambda a: a.detach())
zeros_like    = def_op("zeros_like", lambda a: torch.zeros_like(a))
ones_like     = def_op("ones_like", lambda a: torch.ones_like(a))
abs_op        = def_op("abs", lambda a: torch.abs(a))
maximum       = def_op("maximum", _both(torch.maximum))
minimum       = def_op("minimum", _both(torch.minimum))
clip          = def_op("clip", lambda a, *, lo, hi: torch.clamp(a, lo, hi))
embedding     = def_op("embedding", lambda table, ids: table[ids.long()])
one_hot       = def_op("one_hot", lambda ids, *, depth, dtype="float32": F.one_hot(ids.long(), depth).to(torch_dtype(dtype)))
layer_norm    = def_op("layer_norm", _layer_norm)
rms_norm      = def_op("rms_norm", _rms_norm)
softmax_xent  = def_op("softmax_xent", _softmax_xent)


def _same_pad(size: int, k: int, s: int):
    """XLA's "SAME" padding of one spatial dim: (low, high)."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv2d(x, w, stride=1, padding="SAME"):
    """NHWC input, HWIO filter, as the reference's dimension numbers.
    ``F.conv2d`` refuses "same" at strides above 1, so SAME is padded
    explicitly, XLA's way (the odd pixel goes high)."""
    xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    if padding == "SAME":
        (hl, hh), (wl, wh) = (_same_pad(x.shape[1], w.shape[0], stride),
                              _same_pad(x.shape[2], w.shape[1], stride))
    elif padding == "VALID":
        (hl, hh), (wl, wh) = (0, 0), (0, 0)
    else:                                   # explicit ((lo, hi), (lo, hi))
        (hl, hh), (wl, wh) = padding
    xn = F.pad(xn, (wl, wh, hl, hh))
    return F.conv2d(xn, wn, stride=stride).permute(0, 2, 3, 1)


def _pool(fn, x, window, stride):
    """A "VALID" window reduction over an NHWC tensor."""
    return fn(x.permute(0, 3, 1, 2), window, stride).permute(0, 2, 3, 1)


def _dropout(x, key, rate):
    """Keep each element where its hashed word falls below (1 - rate)·2³²,
    scaled by 1 / (1 - rate); rate 0 passes ``x`` through."""
    if rate <= 0.0:
        return x
    keep = _random_bits(key.to(x.device), x.numel()).reshape(x.shape) \
        < int((1.0 - rate) * 2 ** 32)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _random_normal(key, shape, dtype="float32"):
    """Box–Muller over two uniform streams: z = √(−2 ln(1 − u₁))·cos(2πu₂)."""
    n = int(np.prod(shape, dtype=np.int64))
    u = _uniform01(key, 2 * n)
    z = torch.sqrt(-2.0 * torch.log1p(-u[:n])) * torch.cos(2 * np.pi * u[n:])
    return z.reshape(shape).to(torch_dtype(dtype))


def _random_uniform(key, shape, dtype="float32"):
    n = int(np.prod(shape, dtype=np.int64))
    return _uniform01(key, n).reshape(shape).to(torch_dtype(dtype))


conv2d        = def_op("conv2d", _conv2d)
max_pool2d    = def_op("max_pool2d", lambda x, *, window=2, stride=2: _pool(F.max_pool2d, x, window, stride))
avg_pool2d    = def_op("avg_pool2d", lambda x, *, window=2, stride=2: _pool(F.avg_pool2d, x, window, stride))
resize_nearest = def_op(
    "resize_nearest",
    lambda x, *, factor=2: x.repeat_interleave(factor, 1).repeat_interleave(factor, 2))
_dropout_raw  = def_op("dropout", _dropout)
_random_normal_raw = def_op("random_normal", _random_normal)
_random_uniform_raw = def_op("random_uniform", _random_uniform)


def getitem(a, *, idx):
    return _getitem_raw(a, idx=_idx_encode(idx))


def dropout(x, rate: float):
    """Dropout with the rate captured as a baked constant (TF semantics).

    ``rate`` changing across iterations (e.g. via Python object mutation,
    Figure 1c) produces a trace branch that Terra handles transparently.
    The mask comes from the op's key feed by the counter hash above.
    """
    return _dropout_raw(x, _next_key(), rate=float(rate))


def random_normal(shape, dtype="float32"):
    return _random_normal_raw(_next_key(), shape=tuple(shape), dtype=dtype)


def random_uniform(shape, dtype="float32"):
    return _random_uniform_raw(_next_key(), shape=tuple(shape), dtype=dtype)


def mean_squared_error(pred, target):
    return reduce_mean(square(sub(pred, target)))


def sparse_softmax_xent(logits, labels):
    return softmax_xent(logits, labels)
