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
buffers for rollback, so results are always fresh tensors or views.

The backward machinery (``GradientTape`` and the per-op ``<op>.vjp`` ops)
and the convolution, pooling, dropout and random ops of the reference wait
for the training slice of the port.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.tensor import TerraTensor, Variable, current_engine
from repro_torch.core.trace import Aval, as_tensor, torch_dtype, user_location


# --------------------------------------------------------------------------
# Op registry
# --------------------------------------------------------------------------

@dataclasses.dataclass
class OpDef:
    name: str
    impl: Callable                 # pure torch fn: (*tensors, **attrs) -> tensor | tuple


OPS: Dict[str, OpDef] = {}


@dataclasses.dataclass(frozen=True)
class Const:
    """A Python scalar captured as a baked constant input slot."""
    value: Any

    def __hash__(self):
        return hash((type(self.value).__name__, self.value))


def def_op(name: str, impl: Callable) -> Callable:
    """Register ``impl`` and return the user-facing instrumented function."""
    OPS[name] = OpDef(name, impl)

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


# ops with no gradient (kernel_sub adds its fused ops; the training slice
# brings the tape that reads this set)
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
    return b if isinstance(b, torch.Tensor) else torch.as_tensor(
        b, dtype=a.dtype, device=a.device)


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


def getitem(a, *, idx):
    return _getitem_raw(a, idx=_idx_encode(idx))


def mean_squared_error(pred, target):
    return reduce_mean(square(sub(pred, target)))


def sparse_softmax_xent(logits, labels):
    return softmax_xent(logits, labels)
