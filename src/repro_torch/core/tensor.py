"""TerraTensor: the tensor handle of the imperative op layer.

In the *tracing phase* a TerraTensor holds a concrete ``torch.Tensor``
(eager value) in addition to its trace reference.  In the *co-execution phase* the
PythonRunner executes the skeleton program, so TerraTensors are placeholders
("empty tensor objects", paper §4.1): only the abstract value is known and
materialization triggers a fetch from the GraphRunner.

The same object is also used during divergence fallback: the CoExecutor
replays the validated prefix eagerly and fills ``_eager`` in-place, after
which the iteration continues imperatively (paper: "falls back to the
tracing phase") without re-running Python side effects.
"""

from __future__ import annotations

import threading
from typing import Any


from repro_torch.core.trace import Aval, as_tensor, dtype_name, to_numpy

_TLS = threading.local()


def current_engine():
    return getattr(_TLS, "engine", None)


def set_current_engine(engine) -> None:
    _TLS.engine = engine


class TerraTensor:
    """Handle for a DL-op result inside a Terra-managed program."""

    __slots__ = ("ref", "aval", "_eager", "engine", "_iter", "_future",
                 "__weakref__")

    def __init__(self, ref, aval: Aval, eager=None, engine=None, iter_id=-1):
        self.ref = ref
        self.aval = aval
        self._eager = eager
        self.engine = engine
        self._iter = iter_id
        # dispatch-layer fetch future, attached when the producing
        # iteration closes: lets the value be awaited *after* a later
        # iteration has started (the scheduler's lag-harvest window)
        self._future = None

    # -- metadata (always available; no materialization needed) ------------
    @property
    def shape(self):
        return self.aval.shape

    @property
    def dtype(self):
        return self.aval.dtype

    @property
    def ndim(self):
        return len(self.aval.shape)

    def __len__(self):
        if not self.aval.shape:
            raise TypeError("len() of a 0-d tensor")
        return self.aval.shape[0]

    def __repr__(self):
        kind = "eager" if self._eager is not None else "placeholder"
        return f"TerraTensor({kind}, shape={self.aval.shape}, dtype={self.aval.dtype})"

    # -- materialization (fetch points) -------------------------------------
    def value(self):
        """Materialize: returns a concrete tensor (paper's Output Fetching)."""
        if self._eager is not None:
            if self.engine is not None:
                # annotate the fetch point even in eager phases so the
                # generated graph outputs it (paper §4.2 Communication Point)
                self.engine.note_fetch(self)
            return self._eager
        if self.engine is None:
            raise RuntimeError("placeholder TerraTensor with no engine")
        return self.engine.materialize(self)

    def numpy(self):
        return to_numpy(self.value())

    def item(self):
        return self.numpy().item()

    def __float__(self):
        return float(self.item())

    def __int__(self):
        return int(self.item())

    def __bool__(self):
        return bool(self.numpy().all())

    def __array__(self, dtype=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    # -- operator sugar (dispatches into the instrumented op layer) ---------
    def _ops(self):
        from repro_torch.core import ops
        return ops

    def __add__(self, o):      return self._ops().add(self, o)
    def __radd__(self, o):     return self._ops().add(o, self)
    def __sub__(self, o):      return self._ops().sub(self, o)
    def __rsub__(self, o):     return self._ops().sub(o, self)
    def __mul__(self, o):      return self._ops().mul(self, o)
    def __rmul__(self, o):     return self._ops().mul(o, self)
    def __truediv__(self, o):  return self._ops().div(self, o)
    def __rtruediv__(self, o): return self._ops().div(o, self)
    def __pow__(self, o):      return self._ops().power(self, o)
    def __neg__(self):         return self._ops().neg(self)
    def __matmul__(self, o):   return self._ops().matmul(self, o)
    def __getitem__(self, idx):return self._ops().getitem(self, idx=idx)
    def __gt__(self, o):       return self._ops().greater(self, o)
    def __lt__(self, o):       return self._ops().less(self, o)
    def __ge__(self, o):       return self._ops().greater_equal(self, o)
    def __le__(self, o):       return self._ops().less_equal(self, o)

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return self._ops().reshape(self, new_shape=tuple(shape))

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return self._ops().transpose(self, axes=axes or None)

    @property
    def T(self):
        return self.transpose()

    def astype(self, dtype):
        return self._ops().cast(self, dtype=dtype_name(dtype))

    def sum(self, axis=None, keepdims=False):
        return self._ops().reduce_sum(self, axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._ops().reduce_mean(self, axis=axis, keepdims=keepdims)

    def max(self, axis=None, keepdims=False):
        return self._ops().reduce_max(self, axis=axis, keepdims=keepdims)


class Variable:
    """A framework variable (TF resource-variable analogue).

    The authoritative buffer lives in the engine's variable store, on the
    engine's device.  Reads and ``assign`` are
    recorded in the trace so the generated symbolic graph threads the update
    — this is what lets Terra run programs with Python *object mutation*
    (Figure 1c) that static converters mishandle.
    """

    _next_id = [0]
    _lock = threading.Lock()

    def __init__(self, init_value, name: str = ""):
        with Variable._lock:
            self.var_id = Variable._next_id[0]
            Variable._next_id[0] += 1
        self.name = name or f"var{self.var_id}"
        # stays where the caller made it; an engine's store stages it onto
        # the engine's device when the variable registers
        self._value = as_tensor(init_value)
        self.aval = Aval.of(self._value)

    # read
    def read(self) -> Any:
        eng = current_engine()
        if eng is None:
            return self._value
        return eng.read_variable(self)

    def assign(self, new_value) -> None:
        eng = current_engine()
        if eng is None:
            if isinstance(new_value, TerraTensor):     # an eager op result
                new_value = new_value.value()
            self._value = as_tensor(new_value)
            return
        eng.assign_variable(self, new_value)

    def assign_sub(self, delta) -> None:
        from repro_torch.core import ops
        self.assign(ops.sub(self.read(), delta))

    def assign_add(self, delta) -> None:
        from repro_torch.core import ops
        self.assign(ops.add(self.read(), delta))

    def value(self):
        eng = current_engine()
        if eng is None:
            return self._value
        return eng.variable_value(self)

    def numpy(self):
        return to_numpy(self.value())

    def __repr__(self):
        return f"Variable({self.name}, shape={self.aval.shape}, dtype={self.aval.dtype})"
