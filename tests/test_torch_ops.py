"""The port's multi-operand ops promote mixed dtypes as the reference does.

``jnp.einsum``/``jnp.matmul`` cast every operand to the promoted type; the
port's ops must give the same dtype and values for a bfloat16 x float32
and an int32 x float32 pair, in either order (the unfused bf16 attention
chain multiplies f32 probabilities by bf16 values).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import ops as jops  # noqa: E402
from repro_torch.core import ops as tops  # noqa: E402
from repro_torch.core.trace import to_numpy  # noqa: E402

PAIRS = {"bf16xf32": ("bfloat16", "float32"),
         "f32xbf16": ("float32", "bfloat16"),
         "i32xf32": ("int32", "float32"),
         "f32xi32": ("float32", "int32")}
# (op, attrs, shape of a, shape of b, takes a condition first)
CASES = [("einsum", {"expr": "bsd,btd->bst"}, (2, 3, 4), (2, 5, 4), False),
         ("matmul", {}, (2, 3, 4), (4, 5), False),
         ("concat", {"axis": 0}, (2, 3), (2, 3), False),
         ("stack", {"axis": 1}, (2, 3), (2, 3), False),
         ("maximum", {}, (2, 3), (2, 3), False),
         ("minimum", {}, (2, 3), (2, 3), False),
         ("power", {}, (2, 3), (2, 3), False),
         ("where", {}, (2, 3), (2, 3), True)]


def _operand(rng, shape, dtype):
    a = (rng.randint(1, 4, shape) if dtype == "int32"
         else rng.uniform(0.5, 2.0, shape)).astype(np.float32)
    return (torch.from_numpy(a).to(getattr(torch, dtype)),
            jnp.asarray(a).astype(dtype))


@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_mixed_dtype_ops_promote_as_jnp(case, pair):
    name, attrs, sa, sb, cond = case
    rng = np.random.RandomState(0)
    ta, ja = _operand(rng, sa, PAIRS[pair][0])
    tb, jb = _operand(rng, sb, PAIRS[pair][1])
    targs, jargs = [ta, tb], [ja, jb]
    if cond:
        c = rng.rand(*sa) > 0.5
        targs, jargs = [torch.from_numpy(c)] + targs, [jnp.asarray(c)] + jargs
    got = tops.op_impl(name)(*targs, **attrs)
    want = jops.op_impl(name)(*jargs, **attrs)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32),
                               rtol=1e-5, atol=1e-5)
