"""The port's single-rounding multiply-add (x265_tpu_torch.ops.fma.fma32)
against exact rational arithmetic, and the helper the cost-plane
parity tests use to read the reference's float32 costs.

The reference's jitted float32 RD costs round `a + b * c` once where
the compiler fuses the multiply into the add; the port reproduces that
with fma32. Tolerance: exact equality of the float32 bits."""

from fractions import Fraction

import numpy as np
import pytest
import torch

from x265_tpu_torch.ops.fma import fma32


def _exact_f32(a, b, c) -> np.float32:
    """a + b * c rounded once to float32, ties to even, from the exact
    rational value."""
    ex = Fraction(float(a)) + Fraction(float(b)) * Fraction(float(c))
    f = np.float32(float(ex))
    cands = (np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf)))
    return min(cands, key=lambda x: (abs(Fraction(float(x)) - ex),
                                     int(np.array(x).view(np.int32)) & 1))


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def test_fma32_rounds_once_on_seeded_values():
    rng = np.random.default_rng(0)
    n = 3000
    a = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 9, n)) \
        .astype(np.float32)
    b = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 5, n)) \
        .astype(np.float32)
    c = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 5, n)) \
        .astype(np.float32)
    # RD-cost magnitudes too: SSE + lambda2 * bits
    a[:500] = rng.integers(0, 1 << 26, 500).astype(np.float32)
    b[:500] = np.float32(rng.uniform(1, 400))
    c[:500] = (rng.integers(0, 4000, 500) * 0.1).astype(np.float32)
    got = fma32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    want = np.array([_exact_f32(x, y, z) for x, y, z in zip(a, b, c)],
                    np.float32)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the product rounded first differs often: the test can tell
    assert (_bits(a + b * c) != _bits(want)).sum() > 100


@pytest.mark.parametrize("sign", (1.0, -1.0))
def test_fma32_halfway_cases(sign):
    """Where the float64 sum lands exactly on a float32 halfway point
    the exact value does not, a float64 add and a cast round twice and
    miss; fma32 does not. Also exact halfway points (ties to even), a
    python-float operand and a sum that cancels to zero."""
    cases = [
        # exact value just below the halfway point 2^40 + 2^17 + 2^16
        (sign * (2.0 ** 40 + 2.0 ** 17), sign * 2.0 ** 8 * (1 + 2.0 ** -23),
         2.0 ** 8 * (1 - 2.0 ** -23)),
        # exact halfway points, both ties
        (1.0, 2.0 ** -24, 1.0), (1.0 + 2.0 ** -23, 2.0 ** -24, 1.0),
        (sign * 3.0, -sign * 1.5, 2.0),
    ]
    for a, b, c in cases:
        a32, b32, c32 = (np.float32(v) for v in (a, b, c))
        want = _exact_f32(a32, b32, c32)
        got = fma32(torch.tensor([a32]), torch.tensor([b32]),
                    torch.tensor([c32]))
        assert _bits(got.numpy()[0]) == _bits(want), (a, b, c)
        got_py = fma32(torch.tensor([a32]), float(b32), torch.tensor([c32]))
        assert _bits(got_py.numpy()[0]) == _bits(want)
    a, b, c = cases[0]
    double = np.float32(np.float64(np.float32(a)) + np.float64(np.float32(b))
                        * np.float64(np.float32(c)))
    assert _bits(double) != _bits(_exact_f32(*(np.float32(v)
                                                for v in (a, b, c))))


def float_comparison_operands(fn, *args, argmin: bool = False):
    """Run fn (a JAX function of array pytrees) jitted, returning its
    outputs and the operands of every float32 `<` / `<=` comparison at
    the top level of its program, in trace order: the cost planes each
    decision compares, read from the reference's own program (the
    comparison's operands become extra outputs of the same jaxpr).
    argmin: also the operand of every float32 argmin (the stacked costs
    of a first-index choice, e.g. RDOQ's level candidates)."""
    import jax
    import jax.extend.core as jc
    import jax.numpy as jnp
    flat, tree = jax.tree.flatten(args)
    closed, shapes = jax.make_jaxpr(
        lambda *fl: fn(*jax.tree.unflatten(tree, fl)), return_shape=True)(
        *flat)
    jp = closed.jaxpr
    prims = ("lt", "le", "argmin") if argmin else ("lt", "le")
    extra = [v for e in jp.eqns if e.primitive.name in prims
             and e.invars[0].aval.dtype == jnp.float32
             for v in e.invars if isinstance(v, jc.Var)]
    run = jax.jit(jc.jaxpr_as_fun(jc.ClosedJaxpr(
        jp.replace(outvars=list(jp.outvars) + extra), closed.consts)))
    res = run(*flat)
    n = len(jp.outvars)
    outs = jax.tree.unflatten(jax.tree.structure(shapes), res[:n])
    return outs, [np.asarray(r) for r in res[n:]]


def assert_same_bits(want, got, what):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32).reshape(want.shape)
    bad = int((_bits(want) != _bits(got)).sum())
    assert bad == 0, f"{what}: {bad} of {want.size} cells differ"
