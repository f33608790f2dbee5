"""No f32 product of a solve runs at reduced precision.

At the default precision a GPU runs an f32 product in TF32. The delta-form
products (z_{k+1} = z_k + M dq_k) then carry every product's rounding error
into z: on an H100 the headline's z ends about 8x further from the fp64
optimum than on the CPU, and per-lane exits change with the batch shape
(PERF.md). Every f32 dot_general of every triple's traced solve must
therefore ask for HIGHEST, as BatchedSolver.__call__ traces it. Only
bf16_delta's products take bf16 operands, by choice."""

import jax
import jax.numpy as jnp
import pytest
from jax.extend import core as jcore

from spcies_tpu.systems import families

CASES = {c.name: c for c in families.cases(10)}
PAIRS = [(name, be) for name, c in CASES.items()
         for be in (("dense", "banded") if c.banded else ("dense",))]


def _dots(jaxpr, out):
    """(operand dtypes, precision) of every dot_general, sub-jaxprs
    (loop bodies, branches, nested jits) included."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append((tuple(v.aval.dtype for v in eqn.invars),
                        eqn.params["precision"]))
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(sub, jcore.ClosedJaxpr):
                    _dots(sub.jaxpr, out)
                elif isinstance(sub, jcore.Jaxpr):
                    _dots(sub, out)
    return out


def _solve_dots(solver, inputs):
    args = [jnp.asarray(a, jnp.float32) for a in inputs]
    with jax.default_matmul_precision("highest"):
        jaxpr = jax.make_jaxpr(
            lambda *a: solver.raw_fn(*a, None, None))(*args)
    return _dots(jaxpr.jaxpr, [])


@pytest.mark.parametrize("name,backend", PAIRS)
def test_f32_products_run_at_highest(name, backend):
    case = CASES[name]
    dots = _solve_dots(case.make(backend), case.inputs(4))
    assert dots, "the solve traced no product"
    highest = (jax.lax.Precision.HIGHEST,) * 2
    low = [p for dtypes, p in dots
           if jnp.float32 in dtypes and p != highest]
    assert not low, f"{len(low)} f32 products below HIGHEST: {low[:3]}"


def test_bf16_delta_products_take_bf16_operands():
    """bf16_delta is the one opt-in exception: its hot products read bf16
    operands (and accumulate in f32)."""
    case = CASES["laxMPC-ADMM"]
    dots = _solve_dots(case.make("dense", bf16_delta=True), case.inputs(4))
    assert any(dtypes == (jnp.bfloat16, jnp.bfloat16)
               for dtypes, _ in dots)
