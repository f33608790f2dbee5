"""The dense engine in fp32 against the fp64 oracle, for every triple: a
fixed iteration count, the k_max cap, warm starts and over-relaxation —
the behaviour the removed per-triple kernels were tested for, now held by
the engine that runs those triples."""

import numpy as np
import pytest

import jax.numpy as jnp

from spcies_tpu.systems import families

CASES = {c.name: c for c in families.cases(10)}


def _f32(inputs):
    return [jnp.asarray(a, jnp.float32) for a in inputs]


def _never_converge(case):
    return (dict(tol=-1.0) if "tol" in case.solver
            else dict(tol_p=-1.0, tol_d=-1.0))


@pytest.mark.parametrize("mode", ["fixed_iters", "k_max_cap"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_fp32_iterations_vs_oracle(name, mode):
    """Seven iterations in fp32 land where the fp64 oracle's seven land,
    whether the count comes from fixed_iters (k = 7, e_flag = 1) or from
    a tolerance no lane meets (k = k_max = 7, e_flag = -1)."""
    case = CASES[name]
    inputs = case.inputs(4)
    plain = dict(relax_alpha=1.0) if "relax_alpha" in case.solver else {}
    if mode == "fixed_iters":
        res = case.make("dense", **plain)(*_f32(inputs), fixed_iters=7)
        e_want = 1
    else:
        res = case.make("dense", k_max=7, **plain,
                        **_never_converge(case))(*_f32(inputs))
        e_want = -1
    assert np.all(np.asarray(res.k) == 7)
    assert np.all(np.asarray(res.e_flag) == e_want)
    key = "z" if "z" in res.sol else "z1"
    for i in range(4):
        u, k, _, sol = case.oracle(*(np.asarray(a[i]) for a in inputs),
                                   k_max=7, **_never_converge(case))
        assert k == 7
        np.testing.assert_allclose(np.asarray(res.u[i]), u, rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(res.sol[key][i]), sol[key],
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["laxMPC-ADMM", "equMPC-ADMM",
                                  "ellipMPC-ADMM", "MPCT-ADMM-cs"])
def test_fp32_warm_start(name):
    """Re-solving from a converged (z, v, lam) exits within two
    iterations at the same u."""
    case = CASES[name]
    solver = case.make("dense")
    inputs = _f32(case.inputs(8))
    cold = solver(*inputs)
    warm = solver(*inputs, init=(cold.sol["z"], cold.sol["v"],
                                 cold.sol["lam"]))
    assert np.all(np.asarray(warm.e_flag) == 1)
    assert np.all(np.asarray(warm.k) <= 2)
    np.testing.assert_allclose(np.asarray(warm.u), np.asarray(cold.u),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("alpha", [1.0, 1.9])
def test_fp32_over_relaxation(alpha):
    """Over-relaxed ADMM reaches the fp64 oracle's fixed point (u* to
    1e-3, two fp32 solves to tol 1e-4 apart), in fewer iterations than
    plain ADMM."""
    case = CASES["laxMPC-ADMM"]
    inputs = case.inputs(8)
    res = case.make("dense", relax_alpha=alpha)(*_f32(inputs))
    assert np.all(np.asarray(res.e_flag) == 1)
    k_plain = []
    for i in range(8):
        u, k, e, _ = case.oracle(*(np.asarray(a[i]) for a in inputs))
        assert e == 1
        k_plain.append(k)
        np.testing.assert_allclose(np.asarray(res.u[i]), u, rtol=0,
                                   atol=1e-3)
    if alpha > 1.0:
        assert np.mean(np.asarray(res.k)) < np.mean(k_plain)
