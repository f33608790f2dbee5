"""Differential tests for MPCT-EADMM (tests/test_MPCT_EADMM.m pattern):
tracking formulation on the oscillating-masses fixture with T=10Q, S=R."""

import numpy as np
import pytest

import spcies_tpu as sp
from spcies_tpu.oracle import mpct_eadmm_oracle
from tests.golden.mpct_eadmm_golden import Z1_OPT


@pytest.fixture(scope="module")
def fixture():
    sys, param, status = sp.systems.tester_fixture()
    param = dict(param)
    param["T"] = 10.0 * np.asarray(param["Q"])   # test_MPCT_EADMM.m:14
    param["S"] = np.asarray(param["R"]).copy()   # test_MPCT_EADMM.m:15
    return sys, param, status


OPTS = dict(rho_base=2.0, rho_mult=20.0, tol=1e-7, k_max=5000)


@pytest.fixture(scope="module")
def solver(fixture):
    sys, param, _ = fixture
    return sp.make_solver(sys, param, formulation="MPCT", method="EADMM",
                          **OPTS)


def test_vs_golden(solver, fixture):
    _, _, st = fixture
    res = solver(st["x"], st["xr"], st["ur"])
    assert int(res.e_flag[0]) == 1
    z1 = np.asarray(res.sol["z1"][0])
    assert np.max(np.abs(z1 - Z1_OPT)) <= 1e-4


def test_vs_oracle(solver, fixture):
    sys, param, st = fixture
    res = solver(st["x"], st["xr"], st["ur"])
    u_o, k_o, e_o, sol_o = mpct_eadmm_oracle(
        sys, param, st["x"], st["xr"], st["ur"], **OPTS)
    assert int(res.e_flag[0]) == e_o == 1
    assert int(res.k[0]) == k_o
    for key in ("z1", "z2", "z3", "lam"):
        assert np.max(np.abs(np.asarray(res.sol[key][0]) - sol_o[key])) < 1e-9
    assert np.max(np.abs(np.asarray(res.u[0]) - u_o)) < 1e-9


def test_artificial_reference_is_steady_state(solver, fixture):
    """(x_s, u_s) = z2 must satisfy x_s = A x_s + B u_s at convergence."""
    sys, _, st = fixture
    res = solver(st["x"], st["xr"], st["ur"])
    z2 = np.asarray(res.sol["z2"][0])
    n = solver.n
    xs, us = z2[:n], z2[n:]
    resid = np.asarray(sys["A"]) @ xs + np.asarray(sys["B"]) @ us - xs
    assert np.max(np.abs(resid)) < 1e-6


def test_batched_masking(solver, fixture):
    _, _, st = fixture
    rng = np.random.default_rng(7)
    B = 4
    x0s = st["x"][None, :] * rng.uniform(-2.0, 2.0, size=(B, 1))
    batched = solver(x0s, np.tile(st["xr"], (B, 1)),
                     np.tile(st["ur"], (B, 1)))
    for i in range(B):
        solo = solver(x0s[i], st["xr"], st["ur"])
        assert int(batched.k[i]) == int(solo.k[0])
        np.testing.assert_allclose(np.asarray(batched.sol["z1"][i]),
                                   np.asarray(solo.sol["z1"][0]),
                                   rtol=0, atol=1e-12)


def test_rho_scalar_override(fixture):
    """Passing rho= collapses to rho_base=rho, rho_mult=1
    (compute_MPCT_EADMM_ingredients.m:76-79)."""
    sys, param, st = fixture
    s = sp.make_solver(sys, param, formulation="MPCT", method="EADMM",
                       rho=2.0, tol=1e-5, k_max=5000)
    res = s(st["x"], st["xr"], st["ur"])
    u_o, k_o, e_o, _ = mpct_eadmm_oracle(
        sys, param, st["x"], st["xr"], st["ur"],
        rho_base=2.0, rho_mult=1.0, tol=1e-5, k_max=5000)
    assert int(res.k[0]) == k_o
    assert np.max(np.abs(np.asarray(res.u[0]) - u_o)) < 1e-9
