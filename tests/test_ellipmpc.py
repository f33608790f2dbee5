"""Differential tests for ellipMPC (ADMM + ADMM-soc), replicating
tests/test_ellipMPC_ADMM.m / test_ellipMPC_ADMM_soc.m: P=I, c=xr, r=0
(degenerate ellipsoid -> x_N = xr), golden optimum, oracle differential."""

import numpy as np
import pytest

import spcies_tpu as sp
from spcies_tpu.oracle import ellipmpc_admm_oracle, ellipmpc_admm_soc_oracle
from tests.golden.ellipmpc_golden import Z_OPT


@pytest.fixture(scope="module")
def fixture():
    sys, param, status = sp.systems.tester_fixture()
    param = dict(param)
    # test_ellipMPC_ADMM.m:15-20
    param["T"] = np.diag(np.sum(param["T"], axis=1))
    param["P"] = np.eye(len(status["xr"]))
    param["c"] = status["xr"]
    param["r"] = 0.0
    return sys, param, status


ADMM_OPTS = dict(rho=15.0, tol=1e-7, k_max=5000)
SOC_OPTS = dict(rho=15.0, sigma=10.0, tol_p=1e-7, tol_d=1e-7, k_max=5000)


@pytest.fixture(scope="module", params=["dense", "banded"])
def admm_solver(request, fixture):
    sys, param, _ = fixture
    return sp.make_solver(sys, param, formulation="ellipMPC", method="ADMM",
                          backend=request.param, **ADMM_OPTS)


@pytest.fixture(scope="module")
def soc_solver(fixture):
    sys, param, _ = fixture
    return sp.make_solver(sys, param, formulation="ellipMPC", method="ADMM",
                          submethod="soc", **SOC_OPTS)


def test_admm_vs_golden(admm_solver, fixture):
    _, _, st = fixture
    res = admm_solver(st["x"], st["xr"], st["ur"])
    assert int(res.e_flag[0]) == 1
    assert np.max(np.abs(np.asarray(res.sol["z"][0]) - Z_OPT)) <= 1e-4


def test_admm_vs_oracle(admm_solver, fixture):
    sys, param, st = fixture
    res = admm_solver(st["x"], st["xr"], st["ur"])
    u_o, k_o, e_o, sol_o = ellipmpc_admm_oracle(
        sys, param, st["x"], st["xr"], st["ur"], **ADMM_OPTS)
    assert int(res.e_flag[0]) == e_o == 1
    assert int(res.k[0]) == k_o
    for key in ("z", "v", "lam"):
        assert np.max(np.abs(np.asarray(res.sol[key][0]) - sol_o[key])) < 1e-9
    assert np.max(np.abs(np.asarray(res.u[0]) - u_o)) < 1e-9


def test_admm_vector_rho_vs_oracle(fixture):
    """Vector rho (compute_ellipMPC_ADMM_ingredients.m:68-77): varying
    per-stage entries, constant over the terminal block (the only
    well-formed layout — see formulations/ellipmpc.py)."""
    sys, param, st = fixture
    n = len(st["xr"])
    nz = param["N"] * (n + sys["B"].shape[1])
    rng = np.random.default_rng(7)
    rho_vec = 15.0 * (1.0 + 0.5 * rng.random(nz))
    rho_vec[nz - n:] = 20.0
    opts = dict(ADMM_OPTS, rho=rho_vec)
    solver = sp.make_solver(sys, param, formulation="ellipMPC",
                            method="ADMM", **opts)
    res = solver(st["x"], st["xr"], st["ur"])
    u_o, k_o, e_o, sol_o = ellipmpc_admm_oracle(
        sys, param, st["x"], st["xr"], st["ur"], **opts)
    assert int(res.e_flag[0]) == e_o == 1
    assert int(res.k[0]) == k_o
    for key in ("z", "v", "lam"):
        assert np.max(np.abs(np.asarray(res.sol[key][0]) - sol_o[key])) < 1e-9
    # force_vector_rho on a scalar (the reference's exercised vector path)
    # must agree with the scalar build
    s_vec = sp.make_solver(sys, param, formulation="ellipMPC", method="ADMM",
                           force_vector_rho=True, **ADMM_OPTS)
    s_sc = sp.make_solver(sys, param, formulation="ellipMPC", method="ADMM",
                          **ADMM_OPTS)
    rv = s_vec(st["x"], st["xr"], st["ur"])
    rs = s_sc(st["x"], st["xr"], st["ur"])
    assert int(rv.k[0]) == int(rs.k[0])
    assert np.max(np.abs(np.asarray(rv.sol["z"] - rs.sol["z"]))) < 1e-12


def test_admm_vector_rho_nonconstant_terminal_raises(fixture):
    """A rho vector varying inside the terminal block makes the reference's
    rho.*blkdiag(I,P) row scaling non-symmetric — must raise, not build."""
    sys, param, st = fixture
    n = len(st["xr"])
    nz = param["N"] * (n + sys["B"].shape[1])
    rho_vec = np.full(nz, 15.0)
    rho_vec[-1] = 30.0
    with pytest.raises(ValueError, match="terminal"):
        sp.make_solver(sys, param, formulation="ellipMPC", method="ADMM",
                       rho=rho_vec, tol=1e-7, k_max=100)


def test_admm_terminal_in_ellipsoid(fixture):
    """With a nondegenerate ellipsoid (r>0) the terminal iterate of v must
    satisfy (v_N - c)' P (v_N - c) <= r^2 (+ tol slack)."""
    sys, param, st = fixture
    param = dict(param)
    param["r"] = 0.05
    s = sp.make_solver(sys, param, formulation="ellipMPC", method="ADMM",
                       **ADMM_OPTS)
    res = s(st["x"], st["xr"], st["ur"])
    v = np.asarray(res.sol["v"][0])
    n = s.n
    d = v[-n:] - param["c"]
    assert d @ (param["P"] @ d) <= param["r"] ** 2 + 1e-8


def test_soc_vs_golden(soc_solver, fixture):
    _, _, st = fixture
    res = soc_solver(st["x"], st["xr"], st["ur"])
    assert int(res.e_flag[0]) == 1
    z = np.asarray(res.sol["z"][0])
    assert np.max(np.abs(z[:len(Z_OPT)] - Z_OPT)) <= 1e-4


def test_soc_vs_oracle(soc_solver, fixture):
    sys, param, st = fixture
    res = soc_solver(st["x"], st["xr"], st["ur"])
    u_o, k_o, e_o, sol_o = ellipmpc_admm_soc_oracle(
        sys, param, st["x"], st["xr"], st["ur"], **SOC_OPTS)
    assert int(res.e_flag[0]) == e_o == 1
    assert int(res.k[0]) == k_o
    for key in ("z", "s", "lam", "mu"):
        assert np.max(np.abs(np.asarray(res.sol[key][0]) - sol_o[key])) < 1e-9
    assert np.max(np.abs(np.asarray(res.u[0]) - u_o)) < 1e-9


def test_soc_runtime_radius(soc_solver, fixture):
    """The soc variant's radius is a runtime input (4th argument,
    code_ellipMPC_ADMM_soc_C.c:20): different radii must give different
    terminal states, matching the oracle at each radius."""
    sys, param, st = fixture
    for r in (0.0, 0.3):
        res = soc_solver(st["x"], st["xr"], st["ur"], np.array([r]))
        u_o, k_o, e_o, _ = ellipmpc_admm_soc_oracle(
            sys, param, st["x"], st["xr"], st["ur"], r, **SOC_OPTS)
        assert int(res.k[0]) == k_o
        assert np.max(np.abs(np.asarray(res.u[0]) - u_o)) < 1e-9


def test_admm_batched_masking(admm_solver, fixture):
    _, _, st = fixture
    rng = np.random.default_rng(4)
    B = 4
    x0s = st["x"][None, :] * rng.uniform(-2.0, 2.0, size=(B, 1))
    batched = admm_solver(x0s, np.tile(st["xr"], (B, 1)),
                          np.tile(st["ur"], (B, 1)))
    for i in range(B):
        solo = admm_solver(x0s[i], st["xr"], st["ur"])
        assert int(batched.k[i]) == int(solo.k[0])
        np.testing.assert_allclose(np.asarray(batched.sol["z"][i]),
                                   np.asarray(solo.sol["z"][0]),
                                   rtol=0, atol=1e-12)
