"""Differential tests for ellipHMPC-ADMM (coupled-output harmonic MPC).

The reference harness does not cover this solver (SURVEY.md §4) and ships
no MATLAB mirror for it; the oracle here is the in-repo dense mirror of the
generated C (code_ellipHMPC_ADMM_C.c)."""

import numpy as np
import pytest

import spcies_tpu as sp
from spcies_tpu.oracle import elliphmpc_admm_oracle


@pytest.fixture(scope="module")
def fixture():
    sys, param, status = sp.systems.tester_fixture()
    sys = dict(sys)
    n, m = len(status["x"]), 2
    # coupled outputs: the three mass positions
    sys["E"] = np.eye(3, n)
    sys["F"] = np.zeros((3, m))
    sys["LBy"] = -0.3 * np.ones(3)
    sys["UBy"] = 0.3 * np.ones(3)
    param = dict(param)
    param.pop("T", None)
    param["w"] = 3 * 1.627 * 0.2
    param["Te"] = 10 * param["N"] * np.asarray(param["Q"])
    param["Th"] = param["Te"]
    param["Se"] = np.asarray(param["R"]).copy()
    param["Sh"] = 0.5 * param["Se"]
    return sys, param, status


OPTS = dict(rho=2.0, sigma=0.01, tol_p=1e-7, tol_d=1e-7, k_max=5000)


def _refs(st):
    """Decomposed harmonic references: offset = (xr, ur), zero sine/cosine
    components."""
    xr, ur = st["xr"], st["ur"]
    zn, zm = np.zeros_like(xr), np.zeros_like(ur)
    return (st["x"], xr, zn, zn, ur, zm, zm)


@pytest.mark.parametrize("use_soc", [False, True])
def test_vs_oracle(fixture, use_soc):
    sys, param, st = fixture
    s = sp.make_solver(sys, param, formulation="ellipHMPC", method="ADMM",
                       use_soc=use_soc, **OPTS)
    args = _refs(st)
    res = s(*args)
    u_o, k_o, e_o, sol_o = elliphmpc_admm_oracle(
        sys, param, *args, use_soc=use_soc, **OPTS)
    assert int(res.e_flag[0]) == e_o == 1
    assert int(res.k[0]) == k_o
    for key in ("z", "s", "lam"):
        assert np.max(np.abs(np.asarray(res.sol[key][0]) - sol_o[key])) < 1e-8
    assert np.max(np.abs(np.asarray(res.u[0]) - u_o)) < 1e-8


def test_output_constraints_hold(fixture):
    """Stage outputs y_i = E x_i + F u_i must respect LBy/UBy at the
    solution (via the slack representation s = d - C z)."""
    sys, param, st = fixture
    s = sp.make_solver(sys, param, formulation="ellipHMPC", method="ADMM",
                       **OPTS)
    res = s(*_refs(st))
    z = np.asarray(res.sol["z"][0])
    n, m, N = s.n, s.m, s.N
    E, F = np.asarray(sys["E"]), np.asarray(sys["F"])
    tol = 1e-5
    # stages 1..N-1
    for l in range(1, N):
        x_l = z[m + (l - 1) * (n + m): m + (l - 1) * (n + m) + n]
        u_l = z[m + (l - 1) * (n + m) + n: m + l * (n + m)]
        y = E @ x_l + F @ u_l
        assert np.all(y <= sys["UBy"] + tol)
        assert np.all(y >= sys["LBy"] - tol)


def test_harmonic_amplitude_in_dset(fixture):
    """The harmonic output (ye, ys, yc) per constrained output must satisfy
    the sigma-tightened D-set: ||(ys, yc)|| <= min(ye - LBy, UBy - ye)."""
    sys, param, st = fixture
    s = sp.make_solver(sys, param, formulation="ellipHMPC", method="ADMM",
                       **OPTS)
    res = s(*_refs(st))
    assert int(res.e_flag[0]) == 1
    z = np.asarray(res.sol["z"][0])
    n, m, N = s.n, s.m, s.N
    ns = (N - 1) * (n + m) + m
    E, F = np.asarray(sys["E"]), np.asarray(sys["F"])
    xe, xs, xc = (z[ns:ns + n], z[ns + n:ns + 2 * n],
                  z[ns + 2 * n:ns + 3 * n])
    ue, us, uc = (z[ns + 3 * n:ns + 3 * n + m],
                  z[ns + 3 * n + m:ns + 3 * n + 2 * m],
                  z[ns + 3 * n + 2 * m:])
    sig, tol = OPTS["sigma"], 1e-5
    for j in range(3):
        ye = E[j] @ xe + F[j] @ ue
        amp = np.hypot(E[j] @ xs + F[j] @ us, E[j] @ xc + F[j] @ uc)
        assert amp <= ye - (sys["LBy"][j] + sig) + tol
        assert amp <= (sys["UBy"][j] - sig) - ye + tol


