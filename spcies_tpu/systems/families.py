"""The 13 solver triples on the oscillating-masses tester plant, as the
benchmark and the GPU smoke run drive them.

Each case carries the triple's problem data, its solver settings and the
fp64 oracle it is checked against. rho/sigma are tuned per horizon on
this workload (fp32 iteration-count probes, all lanes converged): a
first-order method's best penalty shifts with the horizon, and the N=10
settings run 4-10x more iterations at N=30 (e.g. equMPC rho=0.5: k=36 at
N=10 but k=1954 at N=30; rho=6 with relaxation: k=136). Horizons of 30
and longer use the N=30 settings.

Lanes: x0 = x_fixture * U(-2, 2) per lane (one scale per lane), fixed
references; the ellipHMPC case adds per-lane sinusoidal position
references that exceed its coupled-output bounds, so its cone is binding.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from spcies_tpu import oracle
from spcies_tpu.systems.oscillating_masses import tester_fixture

TOL = 1e-4     # reference default tolerance (def_options_laxMPC_ADMM.m)


@dataclasses.dataclass
class Case:
    name: str
    formulation: str
    method: str
    submethod: str
    sys: dict
    param: dict
    solver: dict               # solver options (rho, tol, k_max, ...)
    banded: bool               # has an O(N) banded backend
    inputs: Callable           # inputs(lanes) -> tuple of [B, .] arrays
    oracle: Callable           # oracle(*one_lane_inputs, **overrides)
                               #   -> (u [m], k, e_flag, sol)

    def make(self, backend="dense", precision="float", **overrides):
        """Build the case's solver through make_solver."""
        from spcies_tpu.api import make_solver
        from spcies_tpu.config import default_options
        o = default_options(self.formulation, self.method, self.submethod,
                            **{**self.solver, **overrides})
        o.precision = precision
        return make_solver(self.sys, self.param,
                           formulation=self.formulation, method=self.method,
                           submethod=self.submethod, options=o,
                           backend=backend)


def lane_states(B: int, seed: int = 0):
    """[B, n] initial states, [B, n] and [B, m] references of the tester
    fixture: x0 = x_fixture * U(-2, 2), one scale per lane."""
    _, _, st = tester_fixture()
    rng = np.random.default_rng(seed)
    x0 = np.asarray(st["x"])[None, :] * rng.uniform(-2.0, 2.0, (B, 1))
    return (x0, np.tile(st["xr"], (B, 1)), np.tile(st["ur"], (B, 1)))


def cases(N: int, *, seed: int = 0) -> list[Case]:
    """The 13 triples at horizon N."""
    sys_, param, st = tester_fixture()
    param = dict(param)
    param["N"] = int(N)
    n30 = N >= 30
    n_x, m_u = len(st["x"]), len(st["ur"])
    o_kmax = 10000             # oracle budget: run the reference to its exit

    def plain(lanes):
        return lane_states(lanes, seed)

    out = []

    def add(name, f, m, sm, par, solver, banded, inputs, ofn, okw,
            sys_c=sys_):
        def call(*a, _p=par, _s=sys_c, **kw):
            return ofn(_s, _p, *a, **{**okw, **kw})
        out.append(Case(name, f, m, sm, sys_c, par, solver, banded, inputs,
                        call))

    pL = dict(param)
    add("laxMPC-ADMM", "laxMPC", "ADMM", "", pL,
        dict(rho=10.0, tol=TOL, k_max=1000, relax_alpha=1.9), True, plain,
        oracle.laxmpc_admm_oracle, dict(rho=10.0, tol=TOL, k_max=o_kmax))
    pT = dict(param)
    pT["T"] = np.diag(np.sum(np.asarray(param["T"]), axis=1))
    add("laxMPC-FISTA", "laxMPC", "FISTA", "", pT,
        dict(tol=TOL, k_max=4000, restart=True), True, plain,
        oracle.laxmpc_fista_oracle, dict(tol=TOL, k_max=o_kmax))
    pE = dict(param)
    pE.pop("T", None)
    rho_equ = dict(rho=6.0, relax_alpha=1.8) if n30 else dict(rho=0.5)
    add("equMPC-ADMM", "equMPC", "ADMM", "", pE,
        dict(tol=TOL, k_max=4000, **rho_equ), True, plain,
        oracle.equmpc_admm_oracle,
        dict(rho=rho_equ["rho"], tol=TOL, k_max=o_kmax))
    add("equMPC-FISTA", "equMPC", "FISTA", "", pE,
        dict(tol=TOL, k_max=4000), True, plain,
        oracle.equmpc_fista_oracle, dict(tol=TOL, k_max=o_kmax))
    pM = dict(param)
    pM["T"] = 10.0 * np.asarray(param["Q"])
    pM["S"] = np.asarray(param["R"]).copy()
    add("MPCT-EADMM", "MPCT", "EADMM", "", pM,
        dict(rho_base=2.0, rho_mult=20.0, tol=TOL, k_max=5000), False, plain,
        oracle.mpct_eadmm_oracle,
        dict(rho_base=2.0, rho_mult=20.0, tol=TOL, k_max=o_kmax))
    add("MPCT-ADMM-cs", "MPCT", "ADMM", "cs", pM,
        dict(rho=2.0, tol=TOL, k_max=4000), True, plain,
        oracle.mpct_admm_cs_oracle, dict(rho=2.0, tol=TOL, k_max=o_kmax))
    add("MPCT-ADMM-semiband", "MPCT", "ADMM", "semiband", pM,
        dict(rho=0.5, tol_p=TOL, tol_d=TOL, k_max=5000), True, plain,
        oracle.mpct_admm_semiband_oracle,
        dict(rho=0.5, tol_p=TOL, tol_d=TOL, k_max=o_kmax))
    pC = dict(param)
    pC["T"] = np.diag(np.sum(np.asarray(param["T"]), axis=1))
    pC["P"] = np.eye(n_x)
    pC["c"] = np.asarray(st["xr"])
    pC["r"] = 0.5
    rho_ellip = 5.0 if n30 else 3.0
    add("ellipMPC-ADMM", "ellipMPC", "ADMM", "", pC,
        dict(rho=rho_ellip, tol=TOL, k_max=4000), True, plain,
        oracle.ellipmpc_admm_oracle,
        dict(rho=rho_ellip, tol=TOL, k_max=o_kmax))

    def with_radius(lanes):
        return plain(lanes) + (np.full((lanes, 1), 0.5),)
    add("ellipMPC-ADMM-soc", "ellipMPC", "ADMM", "soc", pC,
        dict(rho=5.0, sigma=4.0, tol_p=TOL, tol_d=TOL, k_max=5000), False,
        with_radius, oracle.ellipmpc_admm_soc_oracle,
        dict(rho=5.0, sigma=4.0, tol_p=TOL, tol_d=TOL, k_max=o_kmax))
    pH = dict(param)
    pH.pop("T", None)
    pH["w"] = 3 * 1.627 * 0.2
    pH["Te"] = 10 * pH["N"] * np.asarray(pH["Q"])
    pH["Th"] = pH["Te"]
    pH["Se"] = np.asarray(pH["R"]).copy()
    pH["Sh"] = 0.5 * pH["Se"]
    rho_h = 5.0 if n30 else 2.0
    add("HMPC-ADMM", "HMPC", "ADMM", "", pH,
        dict(rho=rho_h, sigma=20.0, tol_p=TOL, tol_d=TOL, k_max=5000), True,
        plain, oracle.hmpc_admm_oracle,
        dict(rho=rho_h, tol_p=TOL, tol_d=TOL, k_max=o_kmax))
    for meth, sym in (("ADMM", False), ("SADMM", True)):
        add(f"HMPC-{meth}-split", "HMPC", meth, "split", pH,
            dict(rho=rho_h, sigma=rho_h, tol_p=TOL, tol_d=TOL, k_max=4000),
            True, plain, oracle.hmpc_split_oracle,
            dict(rho=rho_h, sigma=rho_h, tol_p=TOL, tol_d=TOL,
                 k_max=o_kmax, symmetric=sym))
    sysE = dict(sys_)
    sysE["E"] = np.eye(3, n_x)
    sysE["F"] = np.zeros((3, m_u))
    sysE["LBy"] = -0.1 * np.ones(3)
    sysE["UBy"] = 0.1 * np.ones(3)
    pH2 = dict(pH)
    pH2["Te"] = pH2["N"] * np.asarray(pH["Q"])
    pH2["Th"] = pH2["Te"]

    def harmonic(lanes):
        x0, xr, ur = plain(lanes)
        amp = np.random.default_rng(seed + 1).uniform(
            0.5, 1.0, (lanes, 1)) * 0.25
        xrs = np.zeros((lanes, n_x))
        xrs[:, :3] = amp
        xrc = np.zeros((lanes, n_x))
        xrc[:, :3] = 0.5 * amp
        return (x0, xr, xrs, xrc, ur, 0.1 * np.ones((lanes, m_u)),
                np.zeros((lanes, m_u)))
    add("ellipHMPC-ADMM", "ellipHMPC", "ADMM", "", pH2,
        dict(rho=200.0, sigma=0.01, tol_p=TOL, tol_d=TOL, k_max=5000), False,
        harmonic, oracle.elliphmpc_admm_oracle,
        dict(rho=200.0, sigma=0.01, tol_p=TOL, tol_d=TOL, k_max=o_kmax),
        sys_c=sysE)
    return out
