"""t04 — development workflow (analogue of
examples/t04_dev_solver_versions.m): compare a batched solver against
its dense numpy oracle mirror, the differential pattern every in-repo
formulation follows."""

import numpy as np
import spcies_tpu as sp
from spcies_tpu.oracle import laxmpc_admm_oracle


def main():
    sys, param, st = sp.systems.tester_fixture()
    param = dict(param)
    param["T"] = np.diag(np.sum(param["T"], axis=1))
    opts = dict(rho=15.0, tol=1e-7, k_max=5000)

    solver = sp.make_solver(sys, param, formulation="laxMPC",
                            method="ADMM", **opts)
    res = solver(st["x"], st["xr"], st["ur"])
    u_o, k_o, e_o, sol_o = laxmpc_admm_oracle(
        sys, param, st["x"], st["xr"], st["ur"], **opts)

    print("iterations: solver", int(res.k[0]), " oracle", k_o)
    for key in ("z", "v", "lam"):
        gap = float(np.max(np.abs(np.asarray(res.sol[key][0])
                                  - sol_o[key])))
        print(f"gap[{key}] = {gap:.2e}")


if __name__ == "__main__":
    import jax
    jax.config.update("jax_enable_x64", True)   # precision='double'
    main()
