"""t01 — time-varying MPC (analogue of examples/t01_time_varying_MPC.m):
per-call model data with online band-Cholesky refactorization, warm starts
across a receding horizon with a drifting model."""

import numpy as np
import spcies_tpu as sp


def main():
    sys, param, st = sp.systems.tester_fixture()
    param = dict(param)
    param["T"] = np.diag(np.sum(param["T"], axis=1))

    opt = sp.default_options("laxMPC", "ADMM", rho=15.0, tol=1e-5,
                             k_max=2000)
    opt.time_varying = True
    solver = sp.make_solver(sys, param, formulation="laxMPC",
                            method="ADMM", options=opt)

    A0, B0 = np.asarray(sys["A"]), np.asarray(sys["B"])
    Qd, Rd = np.diag(param["Q"]), np.diag(param["R"])
    LB = np.concatenate([sys["LBx"], sys["LBu"]])
    UB = np.concatenate([sys["UBx"], sys["UBu"]])

    x = np.asarray(st["x"], float)
    init = None
    for t in range(10):
        A_t = A0 * (1.0 - 0.005 * t)      # slowly drifting model
        res = solver(x, st["xr"], st["ur"], A_t, B0, Qd, Rd, LB, UB,
                     init=init)
        u = np.asarray(res.u[0])
        x = A_t @ x + B0 @ u
        init = (res.sol["z"], res.sol["v"], res.sol["lam"])
        print(f"t={t}: k={int(res.k[0])} e={int(res.e_flag[0])} "
              f"|x|={np.linalg.norm(x):.4f}")


if __name__ == "__main__":
    import jax
    jax.config.update("jax_enable_x64", True)   # precision='double'
    main()
