"""t05 — the serving pattern: on-device closed-loop rollout with the
shifted warm start.

The reference's closed-loop demos step host <-> solver once per control
period (examples/cl_in_C/main_cl_in_C.c:60-115). Here the whole
receding-horizon loop — solve, apply u0, propagate, warm-start the next
solve — runs as ONE jitted lax.scan over control steps, batched over
thousands of independent loops, with zero host round trips.

warm_start="shift" advances the previous (z, v, lam) one stage and
duplicates the tail before seeding the next solve (the apparatus the
reference computed but never used, compute_MPCT_EADMM_ingredients.m:
157-193). Measured on the N=30 bench workload: ~95% fewer iterations per
step than cold start and zero fp32 convergence-floor failures — the
unshifted carry is actually WORSE than cold (docs/solve.md).
"""

import numpy as np
import spcies_tpu as sp
from spcies_tpu.runtime import closed_loop_rollout


def main():
    sys, param, st = sp.systems.tester_fixture()
    p30 = dict(param)
    p30["N"] = 30

    opts = sp.default_options("laxMPC", "ADMM", rho=10.0, tol=1e-4,
                              k_max=1000, relax_alpha=1.9)
    opts.precision = "float"          # the fp32 production path
    solver = sp.make_solver(sys, p30, formulation="laxMPC", method="ADMM",
                            options=opts)

    A, B = np.asarray(sys["A"]), np.asarray(sys["B"])
    Bz = 256                          # 256 independent closed loops
    rng = np.random.default_rng(0)
    x0 = np.asarray(st["x"])[None, :] * rng.uniform(-2.0, 2.0, (Bz, 1))

    for mode, ws in (("cold", False), ("shifted", "shift")):
        out = closed_loop_rollout(solver, A, B, x0, st["xr"], st["ur"],
                                  n_steps=40, warm_start=ws)
        ks = np.asarray(out["ks"])
        conv = float(np.mean(np.asarray(out["e_flags"]) == 1))
        errT = float(np.max(np.abs(np.asarray(out["xs"][-1])
                                   - np.asarray(st["xr"]))))
        print(f"{mode:8s} k/step after step 0: {ks[1:].mean():6.1f}   "
              f"converged: {conv:.4f}   |x_T - xr|_inf: {errT:.2e}")


if __name__ == "__main__":
    main()
