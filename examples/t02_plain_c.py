"""t02 — plain-C solvers (analogue of examples/t02_plain_C_solvers.m +
cl_in_C/main_cl_in_C.c): generate a self-contained embedded C solver,
compile it, and run a closed loop through the ctypes bridge."""

import numpy as np
import spcies_tpu as sp
from spcies_tpu.codegen import generate_c_solver, CompiledCSolver


def main():
    sys, param, st = sp.systems.tester_fixture()
    param = dict(param)
    param["T"] = np.diag(np.sum(param["T"], axis=1))

    path = generate_c_solver(sys, param, formulation="laxMPC",
                             rho=15.0, tol=1e-5, k_max=2000)
    print("generated:", path)

    c = CompiledCSolver("laxmpc_admm", n=6, m=2, nz=80)
    A, B = np.asarray(sys["A"]), np.asarray(sys["B"])
    x = np.asarray(st["x"]) * 3.0
    for t in range(15):
        u, k, e, sol = c(x, st["xr"], st["ur"])
        x = A @ x + B @ u
    print("closed loop via C: |x - xr| =",
          round(float(np.linalg.norm(x - st["xr"])), 6),
          " last solve:", k, "iters,", round(sol["run_time_ms"], 3), "ms")




def embedded_tour():
    """Every solver triple has an embedded-C path through the unified
    dispatcher; also build the pure-C closed-loop executable
    (main_cl_in_C.c analogue)."""
    import subprocess
    import tempfile
    from spcies_tpu.codegen import generate_embedded_solver, generate_cl_demo

    sys, param, st = sp.systems.tester_fixture()
    d = tempfile.mkdtemp(prefix="spcies_c_")

    p = dict(param)
    p["T"] = 10.0 * np.asarray(p["Q"])
    p["S"] = np.asarray(p["R"]).copy()
    path = generate_embedded_solver(sys, p, formulation="MPCT",
                                    method="ADMM", submethod="cs",
                                    directory=d, tol=1e-5, k_max=2000)
    print("MPCT-ADMM-cs C:", path)

    p2 = dict(param)
    p2["T"] = np.diag(np.sum(np.asarray(p2["T"]), axis=1))
    exe = generate_cl_demo(sys, p2, formulation="laxMPC",
                           x_init=np.asarray(st["x"]) * 3.0, steps=10,
                           directory=d, rho=15.0, tol=1e-5, k_max=2000)
    out = subprocess.run([exe], capture_output=True, text=True, timeout=60)
    print("pure-C closed loop:", out.stdout.strip().splitlines()[-1])


if __name__ == "__main__":
    import jax
    jax.config.update("jax_enable_x64", True)   # precision='double'
    main()
    embedded_tour()
