"""t03 — real systems in engineering units (analogue of
examples/t03_real_systems.m): Duffing oscillator linearized about an
operating point, scaled with scale_ss, controlled in engineering units."""

import numpy as np
import spcies_tpu as sp
from spcies_tpu.systems import duffing_ode, duffing_to_ss, scale_ss
from spcies_tpu.utils import linalg

D = dict(alpha=-1.0, beta=1.0, delta=0.3, gamma=1.0)


def main():
    x_op = np.array([0.0, 1.0])
    u_op = np.array([D["alpha"] + D["beta"]])   # equilibrium input at x_op
    Ac, Bc = duffing_to_ss(x_op, u_op, **D)
    Ts = 0.1
    A, B = linalg.c2d_zoh(Ac, Bc, Ts)
    scaled = scale_ss(A, B, UBx=x_op + 0.5, LBx=x_op - 0.5,
                      UBu=u_op + 1.0, LBu=u_op - 1.0,
                      x0=x_op, u0=u_op,
                      Nx=np.array([2.0, 0.5]), Nu=np.array([4.0]))
    param = dict(Q=np.diag([1.0, 10.0]), R=np.eye(1),
                 T=np.diag([5.0, 50.0]), N=12)
    opt = sp.default_options("laxMPC", "ADMM", rho=1.0, tol=1e-5,
                             k_max=5000)
    opt.in_engineering = True
    solver = sp.make_solver(scaled, param, formulation="laxMPC",
                            method="ADMM", options=opt)

    x = x_op + np.array([0.1, -0.2])
    for t in range(80):
        res = solver(x, x_op, u_op)           # engineering units in & out
        u = float(np.asarray(res.u[0])[0])
        f = lambda xx: duffing_ode(0.0, xx, u, **D)
        k1 = f(x); k2 = f(x + Ts / 2 * k1)
        k3 = f(x + Ts / 2 * k2); k4 = f(x + Ts * k3)
        x = x + Ts / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    print("|x - x_op| after 8 s:", round(float(np.linalg.norm(x - x_op)), 4))


if __name__ == "__main__":
    import jax
    jax.config.update("jax_enable_x64", True)   # precision='double'
    main()
