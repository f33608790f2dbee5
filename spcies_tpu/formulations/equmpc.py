"""equMPC formulation — MPC with a terminal equality constraint x_N = x_r.

    min  sum_{i=0}^{N-1} (||x_i - xr||_Q^2 + ||u_i - ur||_R^2)
    s.t. x_{i+1} = A x_i + B u_i,  x_N = x_r,  LB <= (x_i, u_i) <= UB

Same skeleton as laxMPC with the terminal state eliminated: decision vector
z = (u_0, x_1, u_1, ..., x_{N-1}, u_{N-1}), dim N(n+m) - n; no terminal
cost; the equality RHS carries x_r in its last block. Reference:
formulations/+equMPC/compute_equMPC_ADMM_ingredients.m (offline math),
code_equMPC_ADMM_C.c (ADMM loop; terminal equality enters at :351),
code_equMPC_FISTA_C.c, platforms/Matlab/spcies_equMPC_{ADMM,FISTA}_solver.m.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from spcies_tpu.config import Options
from spcies_tpu.formulations.base import (register_builder, get_sys_matrices,
                                          get_bounds)
from spcies_tpu.formulations import stagewise
from spcies_tpu.formulations.laxmpc import _make_fista_parts
from spcies_tpu.utils import linalg
from spcies_tpu.utils.projections import proj_box
from spcies_tpu.solvers.admm import admm_solve
from spcies_tpu.solvers.common import (SolveResult,
                                        hist_sol_entries,
                                        delta_dot)
from spcies_tpu.api import BatchedSolver


def _stacked_bounds(sys, n, m, N, inf_value):
    """LB/UB over z = (u_0, x_1, u_1, ..., x_{N-1}, u_{N-1}) — no terminal
    block (spcies_equMPC_ADMM_solver.m:195-196)."""
    LBx, UBx, LBu, UBu = get_bounds(sys, n, m, inf_value)
    LB = np.concatenate([LBu] + [np.concatenate([LBx, LBu])] * (N - 1))
    UB = np.concatenate([UBu] + [np.concatenate([UBx, UBu])] * (N - 1))
    return LB, UB


def equmpc_admm_ingredients(sys: dict, param: dict, opt: Options) -> dict:
    """Offline ingredients, analogue of
    compute_equMPC_ADMM_ingredients.m (decision dim N(n+m)-n :54, truncated
    Aeq :85, no T in H)."""
    A, B, n, m = get_sys_matrices(sys)
    N = int(param["N"])
    Q = np.asarray(param["Q"], dtype=float)
    R = np.asarray(param["R"], dtype=float)
    if not (np.allclose(Q, np.diag(np.diag(Q))) and
            np.allclose(R, np.diag(np.diag(R)))):
        raise ValueError("equMPC/ADMM requires diagonal Q and R "
                         "(compute_equMPC_ADMM_ingredients.m)")
    Qd, Rd = np.diag(Q).copy(), np.diag(R).copy()
    nz = N * (n + m) - n

    rho = np.asarray(opt.solver["rho"], dtype=float)
    force_vec = bool(opt.solver.get("force_vector_rho", False))
    rho_is_scalar = rho.ndim == 0 and not force_vec
    rho_vec = np.full(nz, float(rho)) if rho.ndim == 0 else rho.ravel().copy()
    if rho_vec.size != nz:
        raise ValueError(f"rho vector must have length {nz}")

    h_diag = np.concatenate([Rd] + [np.concatenate([Qd, Rd])] * (N - 1))
    hhat_diag = h_diag + rho_vec
    hinv_diag = 1.0 / hhat_diag

    G = linalg.mpc_equality_matrix(A, B, N, drop_terminal=True)
    W = G @ (hinv_diag[:, None] * G.T)
    Alpha, Beta = linalg.band_chol_blocks(W, n, N)

    # dense affine maps: z = M_q q_hat + M_b beq (beq = [-A x0; 0; ...; xr])
    GH = G * hinv_diag[None, :]
    Winv = np.linalg.inv(W)
    M_q = GH.T @ (Winv @ GH) - np.diag(hinv_diag)
    M_b = GH.T @ Winv                      # [nz, N n]

    LB_z, UB_z = _stacked_bounds(sys, n, m, N, opt.inf_value)

    return dict(
        n=n, m=m, N=N, nz=nz, rho_is_scalar=rho_is_scalar,
        A=A, B=B, AB=np.hstack([A, B]), Qd=Qd, Rd=Rd,
        rho_vec=rho_vec, rho_inv_vec=1.0 / rho_vec,
        rho_scalar=float(rho) if rho.ndim == 0 else None,
        hinv_diag=hinv_diag,
        Hi_0=hinv_diag[:m].copy(),
        Hi_mid=hinv_diag[m:].reshape(N - 1, n + m).copy(),
        M_q=M_q,
        M_b0=M_b[:, :n].copy(), M_bN=M_b[:, -n:].copy(),
        Alpha=Alpha, Beta=Beta, LB_z=LB_z, UB_z=UB_z,
        scaling_x=np.asarray(sys.get("Nx", np.ones(n)), float).ravel(),
        scaling_u=np.asarray(sys.get("Nu", np.ones(m)), float).ravel(),
        op_x=np.asarray(sys.get("x0", np.zeros(n)), float).ravel(),
        op_u=np.asarray(sys.get("u0", np.zeros(m)), float).ravel(),
    )


def _equmpc_q_ref(ing, xr, ur, dtype):
    """q = -(R ur, [Q xr, R ur] x (N-1)) (spcies_equMPC_ADMM_solver.m:274)."""
    Qd = jnp.asarray(ing["Qd"], dtype)
    Rd = jnp.asarray(ing["Rd"], dtype)
    qx = -xr * Qd
    qu = -ur * Rd
    mid = jnp.concatenate([qx, qu], axis=-1)
    return jnp.concatenate([qu, jnp.tile(mid, (1, ing["N"] - 1))], axis=-1)


@register_builder("equMPC", "ADMM", backends=("dense", "banded"))
def build_equmpc_admm(sys: dict, param: dict, opt: Options,
                      backend: str = "dense") -> BatchedSolver:
    from spcies_tpu.formulations.laxmpc import _tag_stagewise
    if opt.time_varying:
        from spcies_tpu.formulations.laxmpc import _tv_admm_solver
        return _tag_stagewise(
            _tv_admm_solver(sys, param, opt, terminal=False), False)
    ing = equmpc_admm_ingredients(sys, param, opt)
    dtype = jnp.float64 if opt.precision == "double" else jnp.float32
    n, m, N, nz = ing["n"], ing["m"], ing["N"], ing["nz"]
    tol = float(opt.solver["tol"])
    k_max = int(opt.solver["k_max"])

    rho = (dtype(ing["rho_scalar"]) if ing["rho_is_scalar"]
           else jnp.asarray(ing["rho_vec"], dtype))
    rho_i = (dtype(1.0 / ing["rho_scalar"]) if ing["rho_is_scalar"]
             else jnp.asarray(ing["rho_inv_vec"], dtype))
    LB_z = jnp.asarray(ing["LB_z"], dtype)
    UB_z = jnp.asarray(ing["UB_z"], dtype)
    A = jnp.asarray(ing["A"], dtype)

    if backend == "dense":
        M_q = jnp.asarray(ing["M_q"], dtype)
        M_b0 = jnp.asarray(ing["M_b0"], dtype)
        M_bN = jnp.asarray(ing["M_bN"], dtype)

        def make_z_step(b0, xr):
            if b0 is None:
                return lambda dq: delta_dot(dq, M_q.T)
            def z_step(q_hat):
                return q_hat @ M_q.T + b0 @ M_b0.T + xr @ M_bN.T
            return z_step
    elif backend == "banded":
        eq_qp = stagewise.make_banded_eq_qp(
            ing, dtype, terminal=False,
            parallel_scan=bool(opt.solver.get("band_parallel_scan", False)))

        def make_z_step(b0, xr):
            if b0 is None:
                return lambda dq: eq_qp(dq, None)
            def z_step(q_hat):
                Bsz = q_hat.shape[0]
                rhs_extra = (jnp.zeros((Bsz, N, n), dtype)
                             .at[:, 0].set(-b0).at[:, -1].set(-xr))
                return eq_qp(q_hat, rhs_extra)
            return z_step
    else:
        raise ValueError(f"unknown backend {backend!r}")

    def proj(y):
        return proj_box(y, LB_z, UB_z)

    def _solve(x0, xr, ur, init, fixed_iters):
        b0 = -(x0 @ A.T)
        q_ref = _equmpc_q_ref(ing, xr, ur, dtype)
        z, v, lam, k, e_flag, r_p, r_d, hist = admm_solve(
            make_z_step(b0, xr), proj, q_ref, rho, rho_i, tol, tol, k_max,
            batch=x0.shape[0], nz=nz, dtype=dtype, init=init,
            fixed_iters=fixed_iters,
            relax_alpha=float(opt.solver.get("relax_alpha", 1.0)),
            freeze_converged=bool(opt.solver.get("freeze_converged", True)),
            straggler_polish=int(opt.solver.get("straggler_polish", 0)),
            z_lin=make_z_step(None, None),
            history=opt.debug)
        u = v[:, :m]
        return SolveResult(u=u, k=k, e_flag=e_flag,
                           sol=dict(z=z, v=v, lam=lam, r_p=r_p, r_d=r_d,
                                    **hist_sol_entries(hist)))

    return _tag_stagewise(
        BatchedSolver(_solve, ing, opt, n=n, m=m, N=N, nz=nz, dtype=dtype),
        False)


# ---------------------------------------------------------------------------
# FISTA
# ---------------------------------------------------------------------------

def equmpc_fista_ingredients(sys: dict, param: dict, opt: Options) -> dict:
    """Analogue of compute_equMPC_FISTA_ingredients.m: H without rho,
    diagonal Q/R, truncated G, b carries xr in the last block."""
    A, B, n, m = get_sys_matrices(sys)
    N = int(param["N"])
    Q = np.asarray(param["Q"], dtype=float)
    R = np.asarray(param["R"], dtype=float)
    if not (np.allclose(Q, np.diag(np.diag(Q))) and
            np.allclose(R, np.diag(np.diag(R)))):
        raise ValueError("equMPC/FISTA requires diagonal Q and R "
                         "(compute_equMPC_FISTA_ingredients.m)")
    Qd, Rd = np.diag(Q).copy(), np.diag(R).copy()
    nz = N * (n + m) - n

    h_diag = np.concatenate([Rd] + [np.concatenate([Qd, Rd])] * (N - 1))
    hinv_diag = 1.0 / h_diag
    G = linalg.mpc_equality_matrix(A, B, N, drop_terminal=True)
    W = G @ (hinv_diag[:, None] * G.T)
    Alpha, Beta = linalg.band_chol_blocks(W, n, N)
    LB_z, UB_z = _stacked_bounds(sys, n, m, N, opt.inf_value)

    return dict(
        n=n, m=m, N=N, nz=nz, A=A, B=B, AB=np.hstack([A, B]),
        Qd=Qd, Rd=Rd, hinv_diag=hinv_diag,
        G=G, Winv=np.linalg.inv(W), Alpha=Alpha, Beta=Beta,
        LB_z=LB_z, UB_z=UB_z,
    )


@register_builder("equMPC", "FISTA",
                  backends=("dense", "banded"))
def build_equmpc_fista(sys: dict, param: dict, opt: Options,
                       backend: str = "dense") -> BatchedSolver:
    """equMPC via dual FISTA (code_equMPC_FISTA_C.c,
    spcies_equMPC_FISTA_solver.m)."""
    from spcies_tpu.formulations.laxmpc import _tag_stagewise
    if opt.time_varying:
        from spcies_tpu.formulations.laxmpc import _tv_fista_solver
        return _tag_stagewise(
            _tv_fista_solver(sys, param, opt, terminal=False), False)
    from spcies_tpu.solvers.fista import fista_solve
    ing = equmpc_fista_ingredients(sys, param, opt)
    dtype = jnp.float64 if opt.precision == "double" else jnp.float32
    n, m, N, nz = ing["n"], ing["m"], ing["N"], ing["nz"]
    tol = float(opt.solver["tol"])
    k_max = int(opt.solver["k_max"])
    A = jnp.asarray(ing["A"], dtype)
    if backend not in ("dense", "banded"):
        raise ValueError(f"unknown backend {backend!r}")
    z_from_q, gt_op, g_op, w_solve = _make_fista_parts(ing, dtype, backend,
                                                       terminal=False)

    def _solve(x0, xr, ur, init, fixed_iters):
        Bsz = x0.shape[0]
        q_ref = _equmpc_q_ref(ing, xr, ur, dtype)
        b = jnp.zeros((Bsz, N * n), dtype)
        b = b.at[:, :n].set(-(x0 @ A.T))
        b = b.at[:, -n:].set(xr)
        lam_init = init if init is None else init[0]
        z, y, lam, k, e_flag, res, hist = fista_solve(
            z_from_q, gt_op, g_op, w_solve, q_ref, b,
            tol=tol, k_max=k_max, batch=Bsz, nlam=N * n, dtype=dtype,
            lam_init=lam_init, fixed_iters=fixed_iters,
            restart=bool(opt.solver.get("restart", False)),
            history=opt.debug)
        return SolveResult(u=z[:, :m], k=k, e_flag=e_flag,
                           sol=dict(z=z, lam=y, res=res,
                                    **hist_sol_entries(hist)))

    return _tag_stagewise(
        BatchedSolver(_solve, ing, opt, n=n, m=m, N=N, nz=nz, dtype=dtype),
        False)
