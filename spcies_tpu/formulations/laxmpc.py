"""laxMPC formulation — MPC with a terminal cost (no terminal constraint).

    min  sum_{i=0}^{N-1} (||x_i - xr||_Q^2 + ||u_i - ur||_R^2) + ||x_N - xr||_T^2
    s.t. x_{i+1} = A x_i + B u_i,  LB <= (x_i, u_i) <= UB

Decision vector z = (u_0, x_1, u_1, ..., x_{N-1}, u_{N-1}, x_N), dim N(n+m).
Reference: formulations/+laxMPC/compute_laxMPC_ADMM_ingredients.m (offline
math), code_laxMPC_ADMM_C.c:308-633 (ADMM loop), TCST 2020 eq. (9).

Batched design, two interchangeable z-step backends:
  'dense'  — the whole equality-QP solve collapsed offline into one affine
             map z = M_q q_hat + M_b b0 (one [B,nz]x[nz,nz] matmul per
             iteration). Algebraically identical to the reference's
             band-solve; best for the contracted small horizons.
  'banded' — structured blockwise RHS build + Alpha/Beta banded Cholesky
             scans (kernels.band_chol), O(N n^2) memory like the reference;
             scales to long horizons.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from spcies_tpu.config import Options
from spcies_tpu.formulations.base import (register_builder, get_sys_matrices,
                                          get_bounds)
from spcies_tpu.utils import linalg
from spcies_tpu.utils.projections import proj_box
from spcies_tpu.solvers.admm import admm_solve
from spcies_tpu.solvers.common import (SolveResult,
                                        hist_sol_entries,
                                        delta_dot)
from spcies_tpu.api import BatchedSolver, broadcast_inputs


def laxmpc_admm_ingredients(sys: dict, param: dict, opt: Options) -> dict:
    """Offline ingredient computation, the analogue of
    compute_laxMPC_ADMM_ingredients.m:22-187 (all fp64 numpy)."""
    A, B, n, m = get_sys_matrices(sys)
    N = int(param["N"])
    Q = np.asarray(param["Q"], dtype=float)
    R = np.asarray(param["R"], dtype=float)
    T = np.asarray(param["T"], dtype=float)
    if not (np.allclose(Q, np.diag(np.diag(Q))) and
            np.allclose(R, np.diag(np.diag(R)))):
        raise ValueError("laxMPC/ADMM requires diagonal Q and R "
                         "(compute_laxMPC_ADMM_ingredients.m:50-52)")
    Qd, Rd = np.diag(Q).copy(), np.diag(R).copy()
    nz = N * (n + m)

    # rho layout (scalar or vector; compute_laxMPC_ADMM_ingredients.m:55-64)
    rho = np.asarray(opt.solver["rho"], dtype=float)
    force_vec = bool(opt.solver.get("force_vector_rho", False))
    rho_is_scalar = rho.ndim == 0 and not force_vec
    rho_vec = np.full(nz, float(rho)) if rho.ndim == 0 else rho.ravel().copy()
    if rho_vec.size != nz:
        raise ValueError(f"rho vector must have length {nz}")

    # Hessian Hhat = blkdiag(R, I_{N-1} (x) blkdiag(Q, R), T) + diag(rho)
    H = linalg.blkdiag(R, *([linalg.blkdiag(Q, R)] * (N - 1)), T)
    Hhat = H + np.diag(rho_vec)

    # Banded equality matrix and W = G Hhat^{-1} G^T
    G = linalg.mpc_equality_matrix(A, B, N)
    Hinv = np.linalg.inv(Hhat)
    W = G @ Hinv @ G.T
    Alpha, Beta = linalg.band_chol_blocks(W, n, N)

    # Dense affine z-update maps: z = M_q q_hat + M_b b0 with
    # z = -Hinv(q_hat + G' mu), W mu = -G Hinv q_hat - beq, beq = [b0; 0].
    GH = G @ Hinv                      # [N n, nz]
    K = np.linalg.solve(W, GH)         # W^{-1} G Hinv
    M_q = GH.T @ K - Hinv              # [nz, nz]
    M_b = GH.T @ np.linalg.inv(W)[:, :n]   # [nz, n]

    # Stage bounds stacked over the decision vector
    # (LB = [LBx; LBu], v_0 clipped by LBu, v_N by LBx:
    #  code_laxMPC_ADMM_C.c:487-537)
    LBx, UBx, LBu, UBu = get_bounds(sys, n, m, opt.inf_value)
    LB_z = np.concatenate([LBu] + [np.concatenate([LBx, LBu])] * (N - 1) + [LBx])
    UB_z = np.concatenate([UBu] + [np.concatenate([UBx, UBu])] * (N - 1) + [UBx])

    # Structured pieces for the banded backend (reference vars.Hi* layout,
    # compute_laxMPC_ADMM_ingredients.m:140-147)
    Hi_0 = np.diag(Hinv)[:m].copy()
    Hi_mid = np.diag(Hinv)[m:m + (N - 1) * (n + m)].reshape(N - 1, n + m)
    Hi_N = Hinv[-n:, -n:].copy()

    return dict(
        n=n, m=m, N=N, nz=nz, rho_is_scalar=rho_is_scalar,
        A=A, B=B, AB=np.hstack([A, B]), Qd=Qd, Rd=Rd, T=T,
        rho_vec=rho_vec, rho_inv_vec=1.0 / rho_vec,
        rho_scalar=float(rho) if rho.ndim == 0 else None,
        M_q=M_q, M_b=M_b, LB_z=LB_z, UB_z=UB_z,
        Alpha=Alpha, Beta=Beta,
        Hi_0=Hi_0, Hi_mid=Hi_mid, Hi_N=Hi_N,
        scaling_x=np.asarray(sys.get("Nx", np.ones(n)), float).ravel(),
        scaling_u=np.asarray(sys.get("Nu", np.ones(m)), float).ravel(),
        op_x=np.asarray(sys.get("x0", np.zeros(n)), float).ravel(),
        op_u=np.asarray(sys.get("u0", np.zeros(m)), float).ravel(),
    )


def _q_ref(ing, xr, ur, dtype):
    """Per-call linear cost q_ref = (-R ur, [-Q xr, -R ur] x (N-1), -T xr),
    the reference's baked-negated q update (code_laxMPC_ADMM_C.c:288-298
    with vars.Q = -diag(Q) etc.)."""
    Qd = jnp.asarray(ing["Qd"], dtype)
    Rd = jnp.asarray(ing["Rd"], dtype)
    T = jnp.asarray(ing["T"], dtype)
    qx = -xr * Qd
    qu = -ur * Rd
    qT = -(xr @ T.T)
    mid = jnp.concatenate([qx, qu], axis=-1)
    mid_tiled = jnp.tile(mid, (1, ing["N"] - 1))
    return jnp.concatenate([qu, mid_tiled, qT], axis=-1)


def _tag_stagewise(solver, terminal: bool):
    """Mark the solver's decision layout as the laxMPC/equMPC stagewise
    one (u_0 | x_1 u_1 | ... [| x_N]) so runtime.rollout can apply the
    receding-horizon warm-start shift (warm_start='shift')."""
    solver.stage_layout = ("stagewise", terminal)
    return solver


@register_builder("laxMPC", "ADMM", backends=("dense", "banded"))
def build_laxmpc_admm(sys: dict, param: dict, opt: Options,
                      backend: str = "dense") -> BatchedSolver:
    if opt.time_varying:
        return _tag_stagewise(
            _tv_admm_solver(sys, param, opt, terminal=True), True)
    ing = laxmpc_admm_ingredients(sys, param, opt)
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
        M_b = jnp.asarray(ing["M_b"], dtype)
        # bf16 delta path (fp32 only): the delta-form correction dq -> 0,
        # so a bf16 matmul's absolute error shrinks with the residual —
        # the hot matmul runs at bf16 rate.
        bf16_delta = (bool(opt.solver.get("bf16_delta", False))
                      and dtype == jnp.float32)
        if bf16_delta:
            M_q_bf = M_q.astype(jnp.bfloat16)

        def make_z_step(b0):
            if b0 is None:
                if bf16_delta:
                    return lambda dq: jax.lax.dot(
                        dq.astype(jnp.bfloat16), M_q_bf.T,
                        preferred_element_type=jnp.float32)
                return lambda dq: delta_dot(dq, M_q.T)
            def z_step(q_hat):
                return q_hat @ M_q.T + b0 @ M_b.T
            return z_step
    elif backend == "banded":
        from spcies_tpu.formulations import stagewise
        eq_qp = stagewise.make_banded_eq_qp(
            ing, dtype, terminal=True,
            parallel_scan=bool(opt.solver.get("band_parallel_scan", False)))

        def make_z_step(b0):
            if b0 is None:
                return lambda dq: eq_qp(dq, None)
            def z_step(q_hat):
                Bsz = q_hat.shape[0]
                rhs_extra = jnp.zeros((Bsz, N, n), dtype).at[:, 0].set(-b0)
                return eq_qp(q_hat, rhs_extra)
            return z_step
    else:
        raise ValueError(f"unknown backend {backend!r}")

    def proj(y):
        return proj_box(y, LB_z, UB_z)

    def _solve(x0, xr, ur, init, fixed_iters):
        b0 = -(x0 @ A.T)
        q_ref = _q_ref(ing, xr, ur, dtype)
        z, v, lam, k, e_flag, r_p, r_d, hist = admm_solve(
            make_z_step(b0), proj, q_ref, rho, rho_i, tol, tol, k_max,
            batch=x0.shape[0], nz=nz, dtype=dtype, init=init,
            fixed_iters=fixed_iters,
            relax_alpha=float(opt.solver.get("relax_alpha", 1.0)),
            freeze_converged=bool(opt.solver.get("freeze_converged", True)),
            straggler_polish=int(opt.solver.get("straggler_polish", 0)),
            z_lin=make_z_step(None),
            history=opt.debug)
        u = v[:, :m]
        return SolveResult(u=u, k=k, e_flag=e_flag,
                           sol=dict(z=z, v=v, lam=lam, r_p=r_p, r_d=r_d,
                                    **hist_sol_entries(hist)))

    return _tag_stagewise(
        BatchedSolver(_solve, ing, opt, n=n, m=m, N=N, nz=nz, dtype=dtype),
        True)


# ---------------------------------------------------------------------------
# FISTA
# ---------------------------------------------------------------------------

def laxmpc_fista_ingredients(sys: dict, param: dict, opt: Options) -> dict:
    """Offline ingredients for dual FISTA, the analogue of
    compute_laxMPC_FISTA_ingredients.m (H without rho; Q, R, T all diagonal
    required, :50-52; exports Hinv diag and the W band factors :71-97)."""
    A, B, n, m = get_sys_matrices(sys)
    N = int(param["N"])
    Q = np.asarray(param["Q"], dtype=float)
    R = np.asarray(param["R"], dtype=float)
    T = np.asarray(param["T"], dtype=float)
    for name, M in (("Q", Q), ("R", R), ("T", T)):
        if not np.allclose(M, np.diag(np.diag(M))):
            raise ValueError(
                f"laxMPC/FISTA requires diagonal {name} "
                "(compute_laxMPC_FISTA_ingredients.m:50-52)")
    Qd, Rd, Td = np.diag(Q).copy(), np.diag(R).copy(), np.diag(T).copy()
    nz = N * (n + m)

    h_diag = np.concatenate([Rd] + [np.concatenate([Qd, Rd])] * (N - 1) + [Td])
    hinv_diag = 1.0 / h_diag
    G = linalg.mpc_equality_matrix(A, B, N)
    W = G @ (hinv_diag[:, None] * G.T)
    Alpha, Beta = linalg.band_chol_blocks(W, n, N)

    LBx, UBx, LBu, UBu = get_bounds(sys, n, m, opt.inf_value)
    LB_z = np.concatenate([LBu] + [np.concatenate([LBx, LBu])] * (N - 1) + [LBx])
    UB_z = np.concatenate([UBu] + [np.concatenate([UBx, UBu])] * (N - 1) + [UBx])

    return dict(
        n=n, m=m, N=N, nz=nz, A=A, B=B, AB=np.hstack([A, B]),
        Qd=Qd, Rd=Rd, T=T, hinv_diag=hinv_diag,
        G=G, Winv=np.linalg.inv(W), Alpha=Alpha, Beta=Beta,
        LB_z=LB_z, UB_z=UB_z,
    )


def _make_fista_parts(ing, dtype, backend, terminal: bool):
    """Shared FISTA operator construction for laxMPC (terminal=True) and
    equMPC (terminal=False): z-from-q clip, the linear G^T / G applies
    (consumed on deltas by the engine), and the W solve."""
    from spcies_tpu.formulations import stagewise
    n, m, N = ing["n"], ing["m"], ing["N"]
    hinv = jnp.asarray(ing["hinv_diag"], dtype)
    LB_z = jnp.asarray(ing["LB_z"], dtype)
    UB_z = jnp.asarray(ing["UB_z"], dtype)

    def z_from_q(q):
        return proj_box(-hinv * q, LB_z, UB_z)

    if backend == "dense":
        G = jnp.asarray(ing["G"], dtype)
        Winv = jnp.asarray(ing["Winv"], dtype)

        def gt_op(y):
            return y @ G

        def g_op(z):
            return z @ G.T

        def w_solve(r):
            return r @ Winv.T
    else:  # banded
        from spcies_tpu.kernels.band_chol import band_chol_solve, beta_inverses
        Alpha_np, BetaInv_np = beta_inverses(ing["Alpha"], ing["Beta"])
        Alpha = jnp.asarray(Alpha_np, dtype)
        BetaInv = jnp.asarray(BetaInv_np, dtype)
        A_ = jnp.asarray(ing["A"], dtype)
        B_ = jnp.asarray(ing["B"], dtype)
        AB = jnp.asarray(ing["AB"], dtype)

        def gt_op(y):
            mu = y.reshape(y.shape[0], N, n)
            return stagewise.gt_apply(mu, n, m, B_, AB, terminal)

        def g_op(z):
            z0, zm, zN = stagewise.split_z(z, n, m, N, terminal)
            gz = stagewise.g_apply(z0, zm, zN, A_, B_, AB)
            return gz.reshape(z.shape[0], -1)

        def w_solve(r):
            mu = band_chol_solve(r.reshape(r.shape[0], N, n), Alpha, BetaInv)
            return mu.reshape(r.shape[0], -1)

    return z_from_q, gt_op, g_op, w_solve


@register_builder("laxMPC", "FISTA",
                  backends=("dense", "banded"))
def build_laxmpc_fista(sys: dict, param: dict, opt: Options,
                       backend: str = "dense") -> BatchedSolver:
    """laxMPC via dual FISTA (code_laxMPC_FISTA_C.c,
    spcies_laxMPC_FISTA_solver.m)."""
    if opt.time_varying:
        return _tag_stagewise(
            _tv_fista_solver(sys, param, opt, terminal=True), True)
    from spcies_tpu.solvers.fista import fista_solve
    ing = laxmpc_fista_ingredients(sys, param, opt)
    dtype = jnp.float64 if opt.precision == "double" else jnp.float32
    n, m, N, nz = ing["n"], ing["m"], ing["N"], ing["nz"]
    tol = float(opt.solver["tol"])
    k_max = int(opt.solver["k_max"])
    A = jnp.asarray(ing["A"], dtype)
    if backend not in ("dense", "banded"):
        raise ValueError(f"unknown backend {backend!r}")
    z_from_q, gt_op, g_op, w_solve = _make_fista_parts(ing, dtype, backend,
                                                       terminal=True)

    def _solve(x0, xr, ur, init, fixed_iters):
        Bsz = x0.shape[0]
        q_ref = _q_ref(ing, xr, ur, dtype)
        b = jnp.zeros((Bsz, N * n), dtype)
        b = b.at[:, :n].set(-(x0 @ A.T))
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
        True)


# ---------------------------------------------------------------------------
# Time-varying mode (opt.time_varying): per-call (A, B, Q, R, LB, UB)
# ---------------------------------------------------------------------------

def _tv_admm_solver(sys, param, opt, *, terminal: bool):
    """Shared time-varying ADMM builder for laxMPC (terminal=True) and
    equMPC (terminal=False).

    Mirrors the reference's TIME_VARYING=1 solvers: 9-input signature
    (x0, xr, ur, A, B, Qdiag, Rdiag, LB, UB) with LB/UB = [LBx; LBu] held
    constant over the horizon (struct_laxMPC_ADMM_C_Matlab.c:29-88), scalar
    rho only (cons_laxMPC_ADMM_C.m:47-52), and the Alpha/Beta band factors
    recomputed online (code_laxMPC_ADMM_C.c:150-279) — here as a batched
    blocked-Cholesky scan (kernels.online_band_chol), so every lane can
    carry a DIFFERENT model, which the reference cannot express.

    solver options:
      band_parallel_scan — O(log N)-depth associative-scan band solve.
      tv_dense_w — materialize each lane's dense W = G Hhat^-1 G'
        ([B, Nn, Nn]) and solve with batched dense Cholesky instead of the
        O(N) banded factors. This is the structure-oblivious path the
        banded design exists to avoid: its memory is quadratic in the
        horizon PER LANE, so it runs out of device memory at (B, N)
        points the banded backend sails through.
    """
    from spcies_tpu.kernels.band_chol import (band_chol_solve,
                                              band_chol_solve_scan)
    from spcies_tpu.kernels.online_band_chol import online_band_chol_fn
    from spcies_tpu.formulations import stagewise

    A0, B0, n, m = get_sys_matrices(sys)
    N = int(param["N"])
    nz = N * (n + m) - (0 if terminal else n)
    dtype = jnp.float64 if opt.precision == "double" else jnp.float32
    tol = float(opt.solver["tol"])
    k_max = int(opt.solver["k_max"])
    rho_f = opt.solver["rho"]
    if np.ndim(rho_f) != 0:
        raise ValueError("time-varying mode requires scalar rho "
                         "(cons_laxMPC_ADMM_C.m:47-52)")
    rho = dtype(float(rho_f))
    rho_i = dtype(1.0 / float(rho_f))

    if terminal:
        T = np.asarray(param["T"], dtype=float)
        # (T + rho I)^-1 is computed OFFLINE (T is not time-varying;
        # compute_laxMPC_ADMM_ingredients.m:109-118)
        T_rho_i_np = np.linalg.inv(T + float(rho_f) * np.eye(n))
        T_rho_i = jnp.asarray(T_rho_i_np, dtype)
        Tj = jnp.asarray(T, dtype)
    else:
        T_rho_i = None
        Tj = None
    chol_fn = online_band_chol_fn(N, terminal)
    dense_w = bool(opt.solver.get("tv_dense_w", False))
    band_solve = (band_chol_solve_scan
                  if bool(opt.solver.get("band_parallel_scan", False))
                  else band_chol_solve)

    def _make_dense_w_solve(A, B, Qhat_inv, Rhat_inv, dtype):
        """Per-lane dense W [B, Nn, Nn] + batched Cholesky (tv_dense_w).
        W is block-tridiagonal: D_0 = B Ri B' + diag(Qi);
        D_l = A Qi A' + B Ri B' + (diag(Qi) | T_rho_i | nothing) for the
        next-state weight; E_l = -diag(Qi) A' couples stages l, l+1."""
        Bsz = A.shape[0]
        Nn = N * n
        AQ = A * Qhat_inv[:, None, :]            # A diag(Qi)
        BR = B * Rhat_inv[:, None, :]
        AQA = jnp.einsum("bij,bkj->bik", AQ, A)
        BRB = jnp.einsum("bij,bkj->bik", BR, B)
        Dmid = AQA + BRB                          # [B, n, n]
        Qdiag = jax.vmap(jnp.diag)(Qhat_inv)      # [B, n, n]
        D = jnp.tile((Dmid + Qdiag)[:, None], (1, N, 1, 1))
        D = D.at[:, 0].set(BRB + Qdiag)
        if terminal:
            D = D.at[:, N - 1].set(Dmid + T_rho_i)
        else:
            D = D.at[:, N - 1].set(Dmid)
        E = -jnp.einsum("bi,bji->bij", Qhat_inv, A)   # -diag(Qi) A'
        E = jnp.tile(E[:, None], (1, N, 1, 1))        # row N-1 unused
        eyeN = jnp.eye(N, dtype=dtype)
        upN = jnp.eye(N, k=1, dtype=dtype)            # kills row N-1
        W = jnp.einsum("blij,lk->blikj", D, eyeN)
        Wu = jnp.einsum("blij,lk->blikj", E, upN)
        W = W + Wu + jnp.transpose(Wu, (0, 3, 4, 1, 2))
        W = W.reshape(Bsz, Nn, Nn)
        chol = jnp.linalg.cholesky(W)

        def solve_W(rhs):                         # rhs [B, N, n]
            flat = rhs.reshape(Bsz, Nn)
            out = jax.scipy.linalg.cho_solve((chol, True), flat)
            return out.reshape(Bsz, N, n)

        return solve_W

    def _solve(x0, xr, ur, A, B, Qd, Rd, LB, UB, init, fixed_iters):
        Bsz = x0.shape[0]
        Qhat_inv = 1.0 / (Qd + rho)              # [B, n]
        Rhat_inv = 1.0 / (Rd + rho)              # [B, m]
        if dense_w:
            solve_W = _make_dense_w_solve(A, B, Qhat_inv, Rhat_inv,
                                          x0.dtype)
        else:
            Alpha, BetaInv = chol_fn(A, B, Qhat_inv, Rhat_inv, T_rho_i)
            solve_W = lambda rhs: band_solve(rhs, Alpha, BetaInv)
        AB = jnp.concatenate([A, B], axis=-1)    # [B, n, n+m]
        Hi_0 = Rhat_inv
        Hi_mid = jnp.tile(jnp.concatenate([Qhat_inv, Rhat_inv], axis=-1),
                          (1, N - 1)).reshape(Bsz, N - 1, n + m)

        def hinv(q):
            q0, qm, qN = stagewise.split_z(q, n, m, N, terminal)
            hN = qN @ T_rho_i.T if terminal else None
            return Hi_0 * q0, Hi_mid * qm, hN

        def z_step_full(q_hat, b0, xr_rhs):
            h0, hm, hN = hinv(q_hat)
            rhs = -stagewise.g_apply(h0, hm, hN, A, B, AB)
            rhs = rhs.at[:, 0].add(-b0)
            if not terminal:
                rhs = rhs.at[:, -1].add(-xr_rhs)
            mu = solve_W(rhs)
            g0, gm, gN = stagewise.split_z(
                stagewise.gt_apply(mu, n, m, B, AB, terminal),
                n, m, N, terminal)
            z0 = -(h0 + Hi_0 * g0)
            zm = -(hm + Hi_mid * gm)
            zN = -(hN + gN @ T_rho_i.T) if terminal else None
            return stagewise.join_z(z0, zm, zN)

        def z_lin(dq):
            h0, hm, hN = hinv(dq)
            rhs = -stagewise.g_apply(h0, hm, hN, A, B, AB)
            mu = solve_W(rhs)
            g0, gm, gN = stagewise.split_z(
                stagewise.gt_apply(mu, n, m, B, AB, terminal),
                n, m, N, terminal)
            z0 = -(h0 + Hi_0 * g0)
            zm = -(hm + Hi_mid * gm)
            zN = -(hN + gN @ T_rho_i.T) if terminal else None
            return stagewise.join_z(z0, zm, zN)

        # stacked bounds from the per-call single-stage [LBx; LBu]
        LBx, LBu = LB[:, :n], LB[:, n:]
        UBx, UBu = UB[:, :n], UB[:, n:]
        mid_lb = jnp.tile(jnp.concatenate([LBx, LBu], axis=-1), (1, N - 1))
        mid_ub = jnp.tile(jnp.concatenate([UBx, UBu], axis=-1), (1, N - 1))
        if terminal:
            LB_z = jnp.concatenate([LBu, mid_lb, LBx], axis=-1)
            UB_z = jnp.concatenate([UBu, mid_ub, UBx], axis=-1)
        else:
            LB_z = jnp.concatenate([LBu, mid_lb], axis=-1)
            UB_z = jnp.concatenate([UBu, mid_ub], axis=-1)

        # linear cost from runtime diagonals
        qu = -ur * Rd
        mid_q = jnp.tile(jnp.concatenate([-xr * Qd, qu], axis=-1),
                         (1, N - 1))
        if terminal:
            q_ref = jnp.concatenate([qu, mid_q, -(xr @ Tj.T)], axis=-1)
        else:
            q_ref = jnp.concatenate([qu, mid_q], axis=-1)

        b0 = -jnp.einsum("bij,bj->bi", A, x0)

        def proj(y):
            return proj_box(y, LB_z, UB_z)

        z, v, lam, k, e_flag, r_p, r_d, hist = admm_solve(
            lambda qh: z_step_full(qh, b0, xr), proj, q_ref, rho, rho_i,
            tol, tol, k_max, batch=Bsz, nz=nz, dtype=dtype, init=init,
            fixed_iters=fixed_iters,
            relax_alpha=float(opt.solver.get("relax_alpha", 1.0)),
            freeze_converged=bool(opt.solver.get("freeze_converged", True)),
            straggler_polish=int(opt.solver.get("straggler_polish", 0)),
            z_lin=z_lin, history=opt.debug)
        return SolveResult(u=v[:, :m], k=k, e_flag=e_flag,
                           sol=dict(z=z, v=v, lam=lam, r_p=r_p, r_d=r_d,
                                    **hist_sol_entries(hist)))

    return BatchedSolver(
        _solve, dict(n=n, m=m, N=N, nz=nz), opt, n=n, m=m, N=N, nz=nz,
        dtype=dtype,
        input_names=("x0", "xr", "ur", "A", "B", "Q", "R", "LB", "UB"),
        input_core_ndims=(1, 1, 1, 2, 2, 1, 1, 1, 1))


def _tv_fista_solver(sys, param, opt, *, terminal: bool):
    """Time-varying dual FISTA for laxMPC (terminal=True) / equMPC
    (terminal=False): same 9-input signature as the TIME_VARYING ADMM
    (code_laxMPC_FISTA_C.c TIME_VARYING path); W = G H^-1 G' factored
    online per lane (no rho in H)."""
    from spcies_tpu.kernels.band_chol import band_chol_solve
    from spcies_tpu.kernels.online_band_chol import online_band_chol_fn
    from spcies_tpu.formulations import stagewise
    from spcies_tpu.solvers.fista import fista_solve

    A0, B0, n, m = get_sys_matrices(sys)
    N = int(param["N"])
    nz = N * (n + m) - (0 if terminal else n)
    dtype = jnp.float64 if opt.precision == "double" else jnp.float32
    tol = float(opt.solver["tol"])
    k_max = int(opt.solver["k_max"])

    if terminal:
        T = np.asarray(param["T"], dtype=float)
        if not np.allclose(T, np.diag(np.diag(T))):
            raise ValueError("laxMPC/FISTA requires diagonal T")
        Td = np.diag(T).copy()
        T_inv = jnp.asarray(np.diag(1.0 / Td), dtype)
        Td_j = jnp.asarray(Td, dtype)
    else:
        T_inv = None
        Td_j = None
    chol_fn = online_band_chol_fn(N, terminal)

    def _solve(x0, xr, ur, A, B, Qd, Rd, LB, UB, init, fixed_iters):
        Bsz = x0.shape[0]
        Qinv = 1.0 / Qd
        Rinv = 1.0 / Rd
        Alpha, BetaInv = chol_fn(A, B, Qinv, Rinv, T_inv)
        AB = jnp.concatenate([A, B], axis=-1)
        if terminal:
            hinv = jnp.concatenate(
                [Rinv, jnp.tile(jnp.concatenate([Qinv, Rinv], axis=-1),
                                (1, N - 1)), 1.0 / Td_j[None, :].repeat(
                                    Bsz, axis=0)], axis=-1)
        else:
            hinv = jnp.concatenate(
                [Rinv, jnp.tile(jnp.concatenate([Qinv, Rinv], axis=-1),
                                (1, N - 1))], axis=-1)

        LBx, LBu = LB[:, :n], LB[:, n:]
        UBx, UBu = UB[:, :n], UB[:, n:]
        mid_lb = jnp.tile(jnp.concatenate([LBx, LBu], axis=-1), (1, N - 1))
        mid_ub = jnp.tile(jnp.concatenate([UBx, UBu], axis=-1), (1, N - 1))
        if terminal:
            LB_z = jnp.concatenate([LBu, mid_lb, LBx], axis=-1)
            UB_z = jnp.concatenate([UBu, mid_ub, UBx], axis=-1)
        else:
            LB_z = jnp.concatenate([LBu, mid_lb], axis=-1)
            UB_z = jnp.concatenate([UBu, mid_ub], axis=-1)

        qu = -ur * Rd
        mid_q = jnp.tile(jnp.concatenate([-xr * Qd, qu], axis=-1),
                         (1, N - 1))
        if terminal:
            q_ref = jnp.concatenate([qu, mid_q, -xr * Td_j], axis=-1)
        else:
            q_ref = jnp.concatenate([qu, mid_q], axis=-1)

        b = jnp.zeros((Bsz, N * n), dtype)
        b = b.at[:, :n].set(-jnp.einsum("bij,bj->bi", A, x0))
        if not terminal:
            b = b.at[:, -n:].set(xr)

        def z_from_q(q):
            return proj_box(-hinv * q, LB_z, UB_z)

        def gt_op(y):
            mu = y.reshape(Bsz, N, n)
            return stagewise.gt_apply(mu, n, m, B, AB, terminal)

        def g_op(z):
            z0, zm, zN = stagewise.split_z(z, n, m, N, terminal)
            gz = stagewise.g_apply(z0, zm, zN, A, B, AB)
            return gz.reshape(Bsz, -1)

        def w_solve(r):
            mu = band_chol_solve(r.reshape(Bsz, N, n), Alpha, BetaInv)
            return mu.reshape(Bsz, -1)

        lam_init = init if init is None else init[0]
        z, y, lam, k, e_flag, res, hist = fista_solve(
            z_from_q, gt_op, g_op, w_solve, q_ref, b,
            tol=tol, k_max=k_max, batch=Bsz,
            nlam=N * n, dtype=dtype, lam_init=lam_init,
            fixed_iters=fixed_iters,
            restart=bool(opt.solver.get("restart", False)))
        return SolveResult(u=z[:, :m], k=k, e_flag=e_flag,
                           sol=dict(z=z, lam=y, res=res,
                                    **hist_sol_entries(hist)))

    return BatchedSolver(
        _solve, dict(n=n, m=m, N=N, nz=nz), opt, n=n, m=m, N=N, nz=nz,
        dtype=dtype,
        input_names=("x0", "xr", "ur", "A", "B", "Q", "R", "LB", "UB"),
        input_core_ndims=(1, 1, 1, 2, 2, 1, 1, 1, 1))
