"""ellipMPC formulation — MPC with an ellipsoidal terminal constraint
(x_N - c)' P (x_N - c) <= r^2 (arXiv:2105.08419).

Two solvers:

ADMM ('' submethod) — the terminal penalty is rho*P instead of rho*I, which
makes the v-update's terminal prox an *exact P-norm ellipsoid projection*
(reference compute_ellipMPC_ADMM_ingredients.m:86 Hhat construction,
code_ellipMPC_ADMM_C.c:321-351 projection,
platforms/Matlab/spcies_ellipMPC_ADMM_solver.m loop). Center c and radius r
are baked at build time.

ADMM-soc ('soc' submethod) — reformulates the terminal set as a
second-order-cone constraint with one slack scalar; the ellipsoid center is
the *runtime* state reference xr and the radius is a runtime input
(code_ellipMPC_ADMM_soc_C.c:20 takes r_ellip as 4th argument;
compute_ellipMPC_ADMM_soc_ingredients.m,
spcies_ellipMPC_ADMM_soc_solver.m). Batched design: the reference's
offline LDL + CSR SpMV pipeline is replaced by the algebraically equivalent
dense affine maps aux = M1 q_hat + M2 bh (the reference's own commented
non-sparse path, spcies_ellipMPC_ADMM_soc_solver.m:198): two batched
matmuls per iteration.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import jax
import jax.numpy as jnp

from spcies_tpu.config import Options
from spcies_tpu.formulations.base import (register_builder, get_sys_matrices,
                                          get_bounds)
from spcies_tpu.formulations import stagewise
from spcies_tpu.utils import linalg
from spcies_tpu.utils.projections import proj_box, proj_ellipsoid, proj_soc
from spcies_tpu.solvers.common import (SolveResult, inf_norm,
                                        hist_sol_entries,
                                        delta_dot)
from spcies_tpu.solvers.loop import run_masked_loop
from spcies_tpu.api import BatchedSolver


def _sym_sqrtm(P: np.ndarray) -> np.ndarray:
    """Symmetric PSD square root (MATLAB sqrtm on SPD input,
    compute_ellipMPC_ADMM_ingredients.m:84)."""
    w, V = np.linalg.eigh(P)
    return (V * np.sqrt(np.maximum(w, 0.0))) @ V.T


def _tightened_bounds(sys, param, n, m, N, inf_value):
    """Stage bounds with per-stage tightening incBx/incBu
    (compute_ellipMPC_ADMM_ingredients.m:105-139): covers u_0 and stages
    1..N-1; the terminal state has no box (ellipsoid only)."""
    LBx, UBx, LBu, UBu = get_bounds(sys, n, m, inf_value)
    incBx = np.asarray(param.get("incBx", np.zeros((n, N + 1))), float)
    incBu = np.asarray(param.get("incBu", np.zeros((m, N + 1))), float)
    if incBx.ndim == 1:
        incBx = incBx.reshape(n, N + 1)
    if incBu.ndim == 1:
        incBu = incBu.reshape(m, N + 1)
    LB = [LBu]
    UB = [UBu]
    for i in range(1, N):
        LB.append(np.concatenate([LBx + incBx[:, i], LBu + incBu[:, i]]))
        UB.append(np.concatenate([UBx - incBx[:, i], UBu - incBu[:, i]]))
    return np.concatenate(LB), np.concatenate(UB)


def ellipmpc_admm_ingredients(sys: dict, param: dict, opt: Options) -> dict:
    """Offline ingredients (compute_ellipMPC_ADMM_ingredients.m)."""
    A, B, n, m = get_sys_matrices(sys)
    N = int(param["N"])
    Q = np.asarray(param["Q"], dtype=float)
    R = np.asarray(param["R"], dtype=float)
    T = np.asarray(param["T"], dtype=float)
    P = np.asarray(param["P"], dtype=float)
    c = np.asarray(param.get("c", np.zeros(n)), dtype=float).ravel()
    r = float(param.get("r", 1.0))
    if not (np.allclose(Q, np.diag(np.diag(Q))) and
            np.allclose(R, np.diag(np.diag(R)))):
        raise ValueError("ellipMPC/ADMM requires diagonal Q and R "
                         "(compute_ellipMPC_ADMM_ingredients.m:64-66)")
    Qd, Rd = np.diag(Q).copy(), np.diag(R).copy()
    nz = N * (n + m)

    # rho layout (compute_ellipMPC_ADMM_ingredients.m:68-77): scalar, or a
    # vector of length N(n+m); force_vector_rho expands the scalar to a
    # constant vector (the reference's own exercised vector path).
    # The reference builds H = Hz + rho .* blkdiag(I, P) — a ROW scaling —
    # which is only a symmetric (well-formed ADMM) penalty when the terminal
    # n entries of rho are all equal: diag(rho_N) P is non-symmetric
    # otherwise and the reference's own chol(W) at :101-102 would fail on
    # the resulting non-symmetric W. We therefore accept any vector whose
    # terminal block is constant and raise (with this argument) otherwise;
    # see docs/options.md.
    rho_in = np.asarray(opt.solver["rho"], dtype=float)
    force_vec = bool(opt.solver.get("force_vector_rho", False))
    rho_is_scalar = rho_in.ndim == 0 and not force_vec
    rho_vec = (np.full(nz, float(rho_in)) if rho_in.ndim == 0
               else rho_in.ravel().copy())
    if rho_vec.size != nz:
        raise ValueError(f"rho vector must have length {nz}")
    rho_T = float(rho_vec[-1])
    if not np.allclose(rho_vec[nz - n:], rho_T):
        raise ValueError(
            "ellipMPC/ADMM vector rho must be constant over the terminal "
            "block (last n entries): the reference's rho.*blkdiag(I,P) row "
            "scaling (compute_ellipMPC_ADMM_ingredients.m:84-86) gives a "
            "non-symmetric penalty diag(rho_N) P otherwise, and chol(W) "
            "fails")
    rho_s = rho_vec[:nz - n].copy()     # stage entries (diagonal penalty)
    rho = rho_T if rho_is_scalar else None

    P_half = _sym_sqrtm(P)
    Hz = linalg.blkdiag(R, *([linalg.blkdiag(Q, R)] * (N - 1)), T)
    Hhat = Hz + linalg.blkdiag(np.diag(rho_s), rho_T * P)
    Hinv = np.linalg.inv(Hhat)
    G = linalg.mpc_equality_matrix(A, B, N)
    W = G @ Hinv @ G.T
    Alpha, Beta = linalg.band_chol_blocks(W, n, N)

    GH = G @ Hinv
    Winv = np.linalg.inv(W)
    M_q = GH.T @ (Winv @ GH) - Hinv
    M_b = GH.T @ Winv[:, :n]

    LB, UB = _tightened_bounds(sys, param, n, m, N, opt.inf_value)

    return dict(
        n=n, m=m, N=N, nz=nz, A=A, B=B, AB=np.hstack([A, B]),
        Qd=Qd, Rd=Rd, T=T, rho=rho, rho_is_scalar=rho_is_scalar,
        rho_s=rho_s, rho_T=rho_T,
        P=P, P_half=P_half, Pinv_half=np.linalg.inv(P) @ P_half,
        c=c, r=r, M_q=M_q, M_b=M_b,
        Hi_0=np.diag(Hinv)[:m].copy(),
        Hi_mid=np.diag(Hinv)[m:m + (N - 1) * (n + m)].reshape(N - 1, n + m),
        Hi_N=Hinv[-n:, -n:].copy(),
        Alpha=Alpha, Beta=Beta, LB=LB, UB=UB,
    )


def _ellipmpc_q_ref(ing, xr, ur, dtype):
    """Linear cost q from the references (spcies_ellipMPC_ADMM_solver.m)."""
    N = ing["N"]
    Qd = jnp.asarray(ing["Qd"], dtype)
    Rd = jnp.asarray(ing["Rd"], dtype)
    T = jnp.asarray(ing["T"], dtype)
    qu = -ur * Rd
    mid = jnp.concatenate([-xr * Qd, qu], axis=-1)
    return jnp.concatenate(
        [qu, jnp.tile(mid, (1, N - 1)), -(xr @ T.T)], axis=-1)


@register_builder("ellipMPC", "ADMM",
                  backends=("dense", "banded"))
def build_ellipmpc_admm(sys: dict, param: dict, opt: Options,
                        backend: str = "dense") -> BatchedSolver:
    ing = ellipmpc_admm_ingredients(sys, param, opt)
    dtype = jnp.float64 if opt.precision == "double" else jnp.float32
    n, m, N, nz = ing["n"], ing["m"], ing["N"], ing["nz"]
    ns = nz - n  # stage entries (box-constrained part)
    tol = float(opt.solver["tol"])
    k_max = int(opt.solver["k_max"])
    # rho enters the iteration split by block: a per-entry vector on the
    # stage entries, a scalar on the terminal (P-weighted) block — see the
    # well-formedness note in ellipmpc_admm_ingredients
    rho = (dtype(ing["rho_T"]) if ing["rho_is_scalar"]
           else jnp.asarray(ing["rho_s"], dtype))
    rho_i = (dtype(1.0 / ing["rho_T"]) if ing["rho_is_scalar"]
             else jnp.asarray(1.0 / ing["rho_s"], dtype))
    rho_T = dtype(ing["rho_T"])
    rho_Ti = dtype(1.0 / ing["rho_T"])
    LB = jnp.asarray(ing["LB"], dtype)
    UB = jnp.asarray(ing["UB"], dtype)
    A = jnp.asarray(ing["A"], dtype)
    P = jnp.asarray(ing["P"], dtype)
    P_half = jnp.asarray(ing["P_half"], dtype)
    Pinv_half = jnp.asarray(ing["Pinv_half"], dtype)
    c = jnp.asarray(ing["c"], dtype)
    r = dtype(ing["r"])

    if backend == "dense":
        M_q = jnp.asarray(ing["M_q"], dtype)
        M_b = jnp.asarray(ing["M_b"], dtype)

        def make_z_step(b0):
            if b0 is None:
                return lambda dq: dq @ M_q.T
            return lambda q_hat: q_hat @ M_q.T + b0 @ M_b.T
    elif backend == "banded":
        eq_qp = stagewise.make_banded_eq_qp(ing, dtype, terminal=True)

        def make_z_step(b0):
            if b0 is None:
                return lambda dq: eq_qp(dq, None)
            def z_step(q_hat):
                rhs_extra = (jnp.zeros((q_hat.shape[0], N, n), dtype)
                             .at[:, 0].set(-b0))
                return eq_qp(q_hat, rhs_extra)
            return z_step
    else:
        raise ValueError(f"unknown backend {backend!r}")

    def _solve(x0, xr, ur, init, fixed_iters):
        Bsz = x0.shape[0]
        b0 = -(x0 @ A.T)
        q_ref = _ellipmpc_q_ref(ing, xr, ur, dtype)
        z_step = make_z_step(b0)
        z_lin = make_z_step(None)

        if init is None:
            zeros = jnp.zeros((Bsz, nz), dtype=dtype)
            z0_, v0, lam0 = zeros, zeros, zeros
        else:
            z0_, v0, lam0 = init

        def q_hat_of(lam, v):
            qs = q_ref[:, :ns] + lam[:, :ns] - rho * v[:, :ns]
            qT = (q_ref[:, ns:] + lam[:, ns:] @ P_half.T
                  - rho_T * (v[:, ns:] @ P.T))
            return jnp.concatenate([qs, qT], axis=-1)

        rinf = jnp.full((Bsz,), jnp.inf, dtype=dtype)
        z1 = z_step(q_hat_of(lam0, v0))
        state0 = dict(z=z1, z_next=z1, v=v0, lam=lam0, r_p=rinf, r_d=rinf)

        def body(state, _it):
            z = state["z_next"]
            v_prev = state["v"]
            lam = state["lam"]
            # v-update: box on stages, P-norm ellipsoid projection on x_N
            # (spcies_ellipMPC_ADMM_solver.m:179-189)
            vs = proj_box(z[:, :ns] + rho_i * lam[:, :ns], LB, UB)
            yT = z[:, ns:] + rho_Ti * (lam[:, ns:] @ Pinv_half.T)
            vT = proj_ellipsoid(yT, P, c, r)
            v = jnp.concatenate([vs, vT], axis=-1)
            # dual update (:192-193)
            lam_s = lam[:, :ns] + rho * (z[:, :ns] - vs)
            lam_T = lam[:, ns:] + rho_T * ((z[:, ns:] - vT) @ P_half.T)
            lam_new = jnp.concatenate([lam_s, lam_T], axis=-1)
            r_p = inf_norm(z - v)
            r_d = inf_norm(v - v_prev)
            conv = jnp.logical_and(r_p <= tol, r_d <= tol)
            # delta-form next z: dq = rho*(z - 2v + v_prev) through
            # blkdiag(diag(rho_s), rho_T P) (see solvers/admm.py rationale)
            dz = z - 2.0 * v + v_prev
            dq = jnp.concatenate(
                [rho * dz[:, :ns], rho_T * (dz[:, ns:] @ P.T)], axis=-1)
            z_next = z + z_lin(dq)
            return (dict(z=z, z_next=z_next, v=v, lam=lam_new,
                         r_p=r_p, r_d=r_d), conv)

        if opt.debug:
            state, k, e_flag, hist = run_masked_loop(
                body, state0, k_max, Bsz, fixed_iters=fixed_iters,
                history_keys=("r_p", "r_d")
                + (("z", "v", "lam")
                   if int(opt.debug) >= 2 else ()))
        else:
            state, k, e_flag = run_masked_loop(body, state0, k_max, Bsz,
                                               fixed_iters=fixed_iters)
            hist = None
        v = state["v"]
        return SolveResult(u=v[:, :m], k=k, e_flag=e_flag,
                           sol=dict(z=state["z"], v=v, lam=state["lam"],
                                    r_p=state["r_p"], r_d=state["r_d"],
                     **hist_sol_entries(hist)))

    return BatchedSolver(_solve, ing, opt, n=n, m=m, N=N, nz=nz, dtype=dtype)


# ---------------------------------------------------------------------------
# ADMM-soc
# ---------------------------------------------------------------------------

def ellipmpc_admm_soc_ingredients(sys: dict, param: dict, opt: Options) -> dict:
    """Offline ingredients (compute_ellipMPC_ADMM_soc_ingredients.m):
    slack-augmented decision vector, SOC rows C, dense M1/M2 maps replacing
    the reference's LDL/CSR pipeline."""
    A, B, n, m = get_sys_matrices(sys)
    N = int(param["N"])
    Q = np.asarray(param["Q"], dtype=float)
    R = np.asarray(param["R"], dtype=float)
    T = np.asarray(param["T"], dtype=float)
    P = np.asarray(param["P"], dtype=float)
    r_default = float(param.get("r", 1.0))
    if not (np.allclose(Q, np.diag(np.diag(Q))) and
            np.allclose(R, np.diag(np.diag(R)))):
        raise ValueError("ellipMPC/ADMM-soc requires diagonal Q and R")
    sigma = float(opt.solver["sigma"])
    rho = float(opt.solver["rho"])
    Qd, Rd = np.diag(Q).copy(), np.diag(R).copy()

    dim = N * (n + m) + 1           # + slack scalar
    n_s = n + 1                     # cone dimension
    H = linalg.blkdiag(R, *([linalg.blkdiag(Q, R)] * (N - 1)), T,
                       np.zeros((1, 1)))
    G = linalg.mpc_equality_matrix(A, B, N)
    G = linalg.blkdiag(G, np.ones((1, 1)))   # slack = r equality row
    n_eq = G.shape[0]

    P_half = _sym_sqrtm(P)
    # cone rows: C z + s = d with s in SOC
    # (compute_ellipMPC_ADMM_soc_ingredients.m:94-97)
    C = np.zeros((n_s, dim))
    C[0, dim - 1] = -1.0
    C[1:, dim - 1 - n:dim - 1] = -P_half

    Hh = linalg.blkdiag(H + sigma * np.eye(dim), rho * np.eye(n_s))
    Gh = np.block([[G, np.zeros((n_eq, n_s))], [C, np.eye(n_s)]])
    Hhi = np.linalg.inv(Hh)
    W = Gh @ Hhi @ Gh.T
    Winv = np.linalg.inv(W)
    M1 = Hhi @ Gh.T @ Winv @ Gh @ Hhi - Hhi
    M2 = Hhi @ Gh.T @ Winv

    LB, UB = _tightened_bounds(sys, param, n, m, N, opt.inf_value)
    PhiP = np.linalg.solve(P_half, P)    # P_half^{-1} P

    return dict(
        n=n, m=m, N=N, dim=dim, n_s=n_s, n_eq=n_eq,
        A=A, Qd=Qd, Rd=Rd, T=T, sigma=sigma, rho=rho,
        M1=M1,
        M2_b0=M2[:, :n].copy(),              # -A x0 block of bh
        M2_r=M2[:, n_eq - 1].copy(),         # runtime radius column
        M2_d=M2[:, n_eq + 1:].copy(),        # -PhiP xr block of bh
        PhiP=PhiP, LB=LB, UB=UB, r_default=r_default,
    )


@register_builder("ellipMPC", "ADMM", "soc",
                  backends=("dense",))
def build_ellipmpc_admm_soc(sys: dict, param: dict, opt: Options,
                            backend: str = "dense") -> BatchedSolver:
    ing = ellipmpc_admm_soc_ingredients(sys, param, opt)
    dtype = jnp.float64 if opt.precision == "double" else jnp.float32
    n, m, N = ing["n"], ing["m"], ing["N"]
    dim, n_s = ing["dim"], ing["n_s"]
    nbox = (N - 1) * (n + m) + m
    tol_p = float(opt.solver["tol_p"])
    tol_d = float(opt.solver["tol_d"])
    k_max = int(opt.solver["k_max"])
    sigma = dtype(ing["sigma"])
    rho = dtype(ing["rho"])
    sigma_i = dtype(1.0 / ing["sigma"])
    rho_i = dtype(1.0 / ing["rho"])
    LB = jnp.asarray(ing["LB"], dtype)
    UB = jnp.asarray(ing["UB"], dtype)
    A = jnp.asarray(ing["A"], dtype)
    M1 = jnp.asarray(ing["M1"], dtype)
    M2_b0 = jnp.asarray(ing["M2_b0"], dtype)
    M2_r = jnp.asarray(ing["M2_r"], dtype)
    M2_d = jnp.asarray(ing["M2_d"], dtype)
    PhiP = jnp.asarray(ing["PhiP"], dtype)

    def _q(xr, ur):
        Qd = jnp.asarray(ing["Qd"], dtype)
        Rd = jnp.asarray(ing["Rd"], dtype)
        T = jnp.asarray(ing["T"], dtype)
        qu = -ur * Rd
        mid = jnp.concatenate([-xr * Qd, qu], axis=-1)
        zero = jnp.zeros(xr.shape[:-1] + (1,), dtype)
        return jnp.concatenate(
            [qu, jnp.tile(mid, (1, N - 1)), -(xr @ T.T), zero], axis=-1)

    def _solve(x0, xr, ur, r_ellip, init, fixed_iters):
        Bsz = x0.shape[0]
        q = _q(xr, ur)
        r_run = r_ellip[:, 0]
        # aux = M1 q_hat + M2 bh, bh = [-A x0; 0...; r; 0; -PhiP xr]
        # (spcies_ellipMPC_ADMM_soc_solver.m:168-199)
        aux_b = ((-(x0 @ A.T)) @ M2_b0.T + r_run[:, None] * M2_r
                 + (-(xr @ PhiP.T)) @ M2_d.T)

        if init is None:
            z0_ = jnp.zeros((Bsz, dim), dtype)
            s0 = jnp.zeros((Bsz, n_s), dtype)
            lam0 = jnp.zeros((Bsz, dim), dtype)
            mu0 = jnp.zeros((Bsz, n_s), dtype)
        else:
            z0_, s0, lam0, mu0 = init

        def q_hat_of(z, s, lam, mu):
            return jnp.concatenate(
                [q - sigma * z + lam, mu - rho * s], axis=-1)

        aux1 = q_hat_of(z0_, s0, lam0, mu0) @ M1.T + aux_b
        rinf = jnp.full((Bsz,), jnp.inf, dtype=dtype)
        state0 = dict(aux=aux1, aux_next=aux1, z=z0_, s=s0,
                      lam=lam0, mu=mu0, r_p=rinf, r_d=rinf)

        def body(state, _it):
            aux = state["aux_next"]
            z_hat, s_hat = aux[:, :dim], aux[:, dim:]
            lam, mu = state["lam"], state["mu"]
            z_old, s_old = state["z"], state["s"]
            # primal projections (:203-224): box on stage vars only
            # (x_N and slack unclipped), SOC on the slack block
            zc = z_hat + sigma_i * lam
            z = jnp.concatenate(
                [proj_box(zc[:, :nbox], LB, UB), zc[:, nbox:]], axis=-1)
            s = proj_soc(s_hat + rho_i * mu)
            lam_new = lam + sigma * (z_hat - z)
            mu_new = mu + rho * (s_hat - s)
            r_p = jnp.maximum(inf_norm(z_hat - z), inf_norm(s_hat - s))
            r_d = jnp.maximum(inf_norm(z - z_old), inf_norm(s - s_old))
            conv = jnp.logical_and(r_p <= tol_p, r_d <= tol_d)
            # delta-form: dq_hat = [sigma(z_hat - 2z + z_old);
            #                       rho(s_hat - 2s + s_old)]
            dq = jnp.concatenate(
                [sigma * (z_hat - 2.0 * z + z_old),
                 rho * (s_hat - 2.0 * s + s_old)], axis=-1)
            aux_next = aux + delta_dot(dq, M1.T)
            return (dict(aux=aux, aux_next=aux_next, z=z, s=s,
                         lam=lam_new, mu=mu_new, r_p=r_p, r_d=r_d), conv)

        if opt.debug:
            state, k, e_flag, hist = run_masked_loop(
                body, state0, k_max, Bsz, fixed_iters=fixed_iters,
                history_keys=("r_p", "r_d")
                + (("z", "s", "lam", "mu")
                   if int(opt.debug) >= 2 else ()))
        else:
            state, k, e_flag = run_masked_loop(body, state0, k_max, Bsz,
                                               fixed_iters=fixed_iters)
            hist = None
        z = state["z"]
        aux = state["aux"]
        return SolveResult(
            u=z[:, :m], k=k, e_flag=e_flag,
            sol=dict(z=z, s=state["s"],
                     z_hat=aux[:, :dim], s_hat=aux[:, dim:],
                     lam=state["lam"], mu=state["mu"],
                     r_p=state["r_p"], r_d=state["r_d"],
                     **hist_sol_entries(hist)))

    return BatchedSolver(
        _solve, ing, opt, n=n, m=m, N=N, nz=dim, dtype=dtype,
        input_names=("x0", "xr", "ur", "r_ellip"),
        default_inputs=(np.array([ing["r_default"]]),))
