"""HMPC formulation — harmonic MPC (arXiv:2202.06629).

The terminal artificial reference is a sinusoid parameterized by
offset/sine/cosine components with base frequency w: the decision vector is
z = (u_0, x_1, u_1, ..., x_{N-1}, u_{N-1}, xe, xs, xc, ue, us, uc). The
harmonic Hessian blocks come from sin/cos sums over the horizon, equality
constraints couple the last predicted state to the harmonic at phase w*N
and impose the 3n harmonic-equilibrium conditions, and the constraint sets
are per-stage boxes plus per-output 3-dimensional cone sets — either
"diamond" D-sets (box on harmonic amplitude, use_soc=False) or pairs of
shifted SOCs (use_soc=True). Reference:
compute_HMPC_ADMM_ingredients.m (shared offline math),
spcies_HMPC_ADMM_solver.m / code_HMPC_ADMM_C.c (single-split "reduced"
ADMM), spcies_HMPC_{ADMM,SADMM}_split_solver.m / code_HMPC_ADMM_split_C.c
(two-block split (z,s) vs (zhat,shat); SADMM = symmetric half-step duals
scaled by alpha).

Batched design: the reference's permuted-LDL sparse path is replaced by
the dense M1/M2 affine maps (its own non-sparse path,
spcies_HMPC_ADMM_solver.m:135), and all projections are batched branch-free
kernels (utils.projections). For long horizons both the single-split and
two-block split solvers have a `backend='banded'` structured-KKT path
(_make_hmpc_split_structured_kkt): arrowhead Woodbury over the stage /
harmonic blocks + block-tridiagonal Cholesky scan + tail Schur
complement, every online array O(N).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from spcies_tpu.config import Options
from spcies_tpu.formulations.base import (register_builder, get_sys_matrices,
                                          get_bounds)
from spcies_tpu.utils import linalg
from spcies_tpu.utils.projections import (proj_box, proj_soc, proj_diamond)
from spcies_tpu.solvers.common import (SolveResult, inf_norm,
                                        hist_sol_entries,
                                        delta_dot, delta_dot_op)
from spcies_tpu.solvers.loop import run_masked_loop
from spcies_tpu.api import BatchedSolver


def harmonic_hessian(Q, R, Te, Th, Se, Sh, w, N, n, m):
    """The harmonic Hessian blocks H11/H12/H13/H22/H23/H33
    (compute_HMPC_ADMM_ingredients.m:83-137)."""
    j = np.arange(N)
    s_j = np.sin(w * j)
    c_j = np.cos(w * j)
    s_sum, c_sum = s_j.sum(), c_j.sum()
    s2_sum, c2_sum = (s_j ** 2).sum(), (c_j ** 2).sum()
    sc_sum = (s_j * c_j).sum()

    H11 = linalg.blkdiag(R, *([linalg.blkdiag(Q, R)] * (N - 1)))
    ns = (N - 1) * (n + m) + m
    H12 = np.zeros((ns, 3 * n))
    for jj in range(N - 1):
        r = jj * (n + m) + m
        H12[r:r + n] = np.hstack([-Q, -s_j[jj + 1] * Q, -c_j[jj + 1] * Q])
    H13 = np.zeros((ns, 3 * m))
    for jj in range(N):
        r = jj * (n + m)
        H13[r:r + m] = np.hstack([-R, -s_j[jj] * R, -c_j[jj] * R])
    H22 = np.block([[Te + N * Q, s_sum * Q, c_sum * Q],
                    [s_sum * Q, Th + s2_sum * Q, sc_sum * Q],
                    [c_sum * Q, sc_sum * Q, Th + c2_sum * Q]])
    H33 = np.block([[Se + N * R, s_sum * R, c_sum * R],
                    [s_sum * R, Sh + s2_sum * R, sc_sum * R],
                    [c_sum * R, sc_sum * R, Sh + c2_sum * R]])
    H23 = np.zeros((3 * n, 3 * m))
    return np.block([[H11, H12, H13],
                     [H12.T, H22, H23],
                     [H13.T, H23.T, H33]])


def harmonic_equality_matrix(A, B, w, N):
    """G: stage dynamics, terminal harmonic coupling at phase w*N, and the
    3n harmonic-equilibrium rows (compute_HMPC_ADMM_ingredients.m:140-152).
    Returns (G, n_eq); beq is zero except beq[:n] = -A x0."""
    n, m = A.shape[0], B.shape[1]
    ns = (N - 1) * (n + m) + m
    dim = ns + 3 * (n + m)
    G = np.zeros((N * n + 3 * n, dim))
    # row 0: B u0 - x1 = -A x0
    G[:n, :m] = B
    G[:n, m:m + n] = -np.eye(n)
    # rows l = 1..N-1 over stage (x_l, u_l); row N-1 couples to the harmonic
    for l in range(1, N):
        r = l * n
        c = m + (l - 1) * (n + m)
        G[r:r + n, c:c + n] = A
        G[r:r + n, c + n:c + n + m] = B
        if l < N - 1:
            G[r:r + n, c + n + m:c + 2 * n + m] = -np.eye(n)
    # terminal: A x_{N-1} + B u_{N-1} = xe + sin(wN) xs + cos(wN) xc
    r = (N - 1) * n
    G[r:r + n, ns:ns + n] = -np.eye(n)
    G[r:r + n, ns + n:ns + 2 * n] = -np.sin(w * N) * np.eye(n)
    G[r:r + n, ns + 2 * n:ns + 3 * n] = -np.cos(w * N) * np.eye(n)
    # harmonic equilibrium (A - I, A - cos(w) I +- sin(w) I pattern)
    cw, sw = np.cos(w), np.sin(w)
    r = N * n
    he = ns
    hu = ns + 3 * n
    G[r:r + n, he:he + n] = A - np.eye(n)
    G[r:r + n, hu:hu + m] = B
    G[r + n:r + 2 * n, he + n:he + 2 * n] = A - cw * np.eye(n)
    G[r + n:r + 2 * n, he + 2 * n:he + 3 * n] = sw * np.eye(n)
    G[r + n:r + 2 * n, hu + m:hu + 2 * m] = B
    G[r + 2 * n:r + 3 * n, he + n:he + 2 * n] = -sw * np.eye(n)
    G[r + 2 * n:r + 3 * n, he + 2 * n:he + 3 * n] = A - cw * np.eye(n)
    G[r + 2 * n:r + 3 * n, hu + 2 * m:hu + 3 * m] = B
    return G, G.shape[0]


def _soc_cone_rows(E, F, LBy, UBy, n, m):
    """C_aux rows + d for the shifted-SOC harmonic constraints: per output
    j, a (UB, LB) pair of 3-row cones (compute_HMPC_ADMM_ingredients.m
    use_soc branch)."""
    n_y = E.shape[0]
    rows = []
    dsoc = []
    for j in range(n_y):
        Ej, Fj = E[j:j + 1], F[j:j + 1]
        Eub = linalg.blkdiag(Ej, -Ej, -Ej)
        Elb = linalg.blkdiag(-Ej, -Ej, -Ej)
        Fub = linalg.blkdiag(Fj, -Fj, -Fj)
        Flb = linalg.blkdiag(-Fj, -Fj, -Fj)
        rows.append(np.hstack([Eub, Fub]))
        rows.append(np.hstack([Elb, Flb]))
        dsoc.extend([UBy[j], 0.0, 0.0, -LBy[j], 0.0, 0.0])
    return np.vstack(rows), np.asarray(dsoc), 2 * n_y


def _diamond_cone_rows(E, F, n, m):
    """C_aux for the D-set (diamond) harmonic constraints: per output j,
    kron(I_3, -E_j) | kron(I_3, -F_j)."""
    n_y = E.shape[0]
    rows = []
    for j in range(n_y):
        rows.append(np.hstack([linalg.blkdiag(*([-E[j:j + 1]] * 3)),
                               linalg.blkdiag(*([-F[j:j + 1]] * 3))]))
    return np.vstack(rows), np.zeros(3 * n_y), n_y


def hmpc_common_ingredients(sys: dict, param: dict, opt: Options,
                            split: bool) -> dict:
    """Offline math shared by the single and split HMPC solvers."""
    A, B, n, m = get_sys_matrices(sys)
    N = int(param["N"])
    w = float(param["w"])
    Q = np.asarray(param["Q"], dtype=float)
    R = np.asarray(param["R"], dtype=float)
    Te = np.asarray(param["Te"], dtype=float)
    Th = np.asarray(param["Th"], dtype=float)
    Se = np.asarray(param["Se"], dtype=float)
    Sh = np.asarray(param["Sh"], dtype=float)
    ns = (N - 1) * (n + m) + m     # stage part of z
    dim = ns + 3 * (n + m)

    if opt.solver.get("sparse", False):
        # The reference's sparse mode is a permuted LDL of the KKT
        # (compute_HMPC_ADMM_ingredients.m:241-250,
        # code_HMPC_ADMM_split_C.c:192-211) — a CPU-cache optimization.
        # This framework bakes the algebraically identical dense M1/M2
        # maps (the reference's own NON_SPARSE path) because structured
        # dense matmuls are the batched form; accepting sparse=True
        # silently would misrepresent what runs.
        raise ValueError(
            "HMPC sparse=True (permuted-LDL KKT) is not supported: the "
            "batched engine always uses the dense M1/M2 KKT maps, which are "
            "algebraically identical (reference NON_SPARSE path). "
            "Use sparse=False (default).")
    box_constraints = opt.solver.get("box_constraints", None)
    if box_constraints is None or box_constraints == []:
        # auto-detect (cons_HMPC_ADMM_C.m:57-63)
        box_constraints = "E" not in sys
    use_soc = bool(opt.solver.get("use_soc", False))

    if box_constraints:
        E = np.vstack([np.eye(n), np.zeros((m, n))])
        F = np.vstack([np.zeros((n, m)), np.eye(m)])
        LBx, UBx, LBu, UBu = get_bounds(sys, n, m, opt.inf_value)
        LBy = np.concatenate([LBx, LBu])
        UBy = np.concatenate([UBx, UBu])
    else:
        E = np.asarray(sys["E"], dtype=float)
        F = np.asarray(sys["F"], dtype=float)
        LBy = np.asarray(sys["LBy"], dtype=float).ravel()
        UBy = np.asarray(sys["UBy"], dtype=float).ravel()
    n_y = E.shape[0]

    H = harmonic_hessian(Q, R, Te, Th, Se, Sh, w, N, n, m)
    G, n_eq = harmonic_equality_matrix(A, B, w, N)

    if use_soc:
        C_aux, dsoc, n_soc = _soc_cone_rows(E, F, LBy, UBy, n, m)
    else:
        C_aux, dsoc, n_soc = _diamond_cone_rows(E, F, n, m)

    if box_constraints:
        stage_LB = np.concatenate(
            [sys_lb for sys_lb in
             [LBy[n:]] + [LBy] * (N - 1)])  # (u_0, (x,u) x N-1)
        stage_UB = np.concatenate([UBy[n:]] + [UBy] * (N - 1))
        if split:
            C = np.hstack([np.zeros((C_aux.shape[0], dim - 3 * (n + m))),
                           C_aux])
            d = dsoc
            n_box = 0
        else:
            C = linalg.blkdiag(-np.eye(m),
                               *([-np.eye(n + m)] * (N - 1)), C_aux)
            d = np.concatenate([np.zeros(ns), dsoc])
            n_box = ns
        box_LB, box_UB = stage_LB, stage_UB
    else:
        Cstage = linalg.blkdiag(-F, *([np.hstack([-E, -F])] * (N - 1)))
        C = linalg.blkdiag(Cstage, C_aux)
        d = np.concatenate([np.zeros(N * n_y), dsoc])
        n_box = N * n_y
        box_LB = np.tile(LBy, N)
        box_UB = np.tile(UBy, N)
        stage_LB = stage_UB = None
    n_s = C.shape[0]

    return dict(
        n=n, m=m, N=N, n_y=n_y, ns=ns, dim=dim, n_eq=n_eq, n_s=n_s,
        n_box=n_box, n_soc=n_soc, A=A, B=B, Q=Q, Te=Te, Se=Se, Th=Th,
        Sh=Sh,
        H=H, G=G, C=C, d=d,
        box_constraints=box_constraints, use_soc=use_soc,
        box_LB=box_LB, box_UB=box_UB,
        stage_LB=stage_LB, stage_UB=stage_UB,
        LBy=LBy, UBy=UBy,
    )


def _make_q(ing, x0, xr, ur, dtype):
    """q = -[0...; Te xr + Q x0; 0_n; Q x0; Se ur; 0_{2m}].

    The Q x0 terms on the xe and xc blocks are the linear part of the fixed
    j=0 stage cost ||x_0 - (xe + cos(0) xc)||_Q^2 — present in the
    authoritative generated C (code_HMPC_ADMM_C.c:92-101,
    code_HMPC_ADMM_split_C.c:117-122, consistent with H22's N*Q term) but
    MISSING from the reference's MATLAB mirror solvers
    (spcies_HMPC_ADMM_solver.m:116) — an upstream mirror bug this framework
    does not reproduce."""
    n, m, ns = ing["n"], ing["m"], ing["ns"]
    Q = jnp.asarray(ing["Q"], dtype)
    Te = jnp.asarray(ing["Te"], dtype)
    Se = jnp.asarray(ing["Se"], dtype)
    Bsz = xr.shape[0]
    qx0 = x0 @ Q.T
    return jnp.concatenate(
        [jnp.zeros((Bsz, ns), dtype), -(xr @ Te.T) - qx0,
         jnp.zeros((Bsz, n), dtype), -qx0,
         -(ur @ Se.T), jnp.zeros((Bsz, 2 * m), dtype)], axis=-1)


def _make_cone_proj(ing, dtype):
    """Batched projection of the cone tail of s: [B, n_cones*3] -> same,
    SOC (proj_SOC3 snippet) or diamond (proj_D) per cone."""
    use_soc = ing["use_soc"]
    n_y = ing["n_y"]
    if use_soc:
        n_cones = ing["n_soc"]

        def cone_proj(tail):
            y = tail.reshape(-1, n_cones, 3)
            return proj_soc(y).reshape(tail.shape)
    else:
        LBy = jnp.asarray(ing["LBy"], dtype)
        UBy = jnp.asarray(ing["UBy"], dtype)

        def cone_proj(tail):
            y = tail.reshape(-1, n_y, 3)
            return proj_diamond(y, LBy[None, :], UBy[None, :]).reshape(
                tail.shape)
    return cone_proj


@register_builder("HMPC", "ADMM",
                  backends=("dense", "banded"))
def build_hmpc_admm(sys: dict, param: dict, opt: Options,
                    backend: str = "dense") -> BatchedSolver:
    """Single-split ("reduced") HMPC ADMM
    (spcies_HMPC_ADMM_solver.m:125-198, code_HMPC_ADMM_C.c)."""
    ing = hmpc_common_ingredients(sys, param, opt, split=False)
    dtype = jnp.float64 if opt.precision == "double" else jnp.float32
    n, m, N = ing["n"], ing["m"], ing["N"]
    dim, n_s, n_box = ing["dim"], ing["n_s"], ing["n_box"]
    tol_p = float(opt.solver["tol_p"])
    tol_d = float(opt.solver["tol_d"])
    k_max = int(opt.solver["k_max"])
    rho_f = float(opt.solver["rho"])
    rho = dtype(rho_f)
    rho_i = dtype(1.0 / rho_f)

    if backend == "dense":
        # dense KKT maps (compute_HMPC_ADMM_ingredients.m:252-257)
        Hh = ing["H"] + rho_f * (ing["C"].T @ ing["C"])
        Hhi = np.linalg.inv(Hh)
        G = ing["G"]
        W = G @ Hhi @ G.T
        Winv = np.linalg.inv(W)
        M1_np = Hhi @ G.T @ Winv @ G @ Hhi - Hhi
        M2_np = (Hhi @ G.T @ Winv)[:, :n]

    if backend == "banded":
        # O(N)-memory structured KKT (single-split arrowhead variant of
        # _make_hmpc_split_structured_kkt; sigma unused)
        kkt_full, kkt_lin = _make_hmpc_split_structured_kkt(
            ing, 0.0, rho_f, dtype, split=False,
            parallel_scan=bool(opt.solver.get("band_parallel_scan", False)))
    else:
        M1 = jnp.asarray(M1_np, dtype)
        M2 = jnp.asarray(M2_np, dtype)

        def kkt_full(q_hat, x0):
            return q_hat @ M1.T + (-(x0 @ A.T)) @ M2.T

        def kkt_lin(dq):
            return delta_dot(dq, M1.T)

    C = jnp.asarray(ing["C"], dtype)
    d = jnp.asarray(ing["d"], dtype)
    A = jnp.asarray(ing["A"], dtype)
    LB = jnp.asarray(ing["box_LB"], dtype)
    UB = jnp.asarray(ing["box_UB"], dtype)
    cone_proj = _make_cone_proj(ing, dtype)

    def proj_s(y):
        return jnp.concatenate(
            [proj_box(y[:, :n_box], LB, UB), cone_proj(y[:, n_box:])],
            axis=-1)

    def _solve(x0, xr, ur, init, fixed_iters):
        Bsz = x0.shape[0]
        q = _make_q(ing, x0, xr, ur, dtype)

        if init is None:
            s0 = jnp.zeros((Bsz, n_s), dtype)
            lam0 = jnp.zeros((Bsz, n_s), dtype)
        else:
            _, s0, lam0 = init

        def z_of(s, lam):
            q_hat = q + (rho * (s - d) + lam) @ C
            return kkt_full(q_hat, x0)

        z1 = z_of(s0, lam0)
        rinf = jnp.full((Bsz,), jnp.inf, dtype=dtype)
        state0 = dict(z=z1, z_next=z1, s=s0, lam=lam0, r_p=rinf, r_d=rinf)

        def body(state, _it):
            z = state["z_next"]
            s_old = state["s"]
            lam = state["lam"]
            Czd = z @ C.T - d
            s = proj_s(-Czd - rho_i * lam)
            resid = Czd + s
            lam_new = lam + rho * resid
            r_p = inf_norm(resid)
            r_d = inf_norm(s - s_old)
            conv = (r_p <= tol_p) & (r_d <= tol_d)
            # delta-form: dq_hat = C'(rho ds + dlam); both terms -> 0
            dq = delta_dot(rho * (s - s_old) + rho * resid, C)
            z_next = z + delta_dot_op(kkt_lin, dq)
            return (dict(z=z, z_next=z_next, s=s, lam=lam_new,
                         r_p=r_p, r_d=r_d), conv)

        if opt.debug:
            state, k, e_flag, hist = run_masked_loop(
                body, state0, k_max, Bsz, fixed_iters=fixed_iters,
                history_keys=("r_p", "r_d")
                + (("z", "s", "lam")
                   if int(opt.debug) >= 2 else ()))
        else:
            state, k, e_flag = run_masked_loop(body, state0, k_max, Bsz,
                                               fixed_iters=fixed_iters)
            hist = None
        z = state["z"]
        return SolveResult(u=z[:, :m], k=k, e_flag=e_flag,
                           sol=dict(z=z, s=state["s"], lam=state["lam"],
                                    r_p=state["r_p"], r_d=state["r_d"],
                     **hist_sol_entries(hist)))

    return BatchedSolver(_solve, ing, opt, n=n, m=m, N=N, nz=dim,
                         dtype=dtype)


def _make_hmpc_split_structured_kkt(ing, sigma_f, rho_f, dtype,
                                    split: bool = True,
                                    parallel_scan: bool = False):
    """O(N)-memory KKT maps for the HMPC solvers — the harmonic analogue
    of MPCT-semiband's two-level structure
    (mpct._make_semiband_structured_z_step).

    split=True: the two-block split KKT over (z, s) — Hz = H + sigma I,
    Gh = [G 0; C I] (code_HMPC_ADMM_split_C.c). Returns
    (kkt_full(qz, qs, x0), kkt_lin(dqz, dqs)).

    split=False: the single-split ("reduced") KKT — Hz = H + rho C'C,
    Gh = G (code_HMPC_ADMM_C.c). In box mode C'C = blkdiag(I_ns,
    Caux'Caux), so the arrowhead structure is identical: per-stage
    blocks shift by rho I and the harmonic block by rho Caux'Caux.
    Returns (kkt_full(qz, x0), kkt_lin(dqz)).

    The harmonic KKT is an arrowhead: Hz = H + sigma I = Gamma + Us Vs'
    where Gamma is block-diagonal (per-stage cost blocks + the small
    harmonic block Hc) and Us Vs' is the rank-2r stage<->harmonic cost
    coupling (r = 3(n+m), the H12/H13 border of harmonic_hessian). With
    the level-1 Woodbury Hz^-1 = Gamma^-1 - Gu K1 Gv', the dual system
    Gt = Gh Gammah^-1 Gh' is block-tridiagonal over the N dynamics rows
    plus a dense O(1) tail (the 3n equilibrium rows and the n_s cone rows,
    which touch only the harmonic block), so W = Gt - Ut K1 Vt' solves as
    band-Cholesky scan + tail Schur complement + level-2 Woodbury. All
    online ops are stage-local; nothing O(N^2) is materialized at runtime
    (dense Gt/Gamma^-1 below are offline-only temporaries, as in the
    semiband backend). Replaces the reference's permuted sparse LDL
    (compute_HMPC_ADMM_ingredients.m:241-250) for long horizons.

    Returns (kkt_full(qz, qs, x0), kkt_lin(dqz, dqs)) computing
    aux = Hh^-1 Gh' W^-1 (Gh Hh^-1 q + bh) - Hh^-1 q, i.e. the action of
    the dense path's (M1, M2) without forming them. parallel_scan selects
    the O(log N)-depth associative-scan band solve for long horizons."""
    from spcies_tpu.kernels.band_chol import (band_chol_solve,
                                              band_chol_solve_scan)
    band_solve = band_chol_solve_scan if parallel_scan else band_chol_solve
    n, m, N = ing["n"], ing["m"], ing["N"]
    ns, dim, n_eq, n_s = ing["ns"], ing["dim"], ing["n_eq"], ing["n_s"]
    if not ing["box_constraints"]:
        raise ValueError(
            "the banded HMPC split backend supports box constraints only "
            "(coupled-output cone rows are stage-local and keep the dense "
            "backend); use backend='dense'")
    if N < 3:
        raise ValueError("the banded HMPC backend requires N >= 3")
    nm = n + m
    r = 3 * nm
    H, G, C = ing["H"], ing["G"], ing["C"]
    A_np = ing["A"]
    B_np = ing["B"]
    d_np = ing["d"]

    # --- offline: level-1 arrowhead Woodbury --------------------------
    if split:
        # Hz = H + sigma I
        D0 = H[:m, :m] + sigma_f * np.eye(m)
        Dj = H[m:m + nm, m:m + nm] + sigma_f * np.eye(nm)  # stages 1..N-1
        Hc = H[ns:, ns:] + sigma_f * np.eye(r)
    else:
        # Hz = H + rho C'C, box mode: C'C = blkdiag(I_ns, Caux'Caux)
        Caux_np = C[ing["n_box"]:, ns:]
        D0 = H[:m, :m] + rho_f * np.eye(m)
        Dj = H[m:m + nm, m:m + nm] + rho_f * np.eye(nm)
        Hc = H[ns:, ns:] + rho_f * (Caux_np.T @ Caux_np)
    D0i = np.linalg.inv(D0)
    Dji = np.linalg.inv(Dj)
    Hci = np.linalg.inv(Hc)
    Uc = H[:ns, ns:]                                   # stage<->harmonic border
    Us = np.zeros((dim, 2 * r))
    Us[:ns, r:] = Uc
    Us[ns:, :r] = np.eye(r)
    Vs = np.zeros((dim, 2 * r))
    Vs[:ns, :r] = Uc
    Vs[ns:, r:] = np.eye(r)
    Gzi = linalg.blkdiag(D0i, *([Dji] * (N - 1)), Hci)  # offline temporary
    Gu_np = Gzi @ Us
    Gv_np = Gzi @ Vs
    K1_np = np.linalg.inv(np.eye(2 * r) + Vs.T @ Gu_np)

    # --- offline: banded + tail dual system ---------------------------
    if split:
        Ghz = np.vstack([G, C])
        Gt = Ghz @ Gzi @ Ghz.T
        Gt[n_eq:, n_eq:] += (1.0 / rho_f) * np.eye(n_s)
    else:
        Ghz = G
        Gt = Ghz @ Gzi @ Ghz.T
    Nn = N * n
    nt = Ghz.shape[0] - Nn                  # 3n (+ n_s cone rows if split)
    Wb = Gt[:Nn, :Nn]
    Pfull = Gt[:Nn, Nn:]
    Wt = Gt[Nn:, Nn:]
    # structural sanity: tail couples only through the last dynamics row
    assert np.abs(Pfull[:Nn - n]).max() < 1e-9 * max(1.0, np.abs(Gt).max())
    Wd = np.stack([Wb[k * n:(k + 1) * n, k * n:(k + 1) * n]
                   for k in range(N)])
    Wu = np.stack([Wb[k * n:(k + 1) * n, (k + 1) * n:(k + 2) * n]
                   for k in range(N - 1)])
    Alpha_np, BetaInv_np = linalg.band_chol_blocks_tridiag(Wd, Wu)
    Fp_np = np.linalg.solve(Wb, Pfull)                 # [Nn, nt], O(N) memory
    Sti_np = np.linalg.inv(Wt - Pfull.T @ Fp_np)
    # level-2 Woodbury: W = Gt - Ut K1 Vt'
    Ut_np = Ghz @ Gu_np
    Vt_np = Ghz @ Gv_np
    Pu_np = np.linalg.solve(Gt, Ut_np)
    K2_np = np.linalg.inv(np.linalg.inv(K1_np) - Vt_np.T @ Pu_np)

    # --- online constants ---------------------------------------------
    D0i_j = jnp.asarray(D0i, dtype)
    Dji_j = jnp.asarray(Dji, dtype)
    Hci_j = jnp.asarray(Hci, dtype)
    Gu = jnp.asarray(Gu_np, dtype)
    GvK1t = jnp.asarray(Gv_np @ K1_np.T, dtype)        # fold K1 into Gv
    A_ = jnp.asarray(A_np, dtype)
    B_ = jnp.asarray(B_np, dtype)
    Th_ = jnp.asarray(G[(N - 1) * n:Nn, ns:], dtype)   # terminal harmonic coefs
    Eqh = jnp.asarray(G[Nn:, ns:], dtype)              # equilibrium rows
    Caux = jnp.asarray(C[:, dim - r:], dtype)          # cone rows (harmonic)
    d_j = jnp.asarray(d_np, dtype)
    Alpha = jnp.asarray(Alpha_np, dtype)
    BetaInv = jnp.asarray(BetaInv_np, dtype)
    Fp = jnp.asarray(Fp_np, dtype)
    Sti = jnp.asarray(Sti_np, dtype)
    # row-vector form: (g @ Vt) @ (Pu K2).T = g Vt K2' Pu', the operator
    # Gt^-1 Ut K2 Vt' Gt^-1 (K2 is NOT symmetric — Pu @ K2.T is wrong)
    PuK2t = jnp.asarray(Pu_np @ K2_np, dtype)
    Vt = jnp.asarray(Vt_np, dtype)
    rho_i = dtype(1.0 / rho_f)

    def hz_inv(qz):
        """Hz^-1 qz: stage-local Gamma^-1 + rank-2r correction."""
        u0 = qz[:, :m] @ D0i_j
        st = jnp.einsum("bls,ts->blt",
                        qz[:, m:ns].reshape(-1, N - 1, nm), Dji_j)
        hm = qz[:, ns:] @ Hci_j
        g = jnp.concatenate([u0, st.reshape(qz.shape[0], -1), hm], axis=-1)
        return g - (qz @ GvK1t) @ Gu.T

    def gh_apply(hz, hs):
        """Gh (hz[, hs]) -> (band rows [B, N, n], tail [B, nt]);
        split: Gh = [G 0; C I], single: Gh = G (hs is None)."""
        u0 = hz[:, :m]
        st = hz[:, m:ns].reshape(-1, N - 1, nm)
        hm = hz[:, ns:]
        x, u = st[..., :n], st[..., n:]
        r0 = u0 @ B_.T - x[:, 0]
        rl = x[:, :N - 2] @ A_.T + u[:, :N - 2] @ B_.T - x[:, 1:]
        rN1 = x[:, N - 2] @ A_.T + u[:, N - 2] @ B_.T + hm @ Th_.T
        rb = jnp.concatenate([r0[:, None], rl, rN1[:, None]], axis=1)
        if split:
            rt = jnp.concatenate([hm @ Eqh.T, hm @ Caux.T + hs], axis=-1)
        else:
            rt = hm @ Eqh.T
        return rb, rt

    def ght_apply(wb, wt):
        """Gh' (wb, wt) -> z rows [B, dim] (+ s rows [B, n_s] if split)."""
        weq = wt[:, :3 * n]
        u0 = wb[:, 0] @ B_
        xj = jnp.einsum("blj,ji->bli", wb[:, 1:], A_) - wb[:, :N - 1]
        uj = jnp.einsum("blj,ji->bli", wb[:, 1:], B_)
        hm = wb[:, N - 1] @ Th_ + weq @ Eqh
        if split:
            wcone = wt[:, 3 * n:]
            hm = hm + wcone @ Caux
        st = jnp.concatenate([xj, uj], axis=-1).reshape(wb.shape[0], -1)
        gz = jnp.concatenate([u0, st, hm], axis=-1)
        return (gz, wcone) if split else gz

    def w_solve(rb, rt):
        """W^-1 over (band, tail): band scan + tail Schur + level-2."""
        Bsz = rb.shape[0]
        u1 = band_solve(rb, Alpha, BetaInv).reshape(Bsz, Nn)
        bt = (rt - rb.reshape(Bsz, Nn) @ Fp) @ Sti.T
        g = jnp.concatenate([u1 - bt @ Fp.T, bt], axis=-1)
        g = g + (g @ Vt) @ PuK2t.T
        return g[:, :Nn].reshape(Bsz, N, n), g[:, Nn:]

    if split:
        def _kkt(qz, qs, x0):
            hz = hz_inv(qz)
            hs = qs * rho_i
            rb, rt = gh_apply(hz, hs)
            if x0 is not None:
                rb = rb.at[:, 0].add(-(x0 @ A_.T))   # beq[:n] = -A x0
                rt = rt.at[:, 3 * n:].add(d_j)       # cone rows d
            wb, wt = w_solve(rb, rt)
            gz, gs = ght_apply(wb, wt)
            return hz_inv(gz) - hz, gs * rho_i - hs

        def kkt_full(qz, qs, x0):
            return _kkt(qz, qs, x0)

        def kkt_lin(dqz, dqs):
            return _kkt(dqz, dqs, None)
    else:
        # single-split: the cone offset d enters through q_hat outside
        # (code_HMPC_ADMM_C.c builds q_hat = q + C'(rho(s - d) + lam))
        def _kkt(q_hat, x0):
            hz = hz_inv(q_hat)
            rb, rt = gh_apply(hz, None)
            if x0 is not None:
                rb = rb.at[:, 0].add(-(x0 @ A_.T))   # beq[:n] = -A x0
            wb, wt = w_solve(rb, rt)
            gz = ght_apply(wb, wt)
            return hz_inv(gz) - hz

        def kkt_full(q_hat, x0):
            return _kkt(q_hat, x0)

        def kkt_lin(dq):
            return _kkt(dq, None)

    return kkt_full, kkt_lin


def _build_hmpc_split(sys, param, opt, symmetric: bool,
                      backend: str = "dense"):
    """Two-block split HMPC solver, plain (ADMM) or symmetric (SADMM)
    (spcies_HMPC_{ADMM,SADMM}_split_solver.m, code_HMPC_ADMM_split_C.c;
    IS_SYMMETRIC define = `symmetric`)."""
    ing = hmpc_common_ingredients(sys, param, opt, split=True)
    dtype = jnp.float64 if opt.precision == "double" else jnp.float32
    n, m, N = ing["n"], ing["m"], ing["N"]
    dim, n_s, ns = ing["dim"], ing["n_s"], ing["ns"]
    box_mode = ing["box_constraints"]
    tol_p = float(opt.solver["tol_p"])
    tol_d = float(opt.solver["tol_d"])
    k_max = int(opt.solver["k_max"])
    rho_f = float(opt.solver["rho"])
    sigma_f = float(opt.solver["sigma"])
    rho = dtype(rho_f)
    sigma = dtype(sigma_f)
    rho_i = dtype(1.0 / rho_f)
    sigma_i = dtype(1.0 / sigma_f)
    alpha = dtype(float(opt.solver["alpha"]) if symmetric else 1.0)

    n_eq = ing["n_eq"]
    if backend == "dense":
        # dense KKT maps over (z, s)
        # (compute_HMPC_ADMM_split_ingredients.m:219-240)
        Hh = linalg.blkdiag(ing["H"] + sigma_f * np.eye(dim),
                            rho_f * np.eye(n_s))
        Gh = np.block([[ing["G"], np.zeros((n_eq, n_s))],
                       [ing["C"], np.eye(n_s)]])
        Hhi = np.linalg.inv(Hh)
        W = Gh @ Hhi @ Gh.T
        Winv = np.linalg.inv(W)
        M1_np = Hhi @ Gh.T @ Winv @ Gh @ Hhi - Hhi
        M2_np = Hhi @ Gh.T @ Winv

    if backend == "banded":
        # O(N)-memory structured-KKT path (arrowhead Woodbury + band
        # Cholesky scan), the harmonic analogue of MPCT-semiband — the
        # reference's long-horizon role of the permuted sparse LDL
        # (compute_HMPC_ADMM_ingredients.m:241-250)
        kkt_full, kkt_lin = _make_hmpc_split_structured_kkt(
            ing, sigma_f, rho_f, dtype,
            parallel_scan=bool(opt.solver.get("band_parallel_scan", False)))

        def kkt_init(q_hat, x0):
            az, as_ = kkt_full(q_hat[:, :dim], q_hat[:, dim:], x0)
            return jnp.concatenate([az, as_], axis=-1)

        def kkt_delta(dq):
            az, as_ = kkt_lin(dq[:, :dim], dq[:, dim:])
            return jnp.concatenate([az, as_], axis=-1)
    elif backend == "dense":
        M1 = jnp.asarray(M1_np, dtype)
        M2_b0 = jnp.asarray(M2_np[:, :n], dtype)
        aux_d = jnp.asarray(M2_np[:, n_eq:] @ ing["d"], dtype)
        A_dense = jnp.asarray(ing["A"], dtype)

        def kkt_init(q_hat, x0):
            return q_hat @ M1.T + (-(x0 @ A_dense.T)) @ M2_b0.T + aux_d

        def kkt_delta(dq):
            return delta_dot(dq, M1.T)
    else:
        raise ValueError(f"unknown backend {backend!r} for HMPC split")

    cone_proj = _make_cone_proj(ing, dtype)
    n_box = ing["n_box"]
    if box_mode:
        zLB = jnp.asarray(ing["box_LB"], dtype)
        zUB = jnp.asarray(ing["box_UB"], dtype)

        def proj_z(z):
            return jnp.concatenate(
                [proj_box(z[:, :ns], zLB, zUB), z[:, ns:]], axis=-1)

        def proj_s(y):
            return cone_proj(y)
    else:
        sLB = jnp.asarray(ing["box_LB"], dtype)
        sUB = jnp.asarray(ing["box_UB"], dtype)

        def proj_z(z):
            return z

        def proj_s(y):
            return jnp.concatenate(
                [proj_box(y[:, :n_box], sLB, sUB), cone_proj(y[:, n_box:])],
                axis=-1)

    def _solve(x0, xr, ur, init, fixed_iters):
        Bsz = x0.shape[0]
        q = _make_q(ing, x0, xr, ur, dtype)

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

        aux1 = kkt_init(q_hat_of(z0_, s0, lam0, mu0), x0)
        rinf = jnp.full((Bsz,), jnp.inf, dtype=dtype)
        state0 = dict(aux=aux1, aux_next=aux1, z=z0_, s=s0,
                      lam=lam0, mu=mu0, r_p=rinf, r_d=rinf)

        def body(state, _it):
            aux = state["aux_next"]
            z_hat, s_hat = aux[:, :dim], aux[:, dim:]
            z_old, s_old = state["z"], state["s"]
            lam, mu = state["lam"], state["mu"]
            # carried values that built the CURRENT aux (for delta-form)
            lam_at_aux, mu_at_aux = lam, mu
            if symmetric:
                # half-step duals with the previous (z, s)
                # (code_HMPC_ADMM_split_C.c:215-225)
                lam = lam + alpha * sigma * (z_hat - z_old)
                mu = mu + alpha * rho * (s_hat - s_old)
            z = proj_z(z_hat + sigma_i * lam)
            s = proj_s(s_hat + rho_i * mu)
            lam_new = lam + alpha * sigma * (z_hat - z)
            mu_new = mu + alpha * rho * (s_hat - s)
            r_p = jnp.maximum(inf_norm(z_hat - z), inf_norm(s_hat - s))
            r_d = jnp.maximum(inf_norm(z - z_old), inf_norm(s - s_old))
            conv = (r_p <= tol_p) & (r_d <= tol_d)
            # delta-form: next q_hat differs by
            # [-sigma dz + dlam; dmu - rho ds], each difference -> 0
            dq = jnp.concatenate(
                [-sigma * (z - z_old) + (lam_new - lam_at_aux),
                 (mu_new - mu_at_aux) - rho * (s - s_old)], axis=-1)
            aux_next = aux + delta_dot_op(kkt_delta, dq)
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
            sol=dict(z=z, s=state["s"], z_hat=aux[:, :dim],
                     s_hat=aux[:, dim:], lam=state["lam"], mu=state["mu"],
                     r_p=state["r_p"], r_d=state["r_d"],
                     **hist_sol_entries(hist)))

    return BatchedSolver(_solve, ing, opt, n=n, m=m, N=N, nz=dim,
                         dtype=dtype)


@register_builder("HMPC", "ADMM", "split",
                  backends=("dense", "banded"))
def build_hmpc_admm_split(sys, param, opt, backend: str = "dense"):
    return _build_hmpc_split(sys, param, opt, symmetric=False,
                             backend=backend)


@register_builder("HMPC", "SADMM", "split",
                  backends=("dense", "banded"))
def build_hmpc_sadmm_split(sys, param, opt, backend: str = "dense"):
    return _build_hmpc_split(sys, param, opt, symmetric=True,
                             backend=backend)


# ---------------------------------------------------------------------------
# ellipHMPC — harmonic MPC with coupled-output constraints
# ---------------------------------------------------------------------------

@register_builder("ellipHMPC", "ADMM",
                  backends=("dense",))
def build_elliphmpc_admm(sys: dict, param: dict, opt: Options,
                         backend: str = "dense") -> BatchedSolver:
    """Harmonic MPC with coupled-output constraints
    (compute_ellipHMPC_ADMM_ingredients.m, code_ellipHMPC_ADMM_C.c).

    Same single-split ADMM engine as HMPC/ADMM in output-constraint mode,
    with two differences: (1) the reference is given DECOMPOSED into
    harmonic components — the solver takes (x0, xre, xrs, xrc, ure, urs,
    urc), 7 inputs like the generated MEX
    (struct_ellipHMPC_ADMM_C_Matlab.c:27); (2) the D-set projections use
    sigma-tightened output bounds (vars.LBy/UBy,
    compute_ellipHMPC_ADMM_ingredients.m:230-231)."""
    if "E" not in sys:
        raise ValueError("ellipHMPC requires coupled-output matrices "
                         "sys['E'], sys['F'] and bounds LBy/UBy")
    opt.solver["box_constraints"] = False
    ing = hmpc_common_ingredients(sys, param, opt, split=False)
    dtype = jnp.float64 if opt.precision == "double" else jnp.float32
    n, m, N = ing["n"], ing["m"], ing["N"]
    dim, n_s, n_box = ing["dim"], ing["n_s"], ing["n_box"]
    tol_p = float(opt.solver["tol_p"])
    tol_d = float(opt.solver["tol_d"])
    k_max = int(opt.solver["k_max"])
    rho_f = float(opt.solver["rho"])
    sigma = float(opt.solver.get("sigma", 0.0))
    rho = dtype(rho_f)
    rho_i = dtype(1.0 / rho_f)

    Hh = ing["H"] + rho_f * (ing["C"].T @ ing["C"])
    Hhi = np.linalg.inv(Hh)
    G = ing["G"]
    W = G @ Hhi @ G.T
    Winv = np.linalg.inv(W)
    M1_np = Hhi @ G.T @ Winv @ G @ Hhi - Hhi
    M2_np = (Hhi @ G.T @ Winv)[:, :n]

    M1 = jnp.asarray(M1_np, dtype)
    M2 = jnp.asarray(M2_np, dtype)
    C = jnp.asarray(ing["C"], dtype)
    d = jnp.asarray(ing["d"], dtype)
    A = jnp.asarray(ing["A"], dtype)
    LB = jnp.asarray(ing["box_LB"], dtype)
    UB = jnp.asarray(ing["box_UB"], dtype)
    # sigma-tightened D-set bounds for the harmonic cone projections
    ing_t = dict(ing, LBy=ing["LBy"] + sigma, UBy=ing["UBy"] - sigma)
    cone_proj = _make_cone_proj(ing_t, dtype)

    Qm = jnp.asarray(ing["Q"], dtype)
    Te = jnp.asarray(ing["Te"], dtype)
    Th = jnp.asarray(ing["Th"], dtype)
    Se = jnp.asarray(ing["Se"], dtype)
    Sh = jnp.asarray(ing["Sh"], dtype)
    ns = ing["ns"]

    def proj_s(y):
        return jnp.concatenate(
            [proj_box(y[:, :n_box], LB, UB), cone_proj(y[:, n_box:])],
            axis=-1)

    def _solve(x0, xre, xrs, xrc, ure, urs, urc, init, fixed_iters):
        Bsz = x0.shape[0]
        qx0 = x0 @ Qm.T
        # q update per code_ellipHMPC_ADMM_C.c:100-130
        q = jnp.concatenate(
            [jnp.zeros((Bsz, ns), dtype),
             -(xre @ Te.T) - qx0, -(xrs @ Th.T), -(xrc @ Th.T) - qx0,
             -(ure @ Se.T), -(urs @ Sh.T), -(urc @ Sh.T)], axis=-1)
        b0 = -(x0 @ A.T)
        aux_b = b0 @ M2.T

        if init is None:
            s0 = jnp.zeros((Bsz, n_s), dtype)
            lam0 = jnp.zeros((Bsz, n_s), dtype)
        else:
            _, s0, lam0 = init

        z1 = (q + (rho * (s0 - d) + lam0) @ C) @ M1.T + aux_b
        rinf = jnp.full((Bsz,), jnp.inf, dtype=dtype)
        state0 = dict(z=z1, z_next=z1, s=s0, lam=lam0, r_p=rinf, r_d=rinf)

        def body(state, _it):
            z = state["z_next"]
            s_old = state["s"]
            lam = state["lam"]
            Czd = z @ C.T - d
            s = proj_s(-Czd - rho_i * lam)
            resid = Czd + s
            lam_new = lam + rho * resid
            r_p = inf_norm(resid)
            r_d = inf_norm(s - s_old)
            conv = (r_p <= tol_p) & (r_d <= tol_d)
            dq = delta_dot(rho * (s - s_old) + rho * resid, C)
            z_next = z + delta_dot(dq, M1.T)
            return (dict(z=z, z_next=z_next, s=s, lam=lam_new,
                         r_p=r_p, r_d=r_d), conv)

        if opt.debug:
            state, k, e_flag, hist = run_masked_loop(
                body, state0, k_max, Bsz, fixed_iters=fixed_iters,
                history_keys=("r_p", "r_d")
                + (("z", "s", "lam")
                   if int(opt.debug) >= 2 else ()))
        else:
            state, k, e_flag = run_masked_loop(body, state0, k_max, Bsz,
                                               fixed_iters=fixed_iters)
            hist = None
        z = state["z"]
        return SolveResult(u=z[:, :m], k=k, e_flag=e_flag,
                           sol=dict(z=z, s=state["s"], lam=state["lam"],
                                    r_p=state["r_p"], r_d=state["r_d"],
                     **hist_sol_entries(hist)))

    return BatchedSolver(
        _solve, ing, opt, n=n, m=m, N=N, nz=dim, dtype=dtype,
        input_names=("x0", "xre", "xrs", "xrc", "ure", "urs", "urc"))
