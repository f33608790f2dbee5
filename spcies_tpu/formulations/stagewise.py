"""Structured stagewise operators shared by the banded backends.

The decision vector of the laxMPC/equMPC family is stage-ordered
z = (u_0, x_1, u_1, ..., x_{N-1}, u_{N-1}[, x_N]) and the equality matrix G
is block-banded (reference Aeq construction,
compute_laxMPC_ADMM_ingredients.m:80-86 /
compute_equMPC_ADMM_ingredients.m:85). Instead of materializing G, these
helpers apply G and G^T blockwise — each block op is a small batched
matmul, and memory stays O(N n (n+m)) like the
reference's banded C loops (code_laxMPC_ADMM_C.c:355-381, :453-485).

Layout convention: z splits into z0 [B, m] (u_0), zm [B, N-1, n+m]
(stages 1..N-1), and optionally zN [B, n] (x_N, `terminal=True`).
Multiplier blocks mu are [B, N, n].
"""

from __future__ import annotations

import jax.numpy as jnp


def split_z(z, n, m, N, terminal):
    B = z.shape[0]
    z0 = z[:, :m]
    zm = z[:, m:m + (N - 1) * (n + m)].reshape(B, N - 1, n + m)
    zN = z[:, -n:] if terminal else None
    return z0, zm, zN


def join_z(z0, zm, zN):
    B = z0.shape[0]
    parts = [z0, zm.reshape(B, -1)]
    if zN is not None:
        parts.append(zN)
    return jnp.concatenate(parts, axis=-1)


def g_apply(z0, zm, zN, A_, B_, AB):
    """G z -> [B, N, n]. Row 0: B u0 - x1; row l: [A B](x_l,u_l) - x_{l+1}
    (x_N present only when terminal). A_/B_/AB may carry a leading batch
    dim (per-lane model matrices, time-varying mode)."""
    n = A_.shape[-2]
    if AB.ndim == 3:
        r0 = jnp.einsum("bj,bij->bi", z0, B_) - zm[:, 0, :n]
        r_mid = jnp.einsum("blj,bij->bli", zm[:, :-1], AB) - zm[:, 1:, :n]
        r_last = jnp.einsum("bj,bij->bi", zm[:, -1], AB)
    else:
        r0 = z0 @ B_.T - zm[:, 0, :n]
        r_mid = jnp.einsum("blj,ij->bli", zm[:, :-1], AB) - zm[:, 1:, :n]
        r_last = zm[:, -1] @ AB.T
    if zN is not None:
        r_last = r_last - zN
    return jnp.concatenate([r0[:, None], r_mid, r_last[:, None]], axis=1)


def make_banded_eq_qp(ing, dtype, terminal, parallel_scan=False):
    """Build the banded equality-QP solve shared by laxMPC / equMPC /
    ellipMPC ADMM backends:

        z = argmin 0.5 z'Hhat z + q_hat'z  s.t.  G z = beq
          = -Hinv (q_hat + G' mu),   W mu = -G Hinv q_hat - beq

    with W's offline Alpha/Beta band-Cholesky blocks (the reference hot
    loop, code_laxMPC_ADMM_C.c:355-485). `ing` must provide n, m, N, A, B,
    AB, Hi_0 [m], Hi_mid [N-1, n+m] (diagonal Hinv blocks), Hi_N [n, n]
    (dense terminal block, terminal=True only), Alpha, Beta.

    Returns z_step(q_hat [B, nz], rhs_extra [B, N, n] | None) where
    rhs_extra = -beq stacked per stage (None for the pure linear map used
    by the delta-form iteration).

    parallel_scan=True routes the band solve through the O(log N)-depth
    associative-scan variant (kernels.band_chol.band_chol_solve_scan) for
    long horizons.
    """
    from spcies_tpu.kernels.band_chol import (band_chol_solve,
                                              band_chol_solve_scan,
                                              beta_inverses)
    band_solve = band_chol_solve_scan if parallel_scan else band_chol_solve
    n, m, N = ing["n"], ing["m"], ing["N"]
    Alpha_np, BetaInv_np = beta_inverses(ing["Alpha"], ing["Beta"])
    Alpha = jnp.asarray(Alpha_np, dtype)
    BetaInv = jnp.asarray(BetaInv_np, dtype)
    AB = jnp.asarray(ing["AB"], dtype)
    A_ = jnp.asarray(ing["A"], dtype)
    B_ = jnp.asarray(ing["B"], dtype)
    Hi_0 = jnp.asarray(ing["Hi_0"], dtype)
    Hi_mid = jnp.asarray(ing["Hi_mid"], dtype)
    Hi_N = jnp.asarray(ing["Hi_N"], dtype) if terminal else None

    def hinv_apply(q):
        q0, qm, qN = split_z(q, n, m, N, terminal)
        return (Hi_0 * q0, Hi_mid * qm,
                qN @ Hi_N.T if terminal else None)

    def z_step(q_hat, rhs_extra=None):
        h0, hm, hN = hinv_apply(q_hat)
        rhs = -g_apply(h0, hm, hN, A_, B_, AB)
        if rhs_extra is not None:
            rhs = rhs + rhs_extra
        mu = band_solve(rhs, Alpha, BetaInv)
        g0, gm, gN = split_z(gt_apply(mu, n, m, B_, AB, terminal),
                             n, m, N, terminal)
        z0 = -(h0 + Hi_0 * g0)
        zm = -(hm + Hi_mid * gm)
        zN = -(hN + gN @ Hi_N.T) if terminal else None
        return join_z(z0, zm, zN)

    return z_step


def gt_apply(mu, n, m, B_, AB, terminal):
    """G^T mu -> flat [B, nz]. u_0 gets B^T mu_0; stage block l (=(x_l,u_l),
    l=1..N-1) gets [A B]^T mu_l - (mu_{l-1} on the x part); x_N (terminal)
    gets -mu_{N-1}. B_/AB may carry a leading batch dim."""
    if AB.ndim == 3:
        g0 = jnp.einsum("bi,bij->bj", mu[:, 0], B_)
        gm = jnp.einsum("bli,bij->blj", mu[:, 1:], AB)
    else:
        g0 = mu[:, 0] @ B_
        gm = jnp.einsum("bli,ij->blj", mu[:, 1:], AB)
    gm = gm.at[:, :, :n].add(-mu[:, :-1])
    gN = -mu[:, -1] if terminal else None
    return join_z(g0, gm, gN)
