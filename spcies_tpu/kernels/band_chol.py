"""Banded block-Cholesky solve — the toolbox's signature KKT kernel.

Solves W mu = rhs for block-tridiagonal SPD W given its Cholesky factor's
diagonal blocks Beta and super-diagonal blocks Alpha (W = U^T U). This is
the stagewise forward+backward substitution at the heart of the reference's
laxMPC/equMPC/MPCT/ellipMPC solvers (canonical standalone version:
code_laxMPC_FISTA_C.c:577-652, `solve_W_matrix_form`).

Batched design: instead of the reference's scalar triangular loops with
inverted Beta diagonals, each Beta block's full inverse is precomputed
offline (they are tiny n x n upper-triangular matrices), so the online
recursion is 2N dependent [B, n] @ [n, n] matmuls inside two lax.scans —
latency-bound per lane but batched over B lanes. Row-vector
convention throughout: y_l = (rhs_l - y_{l-1} Alpha_{l-1}) BetaInv_l,
mu_l = (y_l - mu_{l+1} Alpha_l^T) BetaInv_l^T.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def beta_inverses(Alpha: np.ndarray, Beta: np.ndarray):
    """Offline: convert reference-style (Alpha, Beta-with-inverted-diagonal)
    blocks (utils.linalg.band_chol_blocks output) into (Alpha, BetaInv) with
    full upper-triangular inverses, the form the scan kernel consumes."""
    N, n, _ = Beta.shape
    BetaInv = np.zeros_like(Beta)
    for i in range(N):
        U = Beta[i].copy()
        d = 1.0 / np.diag(U)  # undo the reference's diagonal inversion
        U[np.arange(n), np.arange(n)] = d
        BetaInv[i] = np.linalg.inv(U)
    return Alpha, BetaInv


def band_chol_solve(rhs, Alpha, BetaInv):
    """Solve W mu = rhs with W = U^T U block-bidiagonal Cholesky structure.

    rhs:     [B, N, n]  stacked per-stage right-hand sides
    Alpha:   [N-1, n, n] super-diagonal blocks of U (possibly batched [B,...])
    BetaInv: [N, n, n]   inverses of the diagonal blocks of U
    returns  [B, N, n]
    """
    N = rhs.shape[-2]

    batched_blocks = Alpha.ndim == 4
    if batched_blocks:
        fwd_mm = lambda y, M: jnp.einsum("bi,bij->bj", y, M)
        bwd_mm = lambda y, M: jnp.einsum("bi,bji->bj", y, M)
    else:
        fwd_mm = lambda y, M: y @ M
        bwd_mm = lambda y, M: jnp.einsum("bi,ji->bj", y, M)

    # forward: y_0 = rhs_0 BetaInv_0 ; y_l = (rhs_l - y_{l-1} Alpha_{l-1}) BetaInv_l
    y0 = fwd_mm(rhs[:, 0], BetaInv[..., 0, :, :] if batched_blocks else BetaInv[0])

    def fwd_step(y_prev, inputs):
        rhs_l, Alpha_lm1, BetaInv_l = inputs
        y = fwd_mm(rhs_l - fwd_mm(y_prev, Alpha_lm1), BetaInv_l)
        return y, y

    if batched_blocks:
        xs = (jnp.moveaxis(rhs[:, 1:], 1, 0),
              jnp.moveaxis(Alpha, 1, 0),
              jnp.moveaxis(BetaInv[:, 1:], 1, 0))
    else:
        xs = (jnp.moveaxis(rhs[:, 1:], 1, 0), Alpha, BetaInv[1:])
    _, ys = jax.lax.scan(fwd_step, y0, xs)
    y = jnp.concatenate([y0[:, None], jnp.moveaxis(ys, 0, 1)], axis=1)

    # backward: mu_{N-1} = y_{N-1} BetaInv_{N-1}^T ;
    #           mu_l = (y_l - mu_{l+1} Alpha_l^T) BetaInv_l^T
    muN = bwd_mm(y[:, N - 1],
                 BetaInv[..., N - 1, :, :] if batched_blocks else BetaInv[N - 1])

    def bwd_step(mu_next, inputs):
        y_l, Alpha_l, BetaInv_l = inputs
        mu = bwd_mm(y_l - bwd_mm(mu_next, Alpha_l), BetaInv_l)
        return mu, mu

    if batched_blocks:
        xs = (jnp.moveaxis(y[:, :N - 1], 1, 0)[::-1],
              jnp.moveaxis(Alpha, 1, 0)[::-1],
              jnp.moveaxis(BetaInv[:, :N - 1], 1, 0)[::-1])
    else:
        xs = (jnp.moveaxis(y[:, :N - 1], 1, 0)[::-1], Alpha[::-1],
              BetaInv[:N - 1][::-1])
    _, mus = jax.lax.scan(bwd_step, muN, xs)
    mu = jnp.concatenate([jnp.moveaxis(mus, 0, 1)[:, ::-1], muN[:, None]],
                         axis=1)
    return mu


def band_chol_solve_scan(rhs, Alpha, BetaInv):
    """Parallel-over-the-horizon variant of band_chol_solve via
    jax.lax.associative_scan (the SURVEY long-horizon plan: the sequential
    2N-step recursion is latency-bound for large N; both substitutions are
    affine recursions y_l = y_{l-1} M_l + c_l, so they compose
    associatively as (M, c) pairs in O(log N) depth).

    Same signature and result as band_chol_solve (fp64 agreement to
    roundoff; composition order differs so bitwise equality is not
    guaranteed). Costs O(N log N) small n x n matrix products instead of
    O(N) matvecs — profitable when N is large and the batch is small.
    """
    B, N, n = rhs.shape
    batched = Alpha.ndim == 4

    if batched:
        # [B, N-1, n, n] blocks (time-varying per-lane factors)
        Mf = -jnp.einsum("blij,bljk->blik", Alpha, BetaInv[:, 1:])
        cf = jnp.einsum("bli,blij->blj", rhs[:, 1:], BetaInv[:, 1:])
        y0 = jnp.einsum("bi,bij->bj", rhs[:, 0], BetaInv[:, 0])
        M = jnp.concatenate(
            [jnp.zeros_like(Mf[:, :1]), Mf], axis=1)      # [B, N, n, n]
        c = jnp.concatenate([y0[:, None], cf], axis=1)    # [B, N, n]
        axis = 1
    else:
        Mf = -(Alpha @ BetaInv[1:])                       # [N-1, n, n]
        cf = jnp.einsum("bli,lij->blj", rhs[:, 1:], BetaInv[1:])
        y0 = rhs[:, 0] @ BetaInv[0]
        M = jnp.concatenate([jnp.zeros_like(Mf[:1]), Mf])  # [N, n, n]
        c = jnp.concatenate([y0[:, None], cf], axis=1)     # [B, N, n]
        axis = 1
        # broadcast M over the batch so both leaves share leading dims
        M = jnp.broadcast_to(M[None], (B,) + M.shape)

    def combine(a, b):
        Ma, ca = a
        Mb, cb = b
        return (jnp.einsum("...ij,...jk->...ik", Ma, Mb),
                jnp.einsum("...i,...ij->...j", ca, Mb) + cb)

    _, y = jax.lax.associative_scan(combine, (M, c), axis=axis)

    # backward: mu_l = mu_{l+1} Mb_l + cb_l, l = N-2..0
    if batched:
        AlT = jnp.swapaxes(Alpha, -1, -2)
        BiT = jnp.swapaxes(BetaInv, -1, -2)
        Mb = -jnp.einsum("blij,bljk->blik", AlT, BiT[:, :-1])
        cb = jnp.einsum("bli,blij->blj", y[:, :-1], BiT[:, :-1])
        muN = jnp.einsum("bi,bij->bj", y[:, N - 1], BiT[:, N - 1])
        Mrev = jnp.concatenate(
            [jnp.zeros_like(Mb[:, :1]), Mb[:, ::-1]], axis=1)
        crev = jnp.concatenate([muN[:, None], cb[:, ::-1]], axis=1)
    else:
        AlT = jnp.swapaxes(Alpha, -1, -2)
        BiT = jnp.swapaxes(BetaInv, -1, -2)
        Mb = -(AlT @ BiT[:-1])                            # [N-1, n, n]
        cb = jnp.einsum("bli,lij->blj", y[:, :-1], BiT[:-1])
        muN = y[:, N - 1] @ BiT[N - 1]
        Mrev = jnp.concatenate([jnp.zeros_like(Mb[:1]), Mb[::-1]])
        Mrev = jnp.broadcast_to(Mrev[None], (B,) + Mrev.shape)
        crev = jnp.concatenate([muN[:, None], cb[:, ::-1]], axis=1)

    _, mu_rev = jax.lax.associative_scan(combine, (Mrev, crev), axis=1)
    return mu_rev[:, ::-1]
