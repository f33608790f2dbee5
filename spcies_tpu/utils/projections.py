"""Projection kernels (JAX, batched, branch-free).

The reference implements these as scalar three-case branches
(+sp_utils/proj_SOC.m, proj_SSOC.m, proj_D.m, snippets/proj_SOC3.c:4-35,
code_ellipMPC_ADMM_C.c:321-351, solve_boxQP.m:44-63). Here every branch
becomes a `jnp.where` select so the whole batch is projected without
divergence. All functions accept arbitrary leading batch dims and
operate on the trailing axis.
"""

from __future__ import annotations

import jax.numpy as jnp


def proj_box(y, lb, ub):
    """Clip onto [lb, ub] — the v-update of every box-constrained solver
    (reference platforms/Matlab/solve_boxQP.m:44-63)."""
    return jnp.clip(y, lb, ub)


def proj_ellipsoid(y, P, c, r):
    """Exact projection of the trailing axis of `y` onto the ellipsoid
    {x : (x-c)^T P (x-c) <= r^2}, *in the P-norm* (which is what makes the
    ellipMPC ADMM v-update exact — the penalty on the terminal block is
    rho*P so the prox is a P-norm projection;
    reference code_ellipMPC_ADMM_C.c:321-351).

    Scales (y - c) by r/sqrt((y-c)^T P (y-c)) about c when outside.
    """
    d = y - c
    vPv = jnp.einsum("...i,ij,...j->...", d, P, d)
    vPv = jnp.maximum(vPv, 1e-300)  # guard sqrt(0); inside-set lanes ignore it
    scale = jnp.where(vPv <= r * r, 1.0, r / jnp.sqrt(vPv))
    return c + d * scale[..., None]


def proj_soc(y):
    """Projection onto the second-order cone {(y0, y1): ||y1|| <= y0} with
    y0 = y[..., 0] (reference +sp_utils/proj_SOC.m three-case form)."""
    return proj_ssoc(y, 1.0, 0.0)


def proj_ssoc(y, alpha, d):
    """Projection onto the shifted SOC
    {(y0, y1): ||y1|| <= alpha*(y0 - d)}, alpha in {-1, +1}
    (reference +sp_utils/proj_SSOC.m, snippets/proj_SOC3.c:4-35).

    Branch-free: the three cases (inside / polar-cone -> apex / boundary
    scaling) are combined with nested selects. `alpha` and `d` may be
    scalars or arrays broadcastable against y[..., 0].
    """
    y0 = y[..., 0]
    y1 = y[..., 1:]
    ny1 = jnp.sqrt(jnp.sum(y1 * y1, axis=-1))
    corr = alpha * (y0 - d)
    inside = ny1 <= corr
    at_apex = ny1 <= -corr
    safe_ny1 = jnp.where(ny1 > 0.0, ny1, 1.0)
    step = (corr + ny1) / (2.0 * safe_ny1)
    z0_proj = step * ny1 * alpha + d
    z1_proj = y1 * step[..., None]
    z0 = jnp.where(inside, y0, jnp.where(at_apex, d + 0.0 * y0, z0_proj))
    z1 = jnp.where(inside[..., None], y1,
                   jnp.where(at_apex[..., None], jnp.zeros_like(y1), z1_proj))
    return jnp.concatenate([z0[..., None], z1], axis=-1)


def proj_diamond(y, lb, ub):
    """Projection onto the 'diamond' set K_- ∩ K_+ as the composition of two
    shifted-SOC projections (reference +sp_utils/proj_D.m:19-22):
    first onto {||y1|| <= y0 - lb}, then onto {||y1|| <= ub - y0}."""
    return proj_ssoc(proj_ssoc(y, 1.0, lb), -1.0, ub)
